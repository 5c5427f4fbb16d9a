"""Learning-curve plotting from monitor CSVs — the reference's
``tests/plot_results.py`` rebuilt over ngx.utils.monitor.

    python -m ngx.cli.plot_results -log results -agents bow pogo -out lc.png
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-log", default="results")
    p.add_argument("-agents", nargs="*", default=None,
                   help="subdirectories of -log to plot (default: all)")
    p.add_argument("-xaxis", default="timesteps",
                   choices=["timesteps", "episodes", "walltime_hrs"])
    p.add_argument("-every", type=int, default=1)
    p.add_argument("-out", default="")
    args = p.parse_args(argv)

    from ngx.utils.extras import require
    require("matplotlib", "render").use("Agg")
    import matplotlib.pyplot as plt

    from ngx.utils.monitor import load_results, ts2xy

    agents = args.agents
    if not agents:
        agents = [d for d in sorted(os.listdir(args.log))
                  if os.path.isdir(os.path.join(args.log, d))] or ["."]

    for agent in agents:
        rows = load_results(os.path.join(args.log, agent))
        if not rows:
            print("no monitor rows for", agent)
            continue
        x, y = ts2xy(rows, args.xaxis)
        plt.plot(x[::args.every], y[::args.every],
                 label=f"{agent} ({len(y)} eps)")
        print(f"agent {agent}: {len(y)} episodes")

    plt.title("Learning Curve")
    plt.ylabel("Episodes Rewards")
    plt.xlabel(args.xaxis.capitalize())
    plt.legend()
    out = args.out or os.path.join(args.log, "learning_curve.png")
    plt.savefig(out, bbox_inches="tight", dpi=100)
    print("saved", out)


if __name__ == "__main__":
    main()
