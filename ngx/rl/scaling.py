"""Scaling measurement for the sharded train step (BASELINE.md's >=80%
multi-device efficiency target).

Two measurements over 1/2/4/..N-device meshes (real devices;
virtual CPU devices under ``--xla_force_host_platform_device_count`` give a
sharding-overhead proxy on one host):

* **fixed-total**: the same global batch sharded over more devices — the
  throughput ratio vs the 1-device mesh isolates partitioning/collective
  overhead (on one physical host this is the honest proxy: total FLOPs are
  constant, only the sharding changes).
* **weak**: fixed per-device batch, total work grows with the mesh — the
  classic weak-scaling curve (meaningful on real multi-chip hardware; on
  virtual devices it mostly measures host-core saturation and is reported
  for completeness).

Run: ``python -m ngx.rl.scaling`` (CPU: forces the platform override and 8
virtual devices — must be set before jax initializes, so use the module
entry, not an import).
"""

from __future__ import annotations

import time

import numpy as np


def measure_scaling(device_counts=(1, 2, 4, 8), per_device_batch: int = 256,
                    rollout_steps: int = 16, repeats: int = 3,
                    mode: str = "fixed-total", hidden=(64, 64),
                    env_id: str = "NovelGridworld-Pogostick-v1"):
    """Time the FULL jitted train step (rollout + GAE + PPO update) over
    meshes of increasing size.  Returns {n_devices: steps_per_s} plus
    derived efficiencies."""
    import jax
    from jax.sharding import Mesh

    from .train import PPOConfig, make_train

    assert mode in ("fixed-total", "weak"), mode
    devices = jax.devices()
    assert max(device_counts) <= len(devices), \
        (device_counts, len(devices))
    total_fixed = per_device_batch * max(device_counts)

    out = {"mode": mode, "per_device_batch": per_device_batch,
           "rollout_steps": rollout_steps, "throughput": {}}
    for n in device_counts:
        B = total_fixed if mode == "fixed-total" else per_device_batch * n
        mesh = Mesh(np.asarray(devices[:n]), ("env",))
        cfg = PPOConfig(env_id=env_id, num_envs=B,
                        rollout_steps=rollout_steps, hidden=tuple(hidden))
        with mesh:
            init, train_step = make_train(cfg, mesh)
            key = jax.random.key(0)
            carry = init(key)
            step = jax.jit(train_step)
            carry, m = step(carry, jax.random.fold_in(key, 1))   # compile
            jax.block_until_ready(m["mean_reward"])
            times = []
            for r in range(repeats):
                t0 = time.perf_counter()
                carry, m = step(carry, jax.random.fold_in(key, 2 + r))
                jax.block_until_ready(m["mean_reward"])
                times.append(time.perf_counter() - t0)
        sps = B * rollout_steps / min(times)
        out["throughput"][n] = sps

    base = out["throughput"][device_counts[0]]
    if mode == "fixed-total":
        # sharding overhead: N-device mesh vs 1-device mesh, same work
        out["efficiency"] = {n: out["throughput"][n] / base
                             for n in device_counts}
    else:
        # per-device retention vs the 1-device mesh
        out["efficiency"] = {
            n: (out["throughput"][n] / n) / base for n in device_counts}
    return out


def main(argv=None):
    import argparse
    import os
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("-devices", default="1,2,4,8")
    p.add_argument("-per_device_batch", type=int, default=256)
    p.add_argument("-rollout", type=int, default=16)
    p.add_argument("-repeats", type=int, default=3)
    p.add_argument("-mode", default="both",
                   choices=("fixed-total", "weak", "both"))
    p.add_argument("-platform", default="cpu", choices=("cpu", "auto"),
                   help="cpu = 8 virtual host devices; auto = the "
                        "devices JAX finds")
    p.add_argument("-assert_efficiency", type=float, default=0.0,
                   help="exit nonzero if the largest mesh's fixed-total "
                        "efficiency falls below this")
    args = p.parse_args(argv)

    if args.platform == "cpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    counts = tuple(int(x) for x in args.devices.split(","))

    worst = 1.0
    modes = (["fixed-total", "weak"] if args.mode == "both" else [args.mode])
    for mode in modes:
        r = measure_scaling(counts, args.per_device_batch, args.rollout,
                            args.repeats, mode=mode)
        print(f"== {mode} scaling (per-device batch "
              f"{args.per_device_batch}, T={args.rollout}) ==")
        for n in counts:
            print(f"  {n} device(s): {r['throughput'][n]/1e6:.2f}M steps/s  "
                  f"efficiency {r['efficiency'][n]:.0%}")
        if mode == "fixed-total":
            worst = r["efficiency"][max(counts)]
    if args.assert_efficiency and worst < args.assert_efficiency:
        print(f"FAIL: fixed-total efficiency {worst:.0%} < "
              f"{args.assert_efficiency:.0%}")
        sys.exit(1)


if __name__ == "__main__":
    main()
