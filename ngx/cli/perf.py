"""Performance breakdown driver.

    python -m ngx.cli.perf -batch 65536 -steps 256            # ablations
    python -m ngx.cli.perf --trainer -batch 8192              # PPO train step
    python -m ngx.cli.perf --trainer --profile -profile_dir DIR

Ablation mode times the bench kernel (ngx.vector.throughput_fn) against
variants that each remove one suspected cost: threefry action sampling ->
counter-hash / fixed action, the done->reset lax.cond -> no auto-reset, and
the bit-packed carry.  The deltas attribute the step budget to (env kernel |
action RNG | reset | carry bytes).

Trainer mode times the acting loop alone (policy -> sample -> step -> reset,
64 steps) and the full PPO train step (acting + GAE + update
epochs) at ``-batch`` envs.  ``--profile`` writes one ``jax.profiler`` trace
of the measured function.
"""

from __future__ import annotations

import argparse
import json
import time

from . import PLATFORMS, set_platform


def _time(fn, *args, repeats=3):
    """Best-of-N wall time of ``fn(*args)`` after one warm-up call (which
    compiles), each call ending in ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Pogostick-v1")
    p.add_argument("-batch", type=int, default=65536)
    p.add_argument("-steps", type=int, default=256,
                   help="scan length of the ablation kernels")
    p.add_argument("-repeats", type=int, default=3)
    p.add_argument("--trainer", action="store_true",
                   help="time the acting loop and the full PPO train step")
    p.add_argument("--profile", action="store_true")
    p.add_argument("-profile_dir", default="results/profile")
    p.add_argument("-novelty", default="",
                   help="trainer mode: inject this novelty into the spec "
                        "(e.g. 'firewall:easy' or 'fence:medium:oak')")
    p.add_argument("-platform", default="auto", choices=PLATFORMS)
    args = p.parse_args(argv)

    set_platform(args.platform)
    import jax
    import ngx
    from ngx.vector import throughput_fn

    B, S = args.batch, args.steps
    spec = ngx.make_spec(args.env)
    key = jax.random.key(0)
    results = {}

    if args.trainer:
        from ngx.rl.train import PPOConfig, make_train

        T = 64
        spec_override = None
        if args.novelty:
            spec_override = ngx.inject_novelty(spec, *args.novelty.split(":"))
            print(f"trainer spec: {args.env} + {args.novelty}")
        cfg = PPOConfig(env_id=args.env, num_envs=B, rollout_steps=T)
        init, train_step = make_train(cfg, spec_override=spec_override)
        carry = init(key)
        ts, env_state, obs, _ = carry
        acting = jax.jit(train_step.rollout)
        step = jax.jit(train_step)
        t = _time(acting, ts.params, env_state, obs, key,
                  repeats=args.repeats)
        results["acting_loop"] = B * T / t
        print(f"acting loop : {B*T/t/1e6:8.3f}M env-steps/s "
              f"({t*1e3:.2f} ms per {T}-step rollout)")
        t = _time(step, carry, key, repeats=args.repeats)
        results["train_step"] = B * T / t
        print(f"train step  : {B*T/t/1e6:8.3f}M env-steps/s "
              f"({t*1e3:.2f} ms/update)")
        profiled = (step, carry, jax.random.key(1))
    else:
        variants = [
            ("full (threefry actions, auto-reset)", {}),
            ("hash-rng actions", {"action_rng": "hash"}),
            ("fixed action (no RNG)", {"action_rng": "fixed"}),
            ("no auto-reset", {"auto_reset": False}),
            ("bit-packed carry", {"packed": True}),
        ]
        for name, kw in variants:
            run = throughput_fn(spec, B, S, **kw)
            t = _time(run, key, repeats=args.repeats)
            results[name] = B * S / t
            print(f"{name:38s}: {B*S/t/1e6:8.1f}M steps/s "
                  f"({t*1e9/(B*S):6.2f} ns/step)")
        profiled = (throughput_fn(spec, B, S), jax.random.fold_in(key, 9))

    if args.profile:
        fn, *fargs = profiled
        jax.block_until_ready(fn(*fargs))
        with jax.profiler.trace(args.profile_dir):
            jax.block_until_ready(fn(*fargs))
        print("trace written to", args.profile_dir)

    dev = jax.devices()[0]
    print(json.dumps({"batch": B,
                      "steps": 64 if args.trainer else S,
                      "platform": dev.platform,
                      "device_kind": dev.device_kind,
                      "steps_per_s": results}))


if __name__ == "__main__":
    main()
