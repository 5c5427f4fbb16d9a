"""Training driver — the reference's ``tests/train.py`` rebuilt: PPO on the
batched engine with Monitor-style CSV logs, best-model checkpointing
(SaveOnBestTrainingRewardCallback analog, reference tests/train.py:43-70) and
optional mid-training novelty injection (RemapActionOnStep analog, :73-89).

    python -m ngx.cli.train -env NovelGridworld-Bow-v0 -steps 400000 \
        -log results/bow -ckpt agents/bow
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time


def main(argv=None):
    """Run the trainer; returns the per-update metrics (list of dicts)."""
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Bow-v0")
    p.add_argument("-steps", type=int, default=400_000,
                   help="total env steps (reference budget: 400k)")
    p.add_argument("-num_envs", type=int, default=512)
    p.add_argument("-rollout", type=int, default=64)
    p.add_argument("-lr", type=float, default=2.5e-4)
    p.add_argument("-ent_coef", type=float, default=0.01)
    p.add_argument("-epochs", type=int, default=4)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-log", default="results/run")
    p.add_argument("-ckpt", default="")
    p.add_argument("-resume", default="",
                   help="resume from a '<ckpt>/resume' checkpoint "
                        "(params + optimizer state)")
    p.add_argument("-pretrain", default="",
                   help="expert-demo .npz (from ngx.cli.record_demos) for a "
                        "behavior-cloning warm start (reference "
                        "tests/train.py:125-132)")
    p.add_argument("-pretrain_steps", type=int, default=500)
    p.add_argument("-inject_novelty_at", type=int, default=0,
                   help="inject -novelty after this many env steps (0=off)")
    p.add_argument("-novelty", default="remapaction")
    p.add_argument("-novelty_difficulty", default="easy")
    p.add_argument("-novelty_arg1", default="")
    p.add_argument("-novelty_arg2", default="")
    p.add_argument("-bc_anchor", default="",
                   help="demo .npz whose (obs, action) pairs anchor every "
                        "PPO minibatch with a cross-entropy term (keeps the "
                        "expert's navigation; use with -reward_mode solve)")
    p.add_argument("-bc_coef", type=float, default=0.05)
    p.add_argument("-reward_mode", default="env", choices=("env", "solve"),
                   help="'solve' trains on the solve-shaped reward (-1/step, "
                        "+reward_done only on goal termination) — kills the "
                        "farming optimum so PPO optimizes solving; combine "
                        "with -best_metric solve")
    p.add_argument("-best_metric", default="return",
                   choices=("return", "solve"),
                   help="what 'best' checkpoints track: mean episode return "
                        "(default) or solve fraction (episodes ending with "
                        "a positive terminal reward — train a SOLVER on "
                        "envs where reward farming out-earns the goal)")
    p.add_argument("-chain", default="",
                   help="comma-separated env-id chain (reference "
                        "tests/train_last_agent.py:41): trains the LAST env "
                        "with every reset restoring a batched chain-terminal "
                        "state from the earlier stages (frozen policies from "
                        "-chain_ckpts, random actions otherwise)")
    p.add_argument("-chain_ckpts", default="",
                   help="dir holding per-stage native checkpoints "
                        "(<env_id>/best) for the frozen chain stages")
    p.add_argument("-updates_per_launch", type=int, default=8,
                   help="PPO updates folded into ONE jit launch via "
                        "lax.scan, with one host metric fetch per launch; "
                        "metrics are still logged per update (stacked).  "
                        "1 = one launch per update")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    import dataclasses

    import jax
    import numpy as np
    from . import enable_compile_cache
    enable_compile_cache()
    from ngx.rl.train import PPOConfig, make_train
    from ngx.utils.checkpoint import save_pytree

    def dataclasses_replace_env(cfg, env_id):
        return dataclasses.replace(cfg, env_id=env_id)

    cfg = PPOConfig(env_id=args.env, num_envs=args.num_envs,
                    rollout_steps=args.rollout, lr=args.lr,
                    ent_coef=args.ent_coef, epochs=args.epochs,
                    episode_cap=args.episode_cap,
                    solve_shaped=args.reward_mode == "solve",
                    bc_coef=args.bc_coef if args.bc_anchor else 0.0)
    bc_data = None
    if args.bc_anchor:
        from ngx.rl.bc import load_demos
        bc_data = load_demos(args.bc_anchor)
        print(f"bc anchor: {bc_data[0].shape[0]} frames from "
              f"{args.bc_anchor} (coef {args.bc_coef})")
    steps_per_update = cfg.num_envs * cfg.rollout_steps
    num_updates = max(1, args.steps // steps_per_update)
    inject_update = (args.inject_novelty_at // steps_per_update
                     if args.inject_novelty_at else None)
    inject_spec = None
    if args.inject_novelty_at:
        # validate EVERYTHING about the injection before spending a single
        # training step (review finding: a value under one update's worth
        # of steps floored to 0 and silently disabled the experiment; an
        # incompatible novelty aborted only after the whole phase-1 run)
        if args.chain:
            # the injection path rebuilds a plain make_train carry, which
            # the chain trainer's pool-carrying carry cannot continue from
            # (and the reference's novelty-response experiment is a
            # plain-env scenario, tests/train.py:73-89)
            p.error("-chain and -inject_novelty_at are mutually exclusive")
        if not 1 <= inject_update < num_updates:
            p.error(
                f"-inject_novelty_at {args.inject_novelty_at} maps to "
                f"update {inject_update} of {num_updates} (one update = "
                f"num_envs*rollout = {steps_per_update} steps); it must "
                f"land strictly inside the run")
        import ngx
        from ngx.core.state import zeros_state
        from ngx.transforms import lidar_in_front
        spec1 = lidar_in_front(ngx.make_spec(args.env))
        inject_spec = ngx.inject_novelty(
            ngx.make_spec(args.env), args.novelty,
            args.novelty_difficulty, args.novelty_arg1, args.novelty_arg2)
        spec2_l = lidar_in_front(inject_spec)
        # continuing the SAME policy across the injection requires
        # unchanged obs/action dims — the reference's novelty-response
        # experiment is remapaction for exactly this reason
        # (tests/train.py:73-89).  Item-adding novelties (axe, firewall,
        # fence, ...) grow the lidar obs and/or action space; train them
        # from scratch on a pre-injected spec instead.
        # eval_shape: dims only, no device dispatch
        d1 = int(jax.eval_shape(ngx.make_step(spec1).get_obs,
                                zeros_state(spec1)).shape[-1])
        d2 = int(jax.eval_shape(ngx.make_step(spec2_l).get_obs,
                                zeros_state(spec2_l)).shape[-1])
        if spec2_l.n_actions != spec1.n_actions or d1 != d2:
            p.error(
                f"-inject_novelty_at cannot continue the trained policy "
                f"across '{args.novelty}': it changes the obs/action dims "
                f"(obs {d1} -> {d2}, actions {spec1.n_actions} -> "
                f"{spec2_l.n_actions}).  The reference's mid-training "
                f"scenario is dimension-preserving (remapaction, "
                f"tests/train.py:73-89); to train under this novelty, "
                f"start a fresh run on the injected spec.")

    os.makedirs(args.log, exist_ok=True)
    t0 = time.time()
    csv_path = os.path.join(args.log, "progress.monitor.csv")
    f = open(csv_path, "w", newline="")
    f.write("#%s\n" % json.dumps({"t_start": t0, "env_id": args.env}))
    w = csv.DictWriter(f, fieldnames=("r", "l", "t"))
    w.writeheader()

    key = jax.random.key(args.seed)
    if args.chain:
        from ngx.rl.curriculum import make_train_chain
        from ngx.utils.checkpoint import restore_pytree
        env_ids = [e.strip() for e in args.chain.split(",")]
        assert env_ids[-1] == args.env or args.env == p.get_default("env"), \
            "-env (if given) must equal the last -chain stage"
        cfg = dataclasses_replace_env(cfg, env_ids[-1])
        stage_params = []
        for e in env_ids[:-1]:
            path = os.path.join(args.chain_ckpts, e, "best") \
                if args.chain_ckpts else ""
            if path and os.path.exists(path):
                stage_params.append(restore_pytree(path)["params"])
                print(f"chain stage {e}: frozen policy from {path}")
            else:
                stage_params.append(None)
                print(f"chain stage {e}: random actions (no checkpoint)")
        init, train_step = make_train_chain(cfg, env_ids, stage_params,
                                            bc_data=bc_data)
        # chain mode: the restore pool refreshes once per LAUNCH (the
        # reference re-chains once per learn(500), train_last_agent.py)
        refresh_pool = jax.jit(train_step.refresh_pool)
    else:
        init, train_step = make_train(cfg, bc_data=bc_data)
    carry = init(key)
    if args.resume:
        # full-fidelity resume: params AND optimizer state (the reference's
        # SB2 model.load analog, but for mid-run failure recovery)
        from ngx.utils.checkpoint import restore_pytree
        ts = carry[0]
        tree = restore_pytree(args.resume, like={"params": ts.params,
                                                 "opt_state": ts.opt_state})
        carry = (ts.replace(params=tree["params"],
                            opt_state=tree["opt_state"]),) + carry[1:]
        print(f"resumed TrainState from {args.resume}")
    if args.pretrain:
        from ngx.rl.bc import pretrain_from_npz
        from ngx.rl.models import ActorCritic
        import ngx
        from ngx.transforms import lidar_in_front
        spec = lidar_in_front(ngx.make_spec(args.env))
        model = ActorCritic(n_actions=spec.n_actions, hidden=cfg.hidden)
        ts = carry[0]
        params, m = pretrain_from_npz(model, ts.params, args.pretrain,
                                      steps=args.pretrain_steps)
        print(f"BC pretrain: loss={m['loss']:.3f} acc={m['accuracy']:.2%}")
        carry = (ts.replace(params=params),) + carry[1:]
    best = None
    history = []       # per-update metric dicts, returned by main()

    from collections import deque
    window = deque(maxlen=10)   # trailing multi-update aggregation

    K = max(1, args.updates_per_launch)

    def run_updates(n, carry, step_fn, offset=0):
        nonlocal best
        import jax.numpy as jnp
        # K updates per launch: one lax.scan launch amortizes the launch
        # and the host metric fetch over K updates.  The 'best' checkpoint
        # saves the END-OF-LAUNCH params (up to K-1 updates past the
        # best-scoring window — policies drift little over one launch; set
        # -updates_per_launch 1 for exact behavior).
        multi = jax.jit(lambda c, ks: jax.lax.scan(step_fn, c, ks))
        u = 0
        while u < n:
            k = min(K, n - u)
            if args.chain:
                carry = refresh_pool(
                    carry, jax.random.fold_in(key, 500_000 + offset + u))
            keys = jnp.stack([jax.random.fold_in(key, offset + u + i + 1)
                              for i in range(k)])
            carry, stacked = multi(carry, keys)
            stacked = {kk: np.asarray(v) for kk, v in stacked.items()}
            for i in range(k):
                _log_update(offset + u + i, carry,
                            {kk: float(v[i]) for kk, v in stacked.items()})
            u += k
        return carry

    def _log_update(uidx, carry, m):
        nonlocal best
        history.append(m)
        if True:
            count = max(m["ep_count"], 1.0)
            mean_ep = m["ep_return_sum"] / count
            solve = m.get("ep_solved", 0.0) / count
            # A single short rollout window under-samples long (failing)
            # episodes — its solve fraction can read ~100% for a ~75%
            # policy (the trainers' ep_body note).  Aggregate counts over a
            # trailing window of updates for an unbiased estimate; 'best'
            # checkpointing ranks on the aggregate.
            window.append((m.get("ep_solved", 0.0), m["ep_count"],
                           m["ep_return_sum"]))
            w_solved = sum(x[0] for x in window)
            w_count = max(sum(x[1] for x in window), 1.0)
            w_return = sum(x[2] for x in window) / w_count
            solve_agg = w_solved / w_count
            w.writerow({"r": round(mean_ep, 4),
                        "l": int(round(steps_per_update / count)),
                        "t": round(time.time() - t0, 4)})
            f.flush()
            done_steps = (uidx + 1) * steps_per_update
            print(f"steps {done_steps}: mean_ep_return={mean_ep:.2f} "
                  f"solve={solve:.0%} (10-update agg {solve_agg:.0%}) "
                  f"episodes={int(m['ep_count'])} "
                  f"entropy={m['entropy']:.3f}")
            # 'solve' ranks by the aggregated solve fraction, return
            # tie-break (also aggregated)
            score = ((solve_agg, w_return) if args.best_metric == "solve"
                     else (mean_ep,))
            if args.ckpt and m["ep_count"] > 0 and \
                    (best is None or score > best):
                best = score
                save_pytree(os.path.join(args.ckpt, "best"),
                            {"params": carry[0].params,
                             "config": vars(args) | {
                                 "hidden": list(cfg.hidden),
                                 "mean_ep_return": mean_ep,
                                 "solve_frac": solve_agg}})
                print(f"  saved new best ({args.best_metric}="
                      f"{score[0]:.2f})")

    if inject_update:
        carry = run_updates(min(inject_update, num_updates), carry, train_step)
        if inject_update < num_updates:
            # novelty response experiment: rebuild the env mid-training
            # (RemapActionOnStep, reference tests/train.py:73-89)
            print(f"injecting novelty {args.novelty} at update {inject_update}")
            init2, train_step2 = make_train(cfg, spec_override=inject_spec)
            carry2 = init2(jax.random.fold_in(key, 999))
            ts = carry[0]
            carry = (ts, carry2[1], carry2[2], carry2[3])
            # the trailing solve/return aggregation window must not mix
            # pre- and post-injection episode counts (the dynamics just
            # changed); 'best' also restarts so the first post-injection
            # checkpoint reflects the novelty regime only
            window.clear()
            best = None
            carry = run_updates(num_updates - inject_update, carry,
                                train_step2, offset=inject_update)
    else:
        carry = run_updates(num_updates, carry, train_step)

    if args.ckpt:
        save_pytree(os.path.join(args.ckpt, "final"),
                    {"params": carry[0].params,
                     "config": vars(args) | {"hidden": list(cfg.hidden)}})
        # resumable checkpoint: params + optimizer state (-resume target)
        save_pytree(os.path.join(args.ckpt, "resume"),
                    {"params": carry[0].params,
                     "opt_state": carry[0].opt_state})
        print("final checkpoint saved to", os.path.join(args.ckpt, "final"))
    f.close()
    return history


if __name__ == "__main__":
    main()
