"""DAgger solver training: close the BC->expert solve gap.

BC alone tops out below the scripted expert's solve ceiling (docs/EVAL.md
solver table: Bow-v1 92% vs 100%, Pogostick-v0 72% vs 98%) because the
cloned policy drifts off the expert's state distribution and has no labels
there.  DAgger fixes exactly that: roll out the CURRENT policy, label every
visited state with the expert's action (ngx/rl/experts.py — pure functions
of the live state, so they label arbitrary states), aggregate, re-fit.

    python -m ngx.cli.dagger -env NovelGridworld-Pogostick-v0 \
        -rounds 8 -episodes_per_round 64 -ckpt trained_agents/..._solver

The rollout/labeling runs the compat facade on host CPU (the experts are
BFS state machines over the live map); the BC refit and the 128-episode
evaluation are batched jitted passes.  The best-by-solve-rate round is saved
in the native checkpoint layout ``{params, config{hidden}}`` that
``ngx.cli.eval_agents`` / ``enjoy`` read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import PLATFORMS, set_platform


def collect_policy_labeled(env_id: str, params, hidden, episodes: int,
                           cap: int, seed: int, mix_expert: float = 0.0):
    """Roll the current policy (stochastic, the eval protocol), label every
    visited state with the expert action.  Returns (obs[N,D], labels[N]).

    ``params=None`` rolls the expert itself (round 0 = plain BC data).
    ``mix_expert``: probability per step of EXECUTING the expert action
    instead of the policy's (beta-mixing, the original DAgger schedule)."""
    import jax
    import jax.numpy as jnp

    import ngx.compat as C
    from ngx.rl.experts import get_expert
    from ngx.rl.models import ActorCritic

    env = C.LidarInFront(C.make(env_id), 8)
    expert = get_expert(env_id)
    act = None
    if params is not None:
        model = ActorCritic(n_actions=env.spec.n_actions,
                            hidden=tuple(hidden))

        @jax.jit
        def _act(key, obs):
            logits, _ = model.apply(params, jnp.asarray(obs, jnp.float32))
            return jax.random.categorical(key, logits)

        act = _act

    key = jax.random.key(seed)
    rng = np.random.RandomState(seed)
    obs_buf, lab_buf = [], []
    for ep in range(episodes):
        np.random.seed(seed * 100_000 + ep)
        obs = env.reset()
        for t in range(cap):
            a_exp = expert(env)
            obs_buf.append(np.asarray(obs, np.float32))
            lab_buf.append(a_exp)
            if act is None or rng.rand() < mix_expert:
                a = a_exp
            else:
                key, k = jax.random.split(key)
                a = int(act(k, obs))
            obs, r, done, _ = env.step(a)
            if done:
                break
    return np.stack(obs_buf), np.asarray(lab_buf, np.int64)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Pogostick-v0")
    p.add_argument("-rounds", type=int, default=8)
    p.add_argument("-episodes_per_round", type=int, default=64)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-bc_steps", type=int, default=4000)
    p.add_argument("-bc_batch", type=int, default=512)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-hidden", default="64,64")
    p.add_argument("-eval_episodes", type=int, default=128)
    p.add_argument("-demos", default="",
                   help="optional seed dataset .npz (ngx.cli.record_demos "
                        "layout); round 0 otherwise rolls the expert")
    p.add_argument("-ckpt", default="")
    p.add_argument("-sharpen", default="1,2,4,8",
                   help="logit temperature sweep: each round also evaluates "
                        "the policy with pi_out scaled by these factors "
                        "(monotone, argmax-preserving — converts BC accuracy "
                        "into solve rate under the stochastic eval protocol) "
                        "and keeps the best-scoring variant")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-platform", default="auto", choices=PLATFORMS)
    args = p.parse_args(argv)

    set_platform(args.platform)

    import jax
    import jax.numpy as jnp

    import ngx
    from ngx.rl.bc import load_demos, pretrain
    from ngx.rl.evaluate import make_eval
    from ngx.rl.models import ActorCritic
    from ngx.utils.checkpoint import save_pytree

    hidden = tuple(int(x) for x in args.hidden.split(","))
    spec = ngx.make_spec(args.env)
    run_eval = make_eval(spec, hidden=hidden, cap=args.episode_cap)

    if args.demos:
        obs, labels = load_demos(args.demos)
        print(f"seed dataset: {obs.shape[0]} frames from {args.demos}")
    else:
        obs, labels = collect_policy_labeled(
            args.env, None, hidden, args.episodes_per_round,
            args.episode_cap, args.seed)
        print(f"round 0 (expert rollout): {obs.shape[0]} frames")

    model = ActorCritic(n_actions=spec.n_actions, hidden=hidden)
    params = model.init(jax.random.key(args.seed),
                        jnp.zeros((1, obs.shape[1]), jnp.float32))
    def sharpened(params, tau):
        if tau == 1:
            return params
        return jax.tree_util.tree_map_with_path(
            lambda path, v: v * tau if any(
                getattr(k, "key", None) == "pi_out" for k in path) else v,
            params)

    taus = [float(t) for t in args.sharpen.split(",")]
    best = None
    for rnd in range(args.rounds):
        params, m = pretrain(model, params, obs, labels,
                             key=jax.random.key(args.seed + rnd),
                             steps=args.bc_steps, batch_size=args.bc_batch,
                             lr=args.lr)
        round_best = None
        for tau in taus:
            p_t = sharpened(params, tau)
            ev = run_eval(p_t, jax.random.key(args.seed * 7 + rnd),
                          args.eval_episodes)
            sc = (ev["solve_rate"], ev["mean_return"])
            if round_best is None or sc > round_best[0]:
                round_best = (sc, tau, p_t, ev)
        sc, tau, p_t, ev = round_best
        print(f"round {rnd}: dataset={obs.shape[0]} "
              f"bc_acc={m['accuracy']:.2%} solve={ev['solve_rate']:.2%} "
              f"return={ev['mean_return']:.1f} (tau={tau:g})")
        if args.ckpt and (best is None or sc > best):
            best = sc
            save_pytree(os.path.join(args.ckpt, "best"),
                        {"params": p_t,
                         "config": {"hidden": list(hidden),
                                    "solve_frac": ev["solve_rate"],
                                    "mean_ep_return": ev["mean_return"],
                                    "dagger_round": rnd,
                                    "sharpen_tau": tau}})
            print(f"  saved new best (solve={ev['solve_rate']:.2%})")
        if rnd == args.rounds - 1:
            break
        new_obs, new_lab = collect_policy_labeled(
            args.env, params, hidden, args.episodes_per_round,
            args.episode_cap, args.seed + 1000 * (rnd + 1))
        obs = np.concatenate([obs, new_obs])
        labels = np.concatenate([labels, new_lab])
    print(f"best solve rate: {best[0]:.2%}" if best else "no checkpoint")


if __name__ == "__main__":
    main()
