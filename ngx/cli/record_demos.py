"""Expert-demonstration recording — the reference's
``tests/record_expert_demonstrations.py`` rebuilt: roll episodes (human via
stdin, a trained checkpoint, or random) and write the SB2 ExpertDataset .npz
layout (actions, episode_returns, rewards, obs, episode_starts) that
behavior-cloning pipelines consume (reference tests/train.py:129-132).

    python -m ngx.cli.record_demos -env NovelGridworld-Bow-v0 -episodes 5 \
        -policy random -out demos/bow.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from . import PLATFORMS, set_platform


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Bow-v0")
    p.add_argument("-episodes", type=int, default=5)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-policy", default="random",
                   choices=["random", "human", "ckpt", "expert"],
                   help="'expert' uses the scripted solver for this env "
                        "(ngx/rl/experts.py) — the automated stand-in for "
                        "the reference's human demonstrations")
    p.add_argument("-ckpt", default="")
    p.add_argument("-num_beams", type=int, default=8)
    p.add_argument("-out", default="demos.npz")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-platform", default="cpu", choices=PLATFORMS,
                   help="single-env driver: every step is one host "
                        "round-trip, which the host CPU answers faster "
                        "than a device launch (default cpu)")
    args = p.parse_args(argv)

    set_platform(args.platform)
    import ngx.compat as C
    env = C.LidarInFront(C.make(args.env), num_beams=args.num_beams)

    policy = None
    expert = None
    if args.policy == "ckpt":
        from .enjoy import load_policy
        policy = load_policy(args.ckpt, env.spec)
        import jax
        key = jax.random.key(args.seed)
    elif args.policy == "expert":
        from ngx.rl.experts import get_expert
        expert = get_expert(args.env)

    actions, rewards, obs_l, starts, ep_returns = [], [], [], [], []
    for ep in range(args.episodes):
        np.random.seed(args.seed + ep)
        obs = env.reset()
        total, first = 0.0, True
        for t in range(args.episode_cap):
            if args.policy == "human":
                name = input(f"[{ep}:{t}] action name> ").strip()
                if name not in env.actions_id:
                    print("unknown:", name)
                    continue
                a = env.actions_id[name]
            elif policy is not None:
                import jax
                key, k = jax.random.split(key)
                a = int(policy(k, obs))
            elif expert is not None:
                a = expert(env)
            else:
                a = env.action_space.sample()
            obs_l.append(np.asarray(obs))
            actions.append(a)
            starts.append(first)
            first = False
            obs, r, done, info = env.step(a)
            rewards.append(r)
            total += r
            if done:
                break
        ep_returns.append(total)
        print(f"episode {ep}: return {total:.1f}")

    import os
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(
        args.out,
        actions=np.asarray(actions, np.int64)[:, None],
        episode_returns=np.asarray(ep_returns, np.float64),
        rewards=np.asarray(rewards, np.float64),
        obs=np.stack(obs_l).astype(np.float64),
        episode_starts=np.asarray(starts, bool),
    )
    print("saved", args.out)


if __name__ == "__main__":
    main()
