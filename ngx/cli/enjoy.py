"""Evaluation driver — the reference's ``enjoy.py`` rebuilt.

    python -m ngx.cli.enjoy -env NovelGridworld-Bow-v0 -episodes 10 \
        -ckpt agents/bow/best -render

Supports the reference's special v5 curriculum path (enjoy.py:58-100): for
``-env NovelGridworld-v5`` it chains v1→v2→v3→v4→v5 via state restore, using
a policy per stage if a -ckpt dir with per-env checkpoints is given, else
random actions.

``-ckpt`` accepts either a native orbax checkpoint dir or one of the
reference's shipped stable-baselines-2 ``.zip`` files (e.g.
``/root/reference/trained_agents/NovelGridworld-v0.zip``) — the SB2 save
format is a zip holding plain-npz MLP weights, loaded TF-free by
``ngx.rl.sb2`` and run as a JAX forward pass over the env's native lidar
observation (the obs SB2 trained on, reference tests/train.py:104-122).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import PLATFORMS, set_platform


def load_policy(ckpt, spec):
    import jax
    import jax.numpy as jnp
    from ngx.rl.models import ActorCritic
    from ngx.utils.checkpoint import restore_pytree

    if ckpt.endswith(".zip"):
        # a reference SB2 checkpoint (reference enjoy.py:49-72)
        from ngx.rl.sb2 import check_dims, load_sb2_params, sb2_apply

        params = load_sb2_params(ckpt)
        # fail with a clear shape error (not an opaque matmul error) when
        # the zip belongs to a different env — mirrors evaluate_sb2_zip
        _, obs0 = jax.jit(__import__("ngx").make_reset(spec))(
            jax.random.key(0))
        if hasattr(obs0, "shape"):
            check_dims(params, int(obs0.shape[-1]), spec.n_actions, ckpt)

        @jax.jit
        def act_sb2(key, obs):
            logits, _ = sb2_apply(
                params, jnp.asarray(obs, jnp.float32)[None, :])
            return jax.random.categorical(key, logits[0])

        return act_sb2

    tree = restore_pytree(ckpt)
    params = tree["params"]
    n_hidden = tuple(tree.get("config", {}).get("hidden", (64, 64)))
    model = ActorCritic(n_actions=spec.n_actions, hidden=n_hidden)

    @jax.jit
    def act(key, obs):
        logits, _ = model.apply(params, jnp.asarray(obs, jnp.float32))
        return jax.random.categorical(key, logits)

    return act


def run_episodes(env, policy, episodes, cap, render, seed=0):
    import jax
    key = jax.random.key(seed)
    returns = []
    for ep in range(episodes):
        np.random.seed(seed + ep)
        obs = env.reset()
        total = 0.0
        for t in range(cap):
            if policy is None:
                a = env.action_space.sample()
            else:
                key, k = jax.random.split(key)
                a = int(policy(k, obs))
            obs, r, done, info = env.step(a)
            total += r
            if render:
                env.render()
            if done:
                break
        returns.append(total)
        print(f"episode {ep}: return={total:.1f} steps={t+1} "
              f"done={bool(done)}")
    print(f"mean return over {episodes} episodes: {np.mean(returns):.2f}")
    return returns


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-env", default="NovelGridworld-Bow-v0")
    p.add_argument("-episodes", type=int, default=10)
    p.add_argument("-episode_cap", type=int, default=100)
    p.add_argument("-ckpt", default="")
    p.add_argument("-render", action="store_true")
    p.add_argument("-num_beams", type=int, default=8)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-platform", default="cpu", choices=PLATFORMS,
                   help="single-env driver: every step is one host "
                        "round-trip, which the host CPU answers faster "
                        "than a device launch (default cpu)")
    args = p.parse_args(argv)

    set_platform(args.platform)
    import ngx.compat as C

    if args.env == "NovelGridworld-v5":
        # The reference's v5 curriculum (enjoy.py:58-100): the chain is
        # v1 -> v2 -> v3 (craft tree_tap) -> v4 -> v3 AGAIN (craft
        # pogo_stick), each stage restoring the previous env's terminal
        # state — v5 itself is never stepped.  Per-stage policies come from
        # ``-ckpt <dir>``: ``<env>.zip`` (the reference's shipped SB2
        # agents, e.g. /root/reference/trained_agents) or a native
        # ``<env>/{best,final}`` checkpoint; random actions otherwise.
        chain = ["NovelGridworld-v1", "NovelGridworld-v2",
                 "NovelGridworld-v3", "NovelGridworld-v4",
                 "NovelGridworld-v3"]
        prev = None
        for stage, env_id in enumerate(chain):
            env = C.make(env_id, env=prev)
            policy = None
            if args.ckpt:
                zipp = os.path.join(args.ckpt, env_id + ".zip")
                native = next(
                    (p for k in ("best", "final")
                     if os.path.exists(p := os.path.join(args.ckpt, env_id, k))),
                    None)
                if os.path.exists(zipp):
                    # SB2 agents act on the env's built-in lidar obs
                    policy = load_policy(zipp, env.spec)
                elif native:
                    # native agents act on the LidarInFront observation
                    env = C.LidarInFront(env, num_beams=args.num_beams)
                    policy = load_policy(native, env.spec)
            print(f"--- stage {stage}: {env_id} ---")
            run_episodes(env, policy, 1, args.episode_cap, args.render,
                         args.seed)
            prev = env
        return

    env = C.make(args.env)
    policy = None
    if args.ckpt:
        if not args.ckpt.endswith(".zip"):
            # native policies act on the LidarInFront observation; the
            # reference's SB2 zips act on the env's built-in obs (the legacy
            # envs' own lidar arrays — no wrapper, reference enjoy.py:49-56)
            env = C.LidarInFront(env, num_beams=args.num_beams)
        policy = load_policy(args.ckpt, env.spec)
    run_episodes(env, policy, args.episodes, args.episode_cap, args.render,
                 args.seed)


if __name__ == "__main__":
    main()
