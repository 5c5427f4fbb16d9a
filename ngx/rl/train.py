"""PPO training: one jitted (rollout → GAE → update) step, env-sharded.

Algorithmic surface mirrors what the reference trains with (SB2 PPO2 defaults,
reference ``tests/train.py:122,135``: clipped surrogate, GAE, minibatch
epochs); the execution model is one device program: the T×B rollout is a
``lax.scan`` over the batched env (no host in the loop) and the update runs
on the same device.  Over a ``Mesh`` every device runs that program on its
own env shard (``shard_map``); the gradient all-reduce is the only
non-scalar cross-device traffic.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import spec as S
from ..transforms import lidar_in_front
from ..vector import make_vec
from .models import ActorCritic
from .train_state import TrainState


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env_id: str = "NovelGridworld-Pogostick-v1"
    num_envs: int = 1024
    rollout_steps: int = 64
    epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 2.5e-4
    max_grad_norm: float = 0.5
    hidden: tuple = (64, 64)
    episode_cap: int = 100      # reference eval cap (enjoy.py:87,107)
    # solve-shaped reward: replace the env reward with -1/step and
    # +reward_done only on a goal termination — kills the reward-farming
    # optimum (docs/EVAL.md: repeatable craft/extract loops out-earn the
    # goal under the cap) so PPO optimizes SOLVING; eval still reports the
    # true env return.  Applied to the rollout rewards post-hoc.
    solve_shaped: bool = False
    # BC anchor: add bc_coef * cross-entropy(policy, expert action) over a
    # demo dataset to every PPO minibatch loss — keeps the expert's
    # navigation behavior (the measured failure mode is right-action-wrong-
    # place loops) while the solve-shaped reward optimizes completion.
    # The dataset rides via make_train(..., bc_data=(obs, actions)).
    bc_coef: float = 0.0
    # minibatch shuffle: 'permutation' = exact uniform permutation per epoch
    # (SB2 semantics; a T*B-element sort per epoch); 'affine' = a random
    # affine bijection i -> (A*i + r) mod N (A odd ~ N is a power of two for
    # the default shapes) — not a uniform permutation, but decorrelates
    # minibatches just as well for PPO and skips the sort).
    shuffle: str = "permutation"


def _flat_obs(spec):
    """Policy observations: the LidarInFront vector (what the reference
    trains SB2 on) as float32."""
    assert spec.obs_mode == S.OBS_LIDAR_FRONT, \
        "apply ngx.transforms.lidar_in_front to the spec first"


def make_ppo_core(cfg: PPOConfig, model, bc_data=None, axis_name=None):
    """The pure PPO math, independent of how the rollout is produced:
    ``gae(values, rewards, dones, last_value) -> (adv, target)`` and
    ``update(train_state, (obs, action, logp, adv, target), key)`` (clipped
    surrogate + value + entropy over ``epochs`` x ``num_minibatches``, the
    SB2 PPO2 surface the reference trains with, tests/train.py:122).  Shared
    by :func:`make_train` and the curriculum trainer
    (:mod:`ngx.rl.curriculum`).

    ``axis_name``: when set, ``update`` runs SHARD-LOCAL under ``shard_map``
    over that mesh axis — each device permutes and minibatches its own
    trajectory shard, advantage-normalization moments and gradients are
    ``pmean``-ed across the axis, and the optimizer applies the identical
    averaged gradient everywhere.  This keeps the update data-parallel: the
    naive global ``reshape(T*B)`` + random-row gather forces XLA to
    all-gather the WHOLE trajectory to every device and run the update
    replicated (caught by tests/test_distributed.py's compiled-HLO audit),
    turning the update phase into zero-parallelism work."""

    def gae(values, rewards, dones, last_value):
        def body(carry, xs):
            adv_next, v_next = carry
            v, r, d = xs
            nonterm = 1.0 - d.astype(jnp.float32)
            delta = r + cfg.gamma * v_next * nonterm - v
            adv = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
            return (adv, v), adv

        (_, _), advs = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            (values, rewards, dones), reverse=True)
        return advs, advs + values

    if bc_data is not None and cfg.bc_coef > 0:
        bc_obs = jax.device_put(jnp.asarray(bc_data[0], jnp.float32))
        bc_act = jax.device_put(jnp.asarray(bc_data[1], jnp.int32))
    else:
        bc_obs = bc_act = None

    def loss_fn(params, obs, action, old_logp, adv, target):
        logits, value = model.apply(params, obs.astype(jnp.float32))
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(logp_all, action[:, None], axis=1)[:, 0]
        ratio = jnp.exp(logp - old_logp)
        if axis_name is None:
            adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
        else:
            # global-minibatch moments from equal-sized local shards: the
            # pmean of local means IS the global mean, and the global std
            # comes from pmean'd second moments — same normalization the
            # single-device path applies to the full minibatch
            gm = jax.lax.pmean(adv.mean(), axis_name)
            gsq = jax.lax.pmean(jnp.square(adv).mean(), axis_name)
            adv_n = (adv - gm) / (jnp.sqrt(jnp.maximum(gsq - gm * gm, 0.0))
                                  + 1e-8)
        pg1 = ratio * adv_n
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
        pg_loss = -jnp.minimum(pg1, pg2).mean()
        v_loss = 0.5 * jnp.square(value - target).mean()
        entropy = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=1).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        if bc_obs is not None:
            bc_logits, _ = model.apply(params, bc_obs)
            bc_logp = jax.nn.log_softmax(bc_logits)
            bc_ce = -jnp.take_along_axis(bc_logp, bc_act[:, None],
                                         axis=1).mean()
            total = total + cfg.bc_coef * bc_ce
        return total, (pg_loss, v_loss, entropy)

    def update(ts: TrainState, batch, key):
        obs, action, logp, adv, target = batch
        N = obs.shape[0]
        mb = N // cfg.num_minibatches

        def epoch(ts, key_e):
            if cfg.shuffle == "affine":
                # random odd multiplier + offset: an odd A is coprime to a
                # power-of-two N, so i -> (A*i + r) mod N is a bijection.
                # Restricted to power-of-two N (the default trainer shapes)
                # — a general even N could share an odd factor with A and
                # silently repeat samples.
                assert N & (N - 1) == 0, \
                    "affine shuffle needs power-of-two num_envs*rollout"
                a = jax.random.randint(key_e, (), 0, N // 2) * 2 + 1
                r = jax.random.randint(jax.random.fold_in(key_e, 1),
                                       (), 0, N)
                perm = (jnp.arange(N) * a + r) % N
            else:
                perm = jax.random.permutation(key_e, N)

            def minibatch(ts, idx):
                sl = jax.tree_util.tree_map(
                    lambda x: x[idx],
                    (obs, action, logp, adv, target))
                grads, aux = jax.grad(loss_fn, has_aux=True)(ts.params, *sl)
                if axis_name is not None:
                    # the ONE cross-device collective of the update: average
                    # the per-shard gradients; every device then applies the
                    # identical step to its replicated optimizer state
                    grads = jax.lax.pmean(grads, axis_name)
                    aux = jax.lax.pmean(aux, axis_name)
                return ts.apply_gradients(grads=grads), aux

            idxs = perm[:mb * cfg.num_minibatches].reshape(
                cfg.num_minibatches, mb)
            ts, aux = jax.lax.scan(minibatch, ts, idxs)
            return ts, aux

        ts, aux = jax.lax.scan(epoch, ts, jax.random.split(key, cfg.epochs))
        return ts, aux

    return gae, update


def make_train(cfg: PPOConfig, mesh: Optional[Mesh] = None,
               spec_override=None, bc_data=None):
    """Returns (init_fn, train_step_fn).

    init_fn(key) -> (train_state, env_state, obs, ep_returns)
    train_step_fn(carry, key) -> (carry, metrics)  — one rollout+update cycle,
    fully jitted.  ``spec_override`` trains on a custom (e.g. novelty-
    injected) spec instead of the plain preset.  The acting loop is a
    ``lax.scan`` over the batched env (:func:`ngx.vector.make_vec`).  With a
    ``mesh`` the env batch is sharded over its 1-D ``env`` axis.

    ``train_step.rollout`` and ``train_step.learn`` are the two halves of
    the step (the acting loop, and GAE + the update epochs), jittable apart.
    """
    spec = spec_override or __import__("ngx").make_spec(cfg.env_id)
    if spec.obs_mode != S.OBS_LIDAR_FRONT:
        spec = lidar_in_front(spec)
    # SB2-VecEnv boundary semantics (what the reference trains under,
    # reference tests/train.py:104-122): at a done/cap boundary the policy
    # acts on the RESET observation, and the cap-reset rides the same
    # done-gated lax.cond as the terminal reset — no unconditional
    # full-batch reset in the rollout jaxpr.
    vec = make_vec(spec, episode_cap=cfg.episode_cap, reset_obs=True)
    model = ActorCritic(n_actions=spec.n_actions, hidden=cfg.hidden)

    B, T = cfg.num_envs, cfg.rollout_steps
    batch_shard = (NamedSharding(mesh, P("env")) if mesh is not None else None)

    def init(key):
        k_env, k_net = jax.random.split(key)
        keys = jax.random.split(k_env, B)
        if batch_shard is not None:
            keys = jax.device_put(keys, batch_shard)
        env_state, obs = jax.jit(vec.reset)(keys)
        params = model.init(k_net, jnp.zeros_like(obs, jnp.float32))
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adam(cfg.lr, eps=1e-5),
        )
        ts = TrainState.create(params=params, tx=tx)
        ep_ret = jnp.zeros((B,), jnp.float32)
        if mesh is not None:
            # every carry leaf lives on the whole mesh: the learner state
            # replicated, the per-env arrays sharded like the env state
            ts = jax.device_put(ts, NamedSharding(mesh, P()))
            ep_ret = jax.device_put(ep_ret, batch_shard)
        return ts, env_state, obs, ep_ret

    # Under a mesh the whole step runs SHARD-LOCAL under shard_map: each
    # device acts on, scores and minibatches its own env shard, and the only
    # collectives are the ones written here — the per-minibatch gradient
    # pmean and the scalar advantage moments (make_ppo_core's axis_name
    # note) plus the metric psums.  Leaving the acting loop to the
    # partitioner let the GPU compiler all-gather per-env state every step;
    # tests/test_distributed.py's compiled-HLO audit checks the result.
    axis = None if mesh is None else "env"
    gae, update = make_ppo_core(cfg, model, bc_data=bc_data, axis_name=axis)

    def local_key(key):
        """Decorrelate the per-shard random streams."""
        return key if axis is None else jax.random.fold_in(
            key, jax.lax.axis_index(axis))

    def total(x):
        """Sum of a per-shard scalar over the whole batch."""
        return x if axis is None else jax.lax.psum(x, axis)

    def policy_step(params, env_state, obs, key):
        k_act, k_reset = jax.random.split(key)
        logits, value = model.apply(params, obs.astype(jnp.float32))
        action = jax.random.categorical(k_act, logits)
        logp = jnp.take_along_axis(jax.nn.log_softmax(logits),
                                   action[:, None], axis=1)[:, 0]
        # vec handles the episode cap (done for GAE) and returns the reset
        # obs at boundaries (reset_obs=True above)
        env_state, next_obs, reward, done, info = vec.step(
            env_state, action, jax.random.split(k_reset, action.shape[0]))
        return env_state, next_obs, action, logp, value, reward, done

    def rollout(params, env_state, obs, key):
        def body(carry, key_t):
            env_state, obs = carry
            (env_state, next_obs, action, logp, value, reward, done
             ) = policy_step(params, env_state, obs, key_t)
            out = (obs, action, logp, value, reward, done)
            return (env_state, next_obs), out

        (env_state, last_obs), traj = jax.lax.scan(
            body, (env_state, obs), jax.random.split(local_key(key), T))
        return env_state, last_obs, traj

    def learn(ts, last_obs, traj, key):
        """GAE + the PPO update epochs on one collected batch
        ``traj = (obs, action, logp, value, reward, done)``, each [T, B, ...]
        (rewards already shaped); returns ``(ts, (pg, v, entropy) losses)``."""
        obs_t, action, logp, value, reward, done = traj
        _, last_value = model.apply(ts.params, last_obs)
        adv, target = gae(value, reward, done, last_value)
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]),
            (obs_t, action, logp, adv, target))
        return update(ts, flat, local_key(key))

    def train_step(carry, key):
        ts, env_state, obs, ep_ret = carry
        k_roll, k_upd = jax.random.split(key)
        # steps already taken in each env's current episode BEFORE this
        # rollout — seeds the episode-length tally below
        pre_count = env_state.step_count
        env_state, last_obs, (obs_t, action, logp, value, reward, done) = \
            rollout(ts.params, env_state, obs, k_roll)
        if cfg.solve_shaped:
            # goal terminations pay exactly reward_done; everything else
            # (steps, farming loops, cap truncations, failure dones) pays -1
            solved_step = done & (reward > 0.5 * spec.reward_done)
            reward = jnp.where(solved_step, jnp.float32(spec.reward_done),
                               jnp.float32(-1.0))

        # episode-return bookkeeping (the Monitor analog, on device):
        # fold the rollout's rewards into per-env running returns, emitting
        # completed-episode sums at done boundaries
        def ep_body(carry, xs):
            run, run_len, total, count, solved, len_sum = carry
            r, d = xs
            run = run + r
            run_len = run_len + 1
            total = total + jnp.where(d, run, 0.0).sum()
            count = count + d.sum()
            # solved = terminated on the GOAL step.  The goal pays exactly
            # reward_done (+50); a cap-truncated episode's last step pays at
            # most +20 (v4's fused place) and failure dones are negative, so
            # thresholding at reward_done/2 separates goal terminations from
            # cap truncations (which ride the done flag for GAE).
            s = d & (r > 0.5 * spec.reward_done)
            solved = solved + s.sum()
            # Episode-length tally (diagnostic: mean completed length).
            # NOTE on solve%: completed-episode counts are unbiased per
            # reset ONLY in aggregate — within a single short rollout
            # window, 100-step failures complete in few windows while
            # ~15-step solves complete in most, so a single update's
            # ep_solved/ep_count routinely reads ~100% for a ~75% policy
            # (measured round 4).  Consumers must aggregate counts across
            # updates (ngx.cli.train does) before quoting a solve rate.
            len_sum = len_sum + jnp.where(d, run_len, 0).sum()
            run = jnp.where(d, 0.0, run)
            run_len = jnp.where(d, 0, run_len)
            return (run, run_len, total, count, solved, len_sum), None

        (ep_ret, _, ep_total, ep_count, ep_solved, ep_len), _ = \
            jax.lax.scan(
                ep_body,
                (ep_ret, pre_count, jnp.float32(0), jnp.int32(0),
                 jnp.int32(0), jnp.int32(0)),
                (reward, done))

        ts, (pg, vl, ent) = learn(
            ts, last_obs, (obs_t, action, logp, value, reward, done), k_upd)
        metrics = {
            "mean_reward": total(reward.sum()) / (T * B),
            "episodes": total(done.sum()),
            "ep_return_sum": total(ep_total),
            "ep_count": total(ep_count),
            "ep_solved": total(ep_solved),
            "ep_len_sum": total(ep_len),
            "pg_loss": pg.mean(),
            "v_loss": vl.mean(),
            "entropy": ent.mean(),
        }
        return (ts, env_state, last_obs, ep_ret), metrics

    if mesh is not None:
        # replicated learner state and key, env-sharded everything else
        # ([T, B, ...] trajectories shard on axis 1); the pmean'd outputs
        # carry no varying-mesh-axes metadata, so the check is off
        env, traj_spec, carry_spec = P("env"), P(None, "env"), \
            (P(), P("env"), P("env"), P("env"))
        smap = partial(jax.shard_map, mesh=mesh, check_vma=False)
        step = smap(train_step, in_specs=(carry_spec, P()),
                    out_specs=(carry_spec, P()))
        step.rollout = smap(rollout, in_specs=(P(), env, env, P()),
                            out_specs=(env, env, traj_spec))
        step.learn = smap(learn, in_specs=(P(), env, traj_spec, P()),
                          out_specs=(P(), P()))
        return init, step

    train_step.rollout = rollout
    train_step.learn = learn
    return init, train_step


def train(cfg: PPOConfig, num_updates: int, key=None, mesh: Optional[Mesh] = None,
          log_every: int = 10):
    """Host loop: init once, then num_updates jitted train steps."""
    key = jax.random.key(0) if key is None else key
    init, train_step = make_train(cfg, mesh)
    carry = init(key)
    step = jax.jit(train_step)
    history = []
    for u in range(num_updates):
        carry, metrics = step(carry, jax.random.fold_in(key, u + 1))
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            print(f"update {u+1}: " + " ".join(
                f"{k}={v:.3f}" for k, v in m.items()))
    return carry, history


def dryrun(n_devices: int) -> None:
    """Driver hook: build an n_devices mesh, jit the FULL train step with the
    env axis sharded over it, and run ONE step on tiny shapes."""
    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.asarray(devices), ("env",))
    cfg = PPOConfig(num_envs=4 * n_devices, rollout_steps=4,
                    num_minibatches=2, epochs=1, hidden=(16, 16))
    with mesh:
        init, train_step = make_train(cfg, mesh)
        carry = init(jax.random.key(0))
        assert len(carry[1].map.sharding.device_set) == n_devices, \
            "env state not sharded over the mesh"
        carry, metrics = jax.jit(train_step)(carry, jax.random.key(1))
        jax.block_until_ready(metrics["mean_reward"])
