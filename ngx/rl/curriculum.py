"""Batched curriculum training — the reference's restore-chaining sweep
(``tests/train_last_agent.py:72-94``) rebuilt as batched device programs.

The reference chains envs by deep-copying the previous env's terminal state
into the next env's reset (restore branch,
``novel_gridworld_v2_env.py:77-97``), plays each stage with a frozen
pre-trained agent for <=100 steps, and trains the LAST env from the restored
state — one Python env, one episode at a time.  Here the whole chain is
batched and jitted:

* :func:`make_state_adapter` — the restore deep-copy as a pure, vmappable
  ``EnvState -> EnvState`` function between two specs, re-indexed by item
  NAME (same mapping as the single-env facade restore,
  ``ngx/compat/env.py:286-304``; for the legacy v2..v5 chain the item tables
  coincide and the remap is the identity).
* :func:`make_chain_reset` — B independent chains run in lockstep: batched
  procedural reset of stage 0, frozen-policy rollout frozen at each env's
  first done (the reference's per-stage 100-step episode), adapt, repeat —
  one jitted function from key to the last stage's restored state batch.
* :func:`make_train_chain` — PPO on the last stage where every episode
  boundary restores a fresh chain-terminal state drawn from a carried pool
  of chain states, re-chained per LAUNCH via ``train_step.refresh_pool``
  (the reference re-runs its chain once per outer episode / ``learn(500)``
  — coarser than per launch).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.state import EnvState
from ..core.step import make_step
from ..core.reset import make_reset
from ..transforms import lidar_in_front
from .models import ActorCritic
from .train import PPOConfig, make_ppo_core
from .train_state import TrainState


def make_state_adapter(src_spec, dst_spec):
    """Pure ``EnvState -> EnvState`` implementing the reference's restore
    deep-copy (``novel_gridworld_v2_env.py:77-97``, modern variant
    ``pogostick_v1_env.py:89-109``): map, agent location/facing, inventory,
    ``step_count``, ``last_action`` and ``last_reward`` carry over;
    ``last_done`` resets to False; ``selected_item`` is the fresh env's.
    Item AND action ids are re-indexed by NAME so specs with different
    tables stay consistent (the reference stores the action as a string, so
    its deep-copy is name-preserving by construction; a src action absent
    from dst maps to 0).  vmappable."""
    map_remap = np.zeros((src_spec.n_items,), np.int32)
    for i, n in enumerate(src_spec.items):
        map_remap[i] = dst_spec.items.index(n) if n in dst_spec.items else 0
    inv_gather = np.full((dst_spec.n_items,), -1, np.int32)
    for j, n in enumerate(dst_spec.items):
        if n in src_spec.items:
            inv_gather[j] = src_spec.items.index(n)
    act_remap = np.zeros((src_spec.n_actions,), np.int32)
    for i, n in enumerate(src_spec.actions):
        act_remap[i] = (dst_spec.actions.index(n)
                        if n in dst_spec.actions else 0)
    assert src_spec.map_size == dst_spec.map_size, \
        (src_spec.map_size, dst_spec.map_size)

    def adapt(st: EnvState) -> EnvState:
        m = jnp.asarray(map_remap)[st.map]
        inv = jnp.where(jnp.asarray(inv_gather) >= 0,
                        st.inventory[jnp.clip(jnp.asarray(inv_gather), 0)],
                        0)
        return EnvState(
            map=m.astype(jnp.int32),
            agent=st.agent,
            facing=st.facing,
            inventory=inv.astype(jnp.int32),
            selected=jnp.int32(-1),
            step_count=st.step_count,
            last_action=jnp.asarray(act_remap)[st.last_action],
            last_reward=st.last_reward,
            last_cost=jnp.float32(0.0),
            last_done=jnp.asarray(False),
        )

    return adapt


def _stage_fns(spec, hidden):
    """(reset, step, get_obs, apply) for one chain stage."""
    step = make_step(spec)
    model = ActorCritic(n_actions=spec.n_actions, hidden=tuple(hidden))
    return (make_reset(spec), step, step.get_obs, model.apply)


def make_chain_reset(env_ids: Sequence[str], stage_params: Sequence,
                     batch: int, cap: int = 100, hidden=(64, 64)):
    """Build ``chain(key) -> (state[B], obs[B])`` for the LAST env id.

    ``stage_params[k]`` drives stage k (ActorCritic params, or None for uniform
    random actions — the reference uses frozen pre-trained agents,
    ``train_last_agent.py:66-70``).  Each stage runs its batch from the
    restored states for up to ``cap`` steps; each env FREEZES at its first
    done (the reference breaks its per-stage loop on done,
    ``train_last_agent.py:100-110``), then the frozen batch is adapted into
    the next stage's spec.  Only the first n-1 stages are played; the last
    stage's restored states are returned for training."""
    import ngx

    specs = [lidar_in_front(ngx.make_spec(e)) for e in env_ids]
    assert len(stage_params) >= len(specs) - 1, \
        "need params (or None) for every stage except the last"
    fns = [_stage_fns(sp, hidden) for sp in specs]
    adapters = [make_state_adapter(specs[k], specs[k + 1])
                for k in range(len(specs) - 1)]

    def chain(key):
        k0, key = jax.random.split(key)
        reset0, _, _, _ = fns[0]
        state, obs = jax.vmap(reset0)(jax.random.split(k0, batch))
        for k in range(len(specs) - 1):
            _, step_k, get_obs_k, apply_k = fns[k]
            n_actions = specs[k].n_actions
            params = stage_params[k]
            key, k_roll = jax.random.split(key)

            def body(carry, key_t):
                st, ob, frozen = carry
                k_act = key_t
                if params is None:
                    a = jax.random.randint(k_act, (batch,), 0, n_actions)
                else:
                    logits, _ = apply_k(params, ob.astype(jnp.float32))
                    a = jax.random.categorical(k_act, logits)
                ns, nobs, r, done, _ = jax.vmap(step_k)(st, a)

                # freeze each env at its first done (terminal state is what
                # the next stage restores); cap handled by the scan length
                def mrg(old, new):
                    return jnp.where(
                        frozen.reshape(frozen.shape
                                       + (1,) * (new.ndim - 1)), old, new)

                st2 = jax.tree_util.tree_map(mrg, st, ns)
                ob2 = jax.tree_util.tree_map(mrg, ob, nobs)
                return (st2, ob2, frozen | done), None

            (state, obs, _), _ = jax.lax.scan(
                body, (state, obs, jnp.zeros((batch,), bool)),
                jax.random.split(k_roll, cap))
            state = jax.vmap(adapters[k])(state)
            obs = jax.vmap(fns[k + 1][2])(state)
        return state, obs

    return chain, specs[-1]


def evaluate_chain(env_ids: Sequence[str], stage_params: Sequence,
                   final_params, episodes: int = 128, cap: int = 100,
                   hidden=(64, 64), seed: int = 0):
    """Evaluate a chain-trained LAST-stage policy under the protocol it was
    trained for (the reference's, ``train_last_agent.py:95-117``): play the
    earlier stages with their frozen policies, restore into the last env,
    then roll the final policy from the restored states for a fresh
    ``cap``-step budget (the reference gives EACH chained env its own
    <=100-step loop, enjoy.py:87,107).  Solved = GOAL termination within
    the budget (terminal reward above ``reward_done/2`` — a cap-forced
    done after a positive farm step does not count)."""
    import jax.numpy as jnp

    chain, spec = make_chain_reset(env_ids, stage_params, episodes, cap,
                                   hidden)
    step1 = make_step(spec)
    v_step = jax.vmap(step1)
    model = ActorCritic(n_actions=spec.n_actions, hidden=tuple(hidden))

    @jax.jit
    def run(key):
        k0, k1 = jax.random.split(key)
        state, obs = chain(k0)
        # per-stage step budget: the reference gives EACH chained env its
        # own <=100-step loop (enjoy.py:87,107; train_last_agent.py:95-117),
        # so the final stage's budget counts from the restore, not from the
        # inherited total step_count (which can already exceed the cap when
        # an earlier stage ran its full loop without finishing).
        base = state.step_count

        def body(carry, key_t):
            state, obs, ret, done_ever, solved = carry
            logits, _ = model.apply(final_params,
                                    obs.astype(jnp.float32))
            a = jax.random.categorical(key_t, logits)
            ns, nobs, r, done, _ = v_step(state, a)
            done = done | (ns.step_count - base >= cap)
            active = ~done_ever
            ret = ret + jnp.where(active, r, 0.0)
            # solved = GOAL termination only: the goal step pays exactly
            # reward_done (+50); a cap-forced done whose last step happens
            # to pay a positive farm reward (+10 Break etc.) must NOT
            # count — same threshold as the trainers (ngx/rl/train.py)
            solved = solved | (active & done
                               & (r > 0.5 * spec.reward_done))
            done_ever = done_ever | done
            keep = done_ever

            def mrg(o, n):
                return jnp.where(
                    keep.reshape(keep.shape + (1,) * (n.ndim - 1)), o, n)

            state = jax.tree_util.tree_map(mrg, state, ns)
            obs = jax.tree_util.tree_map(mrg, obs, nobs)
            return (state, obs, ret, done_ever, solved), None

        B = episodes
        carry = (state, obs, jnp.zeros((B,)), jnp.zeros((B,), bool),
                 jnp.zeros((B,), bool))
        (_, _, ret, done_ever, solved), _ = jax.lax.scan(
            body, carry, jax.random.split(k1, cap))
        return {"mean_return": ret.mean(), "solve_rate": solved.mean(),
                "done_rate": done_ever.mean()}

    return {k: float(v) for k, v in run(jax.random.key(seed)).items()}


def make_train_chain(cfg: PPOConfig, env_ids: Sequence[str],
                     stage_params: Sequence, hidden=None, bc_data=None,
                     pool_size: int = None):
    """(init, train_step) for PPO on the LAST env of ``env_ids``, where
    every reset — initial and at episode boundaries — restores a fresh
    chain-terminal state (reference semantics: the trained env's reset IS
    the restore branch, ``train_last_agent.py:77-87``).

    Boundary resets draw uniformly (with replacement) from a carried pool
    of ``pool_size`` chain-terminal states.  ``bc_data`` and
    ``cfg.solve_shaped`` apply the solver recipe (BC-anchored minibatch
    loss + solve-shaped reward) to the chain stage, exactly as in
    :func:`ngx.rl.train.make_train`.

    The B-state restore pool rides in the CARRY; re-chaining is host-paced:
    ``train_step`` leaves the pool untouched, and the attached
    ``train_step.refresh_pool(carry, key)`` (jit it once) re-runs the chain
    to replace it — ``ngx.cli.train`` calls it once per launch.  The
    reference re-chains once per outer ``learn(500)``
    (train_last_agent.py:95-117), i.e. far LESS often than per update; an
    in-jit per-update re-chain would also dominate the step (the chain is
    a cap-length frozen-stage scan, several rollouts' worth of stepping).

    ``pool_size`` (default min(B, 1024)): distinct chain-terminal states
    per refresh.  Restores draw WITH replacement, so the pool can be far
    smaller than the env batch — the reference trains every episode from
    ONE chain state (train_last_agent.py:77-87); 1024 fresh states per
    launch is orders more diversity at a quarter of the re-chain cost."""
    hidden = tuple(hidden or cfg.hidden)
    B, T = cfg.num_envs, cfg.rollout_steps
    P = pool_size or min(B, 1024)
    chain, spec = make_chain_reset(env_ids, stage_params, P,
                                   cap=cfg.episode_cap, hidden=hidden)
    step1 = make_step(spec)
    v_step = jax.vmap(step1)
    model = ActorCritic(n_actions=spec.n_actions, hidden=hidden)
    gae, update = make_ppo_core(cfg, model, bc_data=bc_data)

    def init(key):
        k_env, k_net, k_idx = jax.random.split(key, 3)
        pool, pool_obs = jax.jit(chain)(k_env)
        idx = jax.random.randint(k_idx, (B,), 0, P)
        env_state = jax.tree_util.tree_map(lambda x: x[idx], pool)
        obs = pool_obs[idx]
        params = model.init(k_net, jnp.zeros_like(obs, jnp.float32))
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adam(cfg.lr, eps=1e-5),
        )
        ts = TrainState.create(params=params, tx=tx)
        # carry a per-env restore baseline: episode budget counts from the
        # restore (the reference gives each chained env its OWN <=100-step
        # loop, enjoy.py:87,107, and its last-stage learn() has no time
        # limit at all) — counting the inherited TOTAL step_count against
        # the cap would make pool rows whose prior stages consumed >= cap
        # steps instantly done forever (zero-length episode churn).
        # initial state batch = B with-replacement draws from the fresh
        # P-row chain pool; refresh_pool replaces the pool itself.
        return (ts, env_state, obs, jnp.zeros((B,), jnp.float32),
                env_state.step_count, pool, pool_obs)

    def rollout(params, env_state, obs, base, pool, pool_obs, key):
        def body(carry, key_t):
            env_state, obs, base = carry
            k_act, k_pool = jax.random.split(key_t)
            logits, value = model.apply(params, obs.astype(jnp.float32))
            action = jax.random.categorical(k_act, logits)
            logp = jnp.take_along_axis(jax.nn.log_softmax(logits),
                                       action[:, None], axis=1)[:, 0]
            ns, nobs, reward, done, _ = v_step(env_state, action)
            done = done | (ns.step_count - base >= cfg.episode_cap)
            idx = jax.random.randint(k_pool, (B,), 0, P)
            fresh = jax.tree_util.tree_map(lambda x: x[idx], pool)

            def mrg(f, n):
                return jnp.where(
                    done.reshape(done.shape + (1,) * (n.ndim - 1)), f, n)

            env_state = jax.tree_util.tree_map(mrg, fresh, ns)
            nobs = mrg(pool_obs[idx], nobs)
            base = jnp.where(done, fresh.step_count, base)
            out = (obs, action, logp, value, reward, done)
            return (env_state, nobs, base), out

        (env_state, last_obs, base), traj = jax.lax.scan(
            body, (env_state, obs, base), jax.random.split(key, T))
        return env_state, last_obs, base, traj

    def train_step(carry, key):
        ts, env_state, obs, ep_ret, base, pool, pool_obs = carry
        _, k_roll, k_upd = jax.random.split(key, 3)
        pre_count = env_state.step_count - base
        env_state, last_obs, base, \
            (obs_t, action, logp, value, reward, done) = \
            rollout(ts.params, env_state, obs, base, pool, pool_obs, k_roll)
        if cfg.solve_shaped:
            # same shaping as make_train: goal terminations pay exactly
            # reward_done, everything else -1 (kills the farming optimum)
            solved_step = done & (reward > 0.5 * spec.reward_done)
            reward = jnp.where(solved_step, jnp.float32(spec.reward_done),
                               jnp.float32(-1.0))
        _, last_value = model.apply(ts.params, last_obs.astype(jnp.float32))
        adv, target = gae(value, reward, done, last_value)

        # same tallies as make_train (see ngx/rl/train.py's ep_body note
        # on aggregating solve counts across updates)
        def ep_body(carry, xs):
            run, run_len, total, count, solved, len_sum = carry
            r, d = xs
            run = run + r
            run_len = run_len + 1
            total = total + jnp.where(d, run, 0.0).sum()
            count = count + d.sum()
            s = d & (r > 0.5 * spec.reward_done)
            solved = solved + s.sum()
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

        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((T * B,) + x.shape[2:]),
            (obs_t, action, logp, adv, target))
        ts, (pg, vl, ent) = update(ts, flat, k_upd)
        metrics = {
            "mean_reward": reward.mean(),
            "episodes": done.sum(),
            "ep_return_sum": ep_total,
            "ep_count": ep_count,
            "ep_solved": ep_solved,
            "ep_len_sum": ep_len,
            "pg_loss": pg.mean(),
            "v_loss": vl.mean(),
            "entropy": ent.mean(),
        }
        return (ts, env_state, last_obs, ep_ret, base, pool, pool_obs), \
            metrics

    def refresh_pool(carry, key):
        """Re-run the chain and swap the carried restore pool (host-paced —
        once per launch in ngx.cli.train; the reference's analog is one
        re-chain per learn(500))."""
        pool, pool_obs = chain(key)
        return carry[:5] + (pool, pool_obs)

    train_step.refresh_pool = refresh_pool
    return init, train_step
