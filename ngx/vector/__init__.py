"""Batched environments: ``jit(vmap(step))`` with auto-reset and scan rollouts.

This is the layer the reference doesn't have (its vectorized path is commented
out — reference ``tests/train.py:114-120``; training steps one Python env at a
time).  Here the whole env batch is one device-resident ``EnvState`` pytree
with a leading env axis; stepping 8k+ envs is a single XLA program launch, and
a T-step rollout is one ``lax.scan`` launch (no host round-trips at all).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.reset import make_reset
from ..core.step import make_step
from ..core.state import EnvState


class VecEnv(NamedTuple):
    """Pure-function bundle for a batched environment."""
    spec: object
    reset: Callable    # (keys[B]) -> (state, obs)
    step: Callable     # (state, actions[B], keys[B]) -> (state, obs, r, done, info)
    rollout: Callable  # (state, key, policy, T) -> (state, Trajectory)


class Trajectory(NamedTuple):
    """Time-major stacked rollout output (T leading, then batch)."""
    obs: object
    actions: jnp.ndarray
    rewards: jnp.ndarray
    dones: jnp.ndarray
    step_costs: jnp.ndarray


def make_vec(spec, *, episode_cap: Optional[int] = None,
             reset_obs: bool = False) -> VecEnv:
    """Build the batched env for ``spec``.

    ``step`` auto-resets finished envs: when an env reports done, its next
    state is a fresh ``reset`` draw (one key per env per step, cheap — the
    fresh state is only selected where done).  By default the returned
    ``obs`` is the terminal observation (gym-classic semantics, what the
    compat facade surfaces) and ``done`` flags the boundary; the *state*
    carried forward is the reset one.

    ``reset_obs=True`` switches to SB2-VecEnv semantics (what the reference
    trains under — reference ``tests/train.py:104-122``): at a boundary the
    returned obs is the *reset* observation, so a policy acting on it chooses
    the new episode's first action from the new episode's first state.  The
    invariant then is simply ``obs == vmap(get_obs)(carried_state)`` on every
    step.

    ``episode_cap`` adds the trainer's time-limit truncation (reference eval
    cap, ``enjoy.py:87,107``): envs whose post-step ``step_count`` reaches
    the cap read as done (for GAE) and auto-reset — inside the same
    done-gated ``lax.cond``, so uncapped common-path steps pay nothing.
    """
    single_reset = make_reset(spec)
    single_step = make_step(spec)

    v_reset = jax.vmap(single_reset)
    v_step = jax.vmap(single_step)

    def reset(keys):
        return v_reset(keys)

    def step(state: EnvState, actions, keys):
        new_state, obs, reward, done, info = v_step(state, actions)
        if episode_cap is not None:
            done = done | (new_state.step_count >= episode_cap)

        def _sel(f, n):
            return jnp.where(
                done.reshape(done.shape + (1,) * (n.ndim - 1)), f, n)

        def with_resets(ns_obs):
            ns, o = ns_obs
            fresh_state, fresh_obs = v_reset(keys)
            merged = jax.tree_util.tree_map(_sel, fresh_state, ns)
            if reset_obs:
                o = jax.tree_util.tree_map(_sel, fresh_obs, o)
            return merged, o

        # Fresh resets are ~5x the cost of a step; only pay for them on steps
        # where at least one env actually finished (lax.cond keeps the branch
        # out of the common path — episodes are 100+ steps long).
        carried, obs = jax.lax.cond(jnp.any(done), with_resets,
                                    lambda ns_obs: ns_obs, (new_state, obs))
        return carried, obs, reward, done, info

    def rollout(state: EnvState, key, policy, T: int):
        """Scan ``T`` steps.  ``policy(key, obs_or_state) -> actions[B]``;
        pass ``policy=None`` for uniform-random actions."""
        B = state.step_count.shape[0]
        n_actions = spec.n_actions

        def body(carry, key_t):
            state = carry
            k_act, k_reset = jax.random.split(key_t)
            if policy is None:
                actions = jax.random.randint(k_act, (B,), 0, n_actions)
            else:
                actions = policy(k_act, state)
            reset_keys = jax.random.split(k_reset, B)
            state, obs, reward, done, info = step(state, actions, reset_keys)
            return state, Trajectory(obs, actions, reward, done, info.step_cost)

        keys = jax.random.split(key, T)
        state, traj = jax.lax.scan(body, state, keys)
        return state, traj

    return VecEnv(spec=spec, reset=reset, step=step, rollout=rollout)


def throughput_fn(spec, batch: int, steps: int, action_rng: str = "threefry",
                  auto_reset: bool = True, packed: bool = False):
    """One fused jit computing ``steps`` batched random-action steps — the
    benchmark kernel (BASELINE.json's env-steps/s/chip metric).

    Unlike :func:`make_vec`'s trajectory rollout this stores nothing per step
    (no T×B obs stacking — that alone is ~1 GB of HBM writes at 8192×256):
    the scan carry is just the state plus running reward/done accumulators,
    so the whole rollout stays compute-bound.

    ``action_rng``/``auto_reset`` exist for the perf breakdown
    (``ngx.cli.perf``): 'threefry' draws actions with
    jax.random.randint (default), 'hash' with a murmur3-style counter hash
    (one mix per step instead of a threefry block), 'fixed' repeats action 0
    (no RNG at all); ``auto_reset=False`` drops the done->reset cond.

    ``packed=True`` carries the state BIT-PACKED through the scan
    (``ngx.core.state.make_state_packers``: ~26 int32 words/env instead of
    ~118), trading carry bytes for shift/mask work per step.  Exact: the
    packing is lossless, so the same key produces bit-identical results to
    the unpacked kernel (tests/test_vector.py)."""
    single_reset = make_reset(spec)
    single_step = make_step(spec)
    v_reset = jax.vmap(single_reset)
    v_step = jax.vmap(single_step)
    n_actions = spec.n_actions
    if packed:
        from ..core.state import make_state_packers
        pack_s, unpack_s, _ = make_state_packers(spec)

    def _hash_actions(t):
        x = (jnp.arange(batch, dtype=jnp.uint32) * jnp.uint32(0x9E3779B1)
             ^ (t.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)))
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x85EBCA6B)
        x = x ^ (x >> 13)
        x = x * jnp.uint32(0xC2B2AE35)
        x = x ^ (x >> 16)
        return ((x >> 1).astype(jnp.int32)) % n_actions

    @jax.jit
    def run(key):
        k0, k1 = jax.random.split(key)
        state, _ = v_reset(jax.random.split(k0, batch))

        def body(carry, xs):
            state, r_sum, d_sum = carry
            if packed:
                state = unpack_s(state)
            key_t, t = xs
            k_act, k_reset = jax.random.split(key_t)
            if action_rng == "threefry":
                actions = jax.random.randint(k_act, (batch,), 0, n_actions)
            elif action_rng == "hash":
                actions = _hash_actions(t)
            else:
                actions = jnp.zeros((batch,), jnp.int32)
            new_state, _, reward, done, _ = v_step(state, actions)

            def with_resets(ns):
                fresh, _ = v_reset(jax.random.split(k_reset, batch))
                return jax.tree_util.tree_map(
                    lambda f, n: jnp.where(
                        done.reshape(done.shape + (1,) * (n.ndim - 1)), f, n),
                    fresh, ns)

            if auto_reset:
                state = jax.lax.cond(jnp.any(done), with_resets,
                                     lambda ns: ns, new_state)
            else:
                state = new_state
            if packed:
                state = pack_s(state)
            return (state, r_sum + reward.sum(), d_sum + done.sum()), None

        init = (pack_s(state) if packed else state,
                jnp.float32(0), jnp.int32(0))
        (state, r_sum, d_sum), _ = jax.lax.scan(
            body, init, (jax.random.split(k1, steps),
                         jnp.arange(steps, dtype=jnp.int32)))
        if packed:
            state = unpack_s(state)
        return state, r_sum / (batch * steps)

    return run
