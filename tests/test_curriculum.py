"""Batched curriculum (ngx/rl/curriculum.py): the vmapped state adapter
vs the reference's restore deep-copy, the chained reset, and the chain
trainer — reference ``tests/train_last_agent.py:72-94``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ngx
from ngx.rl.curriculum import (make_chain_reset, make_state_adapter,
                               make_train_chain)
from ngx.rl.train import PPOConfig
from reference_loader import make_ref_env, reference_available, snapshot_state

CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5"]


@pytest.mark.skipif(not reference_available(),
                    reason="reference repo not mounted")
@pytest.mark.parametrize("src,dst", [
    ("NovelGridworld-v2", "NovelGridworld-v3"),
    ("NovelGridworld-v3", "NovelGridworld-v4"),
    ("NovelGridworld-v4", "NovelGridworld-v5"),
    ("NovelGridworld-v5", "NovelGridworld-v4"),
])
def test_adapter_matches_reference_restore(src, dst):
    """adapter(state) must equal the reference's restore deep-copy
    (novel_gridworld_v2_env.py:77-97) applied to the same source state:
    drive a reference src env, snapshot it, restore it into a reference dst
    env, and compare against the vmapped adapter's output field by field."""
    src_spec = ngx.make_spec(src)
    dst_spec = ngx.make_spec(dst)
    adapt = jax.jit(make_state_adapter(src_spec, dst_spec))

    np.random.seed(11)
    ref_src = make_ref_env(src)
    ref_src.reset()
    rng = np.random.RandomState(12)
    for _ in range(40):
        _, _, d, _ = ref_src.step(int(rng.randint(ref_src.action_space.n)))
        if d:
            break
    st_src = snapshot_state(ref_src, src_spec)
    assert float(st_src.last_reward) == float(ref_src.last_reward)

    ref_dst = make_ref_env(dst, env=ref_src)
    ref_dst.reset()        # the restore branch

    out = adapt(st_src)
    np.testing.assert_array_equal(np.asarray(out.map2d),
                                  np.asarray(ref_dst.map))
    assert tuple(np.asarray(out.agent)) == tuple(ref_dst.agent_location)
    assert int(out.facing) == int(ref_dst.agent_facing_id)
    inv = np.zeros((dst_spec.n_items,), np.int32)
    for item, q in ref_dst.inventory_items_quantity.items():
        inv[dst_spec.items.index(item)] = q
    np.testing.assert_array_equal(np.asarray(out.inventory), inv)
    assert int(out.step_count) == int(ref_dst.step_count)
    assert float(out.last_reward) == float(ref_dst.last_reward)
    # the reference deep-copies last_action (a string) through the restore
    # (novel_gridworld_v2_env.py:87); the adapter carries it by NAME
    ref_la = ref_dst.last_action
    if isinstance(ref_la, str) and ref_la in dst_spec.actions_id:
        assert dst_spec.actions[int(out.last_action)] == ref_la
    else:
        assert int(out.last_action) == 0
    assert not bool(out.last_done)         # restore sets last_done=False


def test_adapter_is_vmappable_and_name_based():
    """Batched adapter between specs with DIFFERENT item tables: ids must be
    re-indexed by name (v1 lacks plank/stick/... that v2 has)."""
    src = ngx.make_spec("NovelGridworld-v2")
    dst = ngx.make_spec("NovelGridworld-v5")
    adapt = jax.vmap(make_state_adapter(src, dst))
    B = 32
    vreset = jax.vmap(ngx.make_reset(src))
    st, _ = jax.jit(vreset)(jax.random.split(jax.random.key(0), B))
    out = jax.jit(adapt)(st)
    # same table here -> the map must be IDENTICAL, inventory too
    np.testing.assert_array_equal(np.asarray(out.map), np.asarray(st.map))
    np.testing.assert_array_equal(np.asarray(out.inventory),
                                  np.asarray(st.inventory))
    assert (np.asarray(out.selected) == -1).all()


def test_chain_reset_produces_restored_states():
    """The batched chain: stage-0 states stepped under a (random) policy,
    frozen at first done, adapted down the chain — restored states carry
    step_count forward and remain structurally valid."""
    B = 32
    chain, last_spec = make_chain_reset(CHAIN[:2], [None], B, cap=30)
    state, obs = jax.jit(chain)(jax.random.key(0))
    assert state.map.shape == (B, last_spec.map_size ** 2)
    assert obs.shape[0] == B
    # v2 under random crafting finishes quickly (dead-end done) — most envs
    # must have accumulated steps before the restore
    counts = np.asarray(state.step_count)
    assert (counts > 0).mean() > 0.9, counts
    assert (counts <= 30).all()
    assert not np.asarray(state.last_done).any()
    # obs is the restored state's observation
    get_obs_v = jax.vmap(ngx.make_step(last_spec).get_obs)
    np.testing.assert_array_equal(np.asarray(obs),
                                  np.asarray(get_obs_v(state)))


def test_train_chain_step():
    """One jitted chain-train step: pool refresh + rollout with pool
    boundary-restores + PPO update; finite losses, episodes complete."""
    cfg = PPOConfig(env_id=CHAIN[-1], num_envs=16, rollout_steps=12,
                    num_minibatches=2, epochs=1, hidden=(16, 16),
                    episode_cap=8)
    init, train_step = make_train_chain(cfg, CHAIN[:3], [None, None],
                                        hidden=(16, 16))
    carry = init(jax.random.key(0))
    carry, metrics = jax.jit(train_step)(carry, jax.random.key(1))
    m = {k: float(v) for k, v in metrics.items()}
    assert np.isfinite(m["pg_loss"]) and np.isfinite(m["v_loss"]), m
    # episode budget counts from the restore (per-stage, enjoy.py:87,107),
    # NOT against the inherited total step_count — a T=12 rollout under an
    # 8-step budget forces at least one boundary restore per env
    assert m["episodes"] >= cfg.num_envs
    # restored rows must not be instantly done: with the old total-step cap
    # every pool row with step_count >= cap churned as zero-length episodes
    assert m["episodes"] <= cfg.num_envs * (12 // 2 + 1)
