"""EnvState / StepInfo as plain registered dataclasses: replace, flatten
order, vmap, and an orbax round-trip back into the dataclass."""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

import ngx
from ngx.core.state import EnvState, StepInfo, zeros_state

POGO = "NovelGridworld-Pogostick-v1"
FIELDS = ("map", "agent", "facing", "inventory", "selected", "step_count",
          "last_action", "last_reward", "last_cost", "last_done")


def test_replace_returns_a_new_frozen_state():
    st = zeros_state(ngx.make_spec(POGO))
    st2 = st.replace(step_count=jnp.int32(5), facing=jnp.int32(2))
    assert int(st2.step_count) == 5 and int(st2.facing) == 2
    assert int(st.step_count) == 0          # the original is untouched
    assert st2.map is st.map
    info = StepInfo(result=jnp.bool_(True), step_cost=jnp.float32(1.5),
                    msg_code=jnp.int32(3), msg_arg=jnp.int32(-1))
    assert int(info.replace(msg_code=jnp.int32(4)).msg_code) == 4
    try:
        st.step_count = 3
    except dataclasses.FrozenInstanceError:
        pass
    else:
        raise AssertionError("EnvState must be frozen")


def test_flatten_order_is_declaration_order():
    st = zeros_state(ngx.make_spec(POGO))
    assert tuple(f.name for f in dataclasses.fields(EnvState)) == FIELDS
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert len(leaves) == len(FIELDS)
    for f, leaf in zip(FIELDS, leaves):
        assert leaf is getattr(st, f)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(st)]
    assert paths == [f".{f}" for f in FIELDS]
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt, EnvState)
    assert [f.name for f in dataclasses.fields(StepInfo)] == [
        "result", "step_cost", "msg_code", "msg_arg"]


def test_vmapped_reset_and_step_batch_every_field():
    spec = ngx.make_spec(POGO)
    keys = jax.random.split(jax.random.key(0), 6)
    state, _ = jax.vmap(ngx.make_reset(spec))(keys)
    assert isinstance(state, EnvState)
    assert state.map.shape == (6, spec.map_size ** 2)
    assert state.inventory.shape == (6, spec.n_items)
    assert state.step_count.shape == (6,)
    ns, _, r, done, info = jax.jit(jax.vmap(ngx.make_step(spec)))(
        state, jnp.zeros((6,), jnp.int32))
    assert isinstance(ns, EnvState) and isinstance(info, StepInfo)
    assert (np.asarray(ns.step_count) == 1).all()
    assert info.step_cost.shape == (6,) and r.shape == (6,)
    # a vmapped replace over the batch axis
    bumped = jax.vmap(lambda s: s.replace(step_count=s.step_count + 10))(ns)
    assert (np.asarray(bumped.step_count) == 11).all()


def test_checkpoint_roundtrip_like_rebuilds_dataclasses(tmp_path):
    from ngx.utils.checkpoint import restore_pytree, save_pytree

    spec = ngx.make_spec(POGO)
    state, _ = jax.vmap(ngx.make_reset(spec))(
        jax.random.split(jax.random.key(3), 4))
    _, _, _, _, info = jax.vmap(ngx.make_step(spec))(
        state, jnp.arange(4, dtype=jnp.int32))
    tree = {"state": state, "info": info}
    save_pytree(str(tmp_path / "ck"), tree)
    back = restore_pytree(str(tmp_path / "ck"), like=tree)
    assert isinstance(back["state"], EnvState)
    assert isinstance(back["info"], StepInfo)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
