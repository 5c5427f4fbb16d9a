"""The plain-JAX ActorCritic and TrainState: the shipped checkpoints load and
forward exactly as a float64 numpy MLP of the same weights, fresh layers
follow the documented initialiser, and apply_gradients is one optax step."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import ngx
from ngx.rl.models import ActorCritic
from ngx.rl.train_state import TrainState
from ngx.transforms import lidar_in_front

AGENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "trained_agents")
SHIPPED = [
    "NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
    "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
    "NovelGridworld-v6", "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0", "NovelGridworld-Pogostick-v1",
    "NovelGridworld-v5_solver", "NovelGridworld-v6_solver",
    "NovelGridworld-Bow-v0_solver", "NovelGridworld-Bow-v1_solver",
    "NovelGridworld-Pogostick-v0_solver",
    "NovelGridworld-Pogostick-v1_solver",
]


def numpy_forward(params, obs):
    """float64 reference forward of the two tanh towers."""
    p = {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
         for k, v in params["params"].items()}
    x = np.asarray(obs, np.float64)

    def tower(name):
        h, i = x, 0
        while f"{name}_{i}" in p:
            layer = p[f"{name}_{i}"]
            h = np.tanh(h @ layer["kernel"] + layer["bias"])
            i += 1
        return h @ p[f"{name}_out"]["kernel"] + p[f"{name}_out"]["bias"]

    return tower("pi"), tower("v")[..., 0]


@pytest.mark.parametrize("agent", SHIPPED)
def test_shipped_checkpoint_forward_matches_numpy(agent):
    from ngx.utils.checkpoint import restore_pytree

    tree = restore_pytree(os.path.join(AGENTS, agent, "best"))
    params = tree["params"]
    p = params["params"]
    n_hidden = sum(1 for k in p if k.startswith("pi_") and k != "pi_out")
    hidden = tuple(p[f"pi_{i}"]["kernel"].shape[1] for i in range(n_hidden))
    spec = lidar_in_front(ngx.make_spec(agent.replace("_solver", "")))
    model = ActorCritic(n_actions=spec.n_actions, hidden=hidden)

    _, obs = jax.vmap(ngx.make_reset(spec))(
        jax.random.split(jax.random.key(0), 32))
    # the checkpoint's tree is exactly the one init builds for this spec
    fresh = model.init(jax.random.key(1), obs)
    assert (jax.tree_util.tree_structure(fresh)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(fresh),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == np.shape(b)

    logits, value = model.apply(params, obs)
    ref_logits, ref_value = numpy_forward(params, obs)
    assert logits.shape == (32, spec.n_actions) and value.shape == (32,)
    np.testing.assert_allclose(np.asarray(logits), ref_logits,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(value), ref_value,
                               rtol=1e-5, atol=1e-5)


def test_init_is_truncated_lecun_normal_with_zero_bias():
    model = ActorCritic(n_actions=5, hidden=(256, 128))
    params = model.init(jax.random.key(0), jnp.zeros((1, 400)))["params"]
    assert sorted(params) == ["pi_0", "pi_1", "pi_out", "v_0", "v_1",
                              "v_out"]
    k = np.asarray(params["pi_0"]["kernel"])
    assert k.shape == (400, 256) and k.dtype == np.float32
    # truncated at 2 std of the untruncated normal, rescaled to unit
    # variance over fan_in: std 1/sqrt(400), |k| <= 2 * 1.137/sqrt(400)
    np.testing.assert_allclose(k.std(), 1 / np.sqrt(400), rtol=0.05)
    assert np.abs(k).max() <= 2 * 1.14 / np.sqrt(400)
    for layer in params.values():
        assert not np.asarray(layer["bias"]).any()
    assert params["v_out"]["kernel"].shape == (128, 1)
    # the two towers draw independent weights
    assert not np.allclose(params["pi_0"]["kernel"], params["v_0"]["kernel"])


def test_train_state_apply_gradients_is_one_optax_step():
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(1e-2, eps=1e-5))
    params = ActorCritic(n_actions=3, hidden=(8,)).init(
        jax.random.key(0), jnp.zeros((1, 6)))
    grads = jax.tree_util.tree_map(
        lambda x: jnp.full_like(x, 0.3), params)
    ts = TrainState.create(params=params, tx=tx)
    ts2 = jax.jit(lambda t, g: t.apply_gradients(g))(ts, grads)

    @jax.jit
    def by_hand(params, grads):
        opt_state = tx.init(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    expect, opt_state = by_hand(params, grads)
    assert int(ts2.step) == 1 and int(ts.step) == 0
    for a, b in zip(jax.tree_util.tree_leaves(ts2.params),
                    jax.tree_util.tree_leaves(expect)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(ts2.opt_state),
                    jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # tx rides as static metadata, the rest as leaves
    leaves, treedef = jax.tree_util.tree_flatten(ts2)
    assert all(hasattr(x, "shape") for x in leaves)
    assert jax.tree_util.tree_unflatten(treedef, leaves).tx is tx
    assert ts2.replace(step=jnp.int32(7)).step == 7
