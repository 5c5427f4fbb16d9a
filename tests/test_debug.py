"""NGX_DEBUG=1 in-kernel invariant asserts (ngx/utils/debug.py).

Runs on CPU (conftest forces it).  The debug layer adds a host callback to
every step, so it is a development-time tool — which is exactly where it is
used.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture()
def debug_env(monkeypatch):
    monkeypatch.setenv("NGX_DEBUG", "1")
    import ngx
    spec = ngx.make_spec("NovelGridworld-Pogostick-v1")
    # debug mode is resolved when the kernel is BUILT, so build under the flag
    step = jax.jit(ngx.make_step(spec))
    reset = jax.jit(ngx.make_reset(spec))
    return spec, reset, step


def test_debug_clean_run_passes(debug_env):
    spec, reset, step = debug_env
    state, obs = reset(jax.random.key(0))
    for a in range(spec.n_actions):
        state, obs, r, d, i = step(state, jnp.int32(a))
    jax.block_until_ready(state.map)


def test_debug_catches_negative_inventory(debug_env):
    spec, reset, step = debug_env
    state, _ = reset(jax.random.key(0))
    bad = state.replace(inventory=state.inventory.at[1].set(-3))
    with pytest.raises(Exception, match="inventory"):
        out = step(bad, jnp.int32(0))
        jax.block_until_ready(out[0].map)


def test_debug_catches_broken_wall_ring(debug_env):
    spec, reset, step = debug_env
    state, _ = reset(jax.random.key(0))
    bad = state.replace(map=state.map.at[0].set(0))   # corner wall -> air
    with pytest.raises(Exception, match="wall ring"):
        out = step(bad, jnp.int32(0))
        jax.block_until_ready(out[0].map)


def test_debug_catches_violation_under_vmap(debug_env):
    spec, reset, step_single = debug_env
    import ngx
    vstep = jax.jit(jax.vmap(ngx.make_step(spec)))
    vreset = jax.vmap(ngx.make_reset(spec))
    vs, _ = vreset(jax.random.split(jax.random.key(1), 4))
    out = vstep(vs, jnp.zeros(4, jnp.int32))
    jax.block_until_ready(out[0].map)                 # clean batch passes
    badv = vs.replace(inventory=vs.inventory.at[2, 3].set(-5))
    with pytest.raises(Exception, match="inventory"):
        out = vstep(badv, jnp.zeros(4, jnp.int32))
        jax.block_until_ready(out[0].map)


def test_debug_off_by_default(monkeypatch):
    monkeypatch.delenv("NGX_DEBUG", raising=False)
    import ngx
    spec = ngx.make_spec("NovelGridworld-Pogostick-v1")
    step = ngx.make_step(spec)
    state, _ = ngx.make_reset(spec)(jax.random.key(0))
    # no callback in the program: a corrupted state steps without raising
    bad = state.replace(inventory=state.inventory.at[1].set(-3))
    out = jax.jit(step)(bad, jnp.int32(0))
    jax.block_until_ready(out[0].map)
    # and the compiled HLO contains no host callback custom-calls
    txt = jax.jit(step).lower(bad, jnp.int32(0)).compile().as_text()
    assert "callback" not in txt.lower()
