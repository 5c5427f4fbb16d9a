"""NGX_DEBUG=1 — in-kernel invariant asserts (the debug/sanitizer layer).

The reference has no sanitizers (single-threaded Python, SURVEY.md §5); the
engine's equivalent is jit-compatible invariant checking on the state the
kernel produces.  Off by default (zero cost — nothing is inserted into the
program); with ``NGX_DEBUG=1`` in the environment, ``make_step``/``make_reset``
append a fused invariant reduction plus ONE host callback per call that raises
``AssertionError`` naming the first violated invariant.

Checked invariants (per step and per reset):
  * inventory quantities are non-negative
  * the wall ring is intact (novelties may *replace* wall with another
    unbreakable item — e.g. firewall — so the check is ring != air, not
    ring == wall)
  * the agent is inside the playable area (not on the ring)
  * every map cell holds a valid item id in [0, n_items)
  * facing ∈ {0,1,2,3}; selected ∈ [-1, n_items)

Trace-time shape/dtype validation of the input state runs unconditionally
under the flag as well (``validate_state``).

Usage: the hooks are wired inside ``ngx.core.step.make_step`` and
``ngx.core.reset.make_reset``; user code just sets the env var.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

INVARIANTS = (
    "inventory >= 0",
    "wall ring intact (ring cells != air)",
    "agent inside playable area",
    "map cell ids in [0, n_items)",
    "facing in {0,1,2,3}",
    "selected in [-1, n_items)",
)


def enabled() -> bool:
    """Debug mode is resolved at kernel *build* time (make_step/make_reset),
    so flipping the env var affects subsequently built kernels only."""
    return os.environ.get("NGX_DEBUG", "") not in ("", "0")


def validate_state(sp, state) -> None:
    """Trace-time shape/dtype asserts on an EnvState (chex-style, free)."""
    H, I = sp.map_size, sp.n_items
    checks = (
        (state.map.shape[-1:] == (H * H,), "map shape"),
        (state.agent.shape[-1:] == (2,), "agent shape"),
        (state.inventory.shape[-1:] == (I,), "inventory shape"),
        (state.map.dtype == jnp.int32, "map dtype"),
        (state.inventory.dtype == jnp.int32, "inventory dtype"),
        (state.facing.dtype == jnp.int32, "facing dtype"),
    )
    for ok, name in checks:
        assert ok, f"NGX_DEBUG state validation failed: {name}"


def _host_assert(flags, where):
    flags = np.asarray(flags)
    if flags.all():
        return
    # batched (vmap) callbacks arrive as [B, n_invariants]
    bad = np.argwhere(~flags.reshape(-1, flags.shape[-1]))
    env_i, inv_i = (int(bad[0][0]), int(bad[0][1]))
    raise AssertionError(
        f"NGX_DEBUG: invariant violated after {where}: "
        f"{INVARIANTS[inv_i]} (env index {env_i} of the callback batch; "
        f"{len(bad)} total violations)")


def kernel_asserts(sp, state, where: str):
    """Emit the invariant reduction + host callback for ``state``.

    Only call when :func:`enabled`; the flags are a [6] bool vector so the
    on-device cost is one fused reduction, and the callback transfers 6
    bools per env per step.
    """
    H, I = sp.map_size, sp.n_items
    m = state.map
    ring = np.zeros((H, H), dtype=bool)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
    ring = jnp.asarray(ring.reshape(-1))
    r, c = state.agent[..., 0], state.agent[..., 1]
    flags = jnp.stack([
        jnp.all(state.inventory >= 0, axis=-1),
        jnp.all(jnp.where(ring, m != 0, True), axis=-1),
        (r >= 1) & (r <= H - 2) & (c >= 1) & (c <= H - 2),
        jnp.all((m >= 0) & (m < I), axis=-1),
        (state.facing >= 0) & (state.facing < 4),
        (state.selected >= -1) & (state.selected < I),
    ], axis=-1)
    jax.debug.callback(_host_assert, flags, where)
