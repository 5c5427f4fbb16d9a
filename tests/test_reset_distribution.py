"""Distributional equivalence of the native jax reset vs the reference's
rejection-loop reset (mirrored host-side).

The native reset replaces the pop-regardless rejection loop with one uniform
draw over currently-valid cells per placement (see ngx/core/reset.py); these
are provably the same distribution, and this test checks it empirically:
per-cell item-occupancy frequencies over many resets must agree within
Monte-Carlo tolerance.
"""

import numpy as np
import pytest

import jax

import ngx
from ngx.core.mirror import mirror_reset

POGO = "NovelGridworld-Pogostick-v1"


def occupancy(maps, item_id):
    return (maps == item_id).mean(axis=0)


def check_reset_invariants(spec, maps, agents, facing, n):
    """Shared structural invariants for any reset-state source: exact spawn
    counts, the cell+4-neighbors-air placement rule, agent in the 2-margin
    interior, uniform facing."""
    wall = spec.items.index("wall")
    tree = spec.items.index("tree_log")
    ct = spec.items.index("crafting_table")
    assert ((maps == tree).sum(axis=(1, 2)) == 5).all()
    assert ((maps == ct).sum(axis=(1, 2)) == 1).all()
    for m in maps[:200]:
        occ = m.copy()
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 0  # ignore walls
        rs, cs = np.nonzero(occ)
        for r, c in zip(rs, cs):
            assert m[r - 1, c] in (0, wall) and m[r + 1, c] in (0, wall)
            assert m[r, c - 1] in (0, wall) and m[r, c + 1] in (0, wall)
    assert agents.min() >= 2 and agents.max() <= spec.map_size - 3
    faces = np.bincount(facing, minlength=4) / n
    np.testing.assert_allclose(faces, 0.25, atol=0.03)


def test_native_reset_matches_mirror_distribution():
    spec = ngx.make_spec(POGO)
    n = 4000

    keys = jax.random.split(jax.random.key(0), n)
    native_states, _ = jax.jit(jax.vmap(ngx.make_reset(spec)))(keys)
    native_maps = np.asarray(native_states.map2d)

    rng = np.random.RandomState(0)
    mirror_maps = np.stack([
        np.asarray(mirror_reset(spec, rng).map2d) for _ in range(n)])

    tree = spec.items.index("tree_log")
    ct = spec.items.index("crafting_table")
    for item in (tree, ct):
        a = occupancy(native_maps, item)
        b = occupancy(mirror_maps, item)
        # expected per-cell freq ~ qty/36 ≈ 0.14 (tree); MC std ≈ 0.006
        np.testing.assert_allclose(a, b, atol=0.03,
                                   err_msg=f"occupancy mismatch item {item}")
        # support identical: items only inside the 2-margin interior
        assert (a[(a > 0)].size > 0)
        outside = np.ones_like(a, dtype=bool)
        outside[2:-2, 2:-2] = False
        assert a[outside].sum() == 0 and b[outside].sum() == 0

    check_reset_invariants(spec, native_maps,
                           np.asarray(native_states.agent),
                           np.asarray(native_states.facing), n)
