"""Lidar as a precomputed-gather, not a ray-march.

The reference marches each beam cell-by-cell in Python until it hits a block
(``observation_wrappers.py:52-64``, ``novel_gridworld_v0_env.py:158-169``) —
O(beams × range) map probes per step.  Here we precompute, at trace time and
with the *exact same* ``np.round(cos/sin, 2)`` arithmetic, the integer cell
offsets each beam visits per facing, so the whole scan becomes one gather plus
an ``argmax`` first-hit reduction: fixed shapes, no data-dependent loops,
vmappable over thousands of envs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import spec as S

# reference direction→radian table (observation_wrappers.py:39)
_DIR_RAD = {S.NORTH: np.pi, S.SOUTH: 0.0, S.WEST: 3 * np.pi / 2, S.EAST: np.pi / 2}


def beam_offsets(num_beams: int, max_range: int, full_circle: bool) -> np.ndarray:
    """offsets[facing, beam, k, 2] — cell visited at range k+1.

    Replicates the trig of observation_wrappers.py:42-56 (360°, endpoint
    dropped) and novel_gridworld_v0_env.py:146-162 (180°, endpoints kept),
    including the double rounding, so hit distances match the reference
    bit-for-bit.
    """
    out = np.zeros((4, num_beams, max_range, 2), dtype=np.int32)
    for f in range(4):
        rad = _DIR_RAD[f]
        if full_circle:
            angles = np.linspace(rad - np.pi, rad + np.pi, num_beams + 1)[:-1]
        else:
            angles = np.linspace(rad - np.pi / 2, rad + np.pi / 2, num_beams)
        for b, angle in enumerate(angles):
            x_ratio = np.round(np.cos(angle), 2)
            y_ratio = np.round(np.sin(angle), 2)
            for k in range(1, max_range + 1):
                out[f, b, k - 1, 0] = int(np.round(k * x_ratio))
                out[f, b, k - 1, 1] = int(np.round(k * y_ratio))
    return out


def make_lidar_fn(sp: S.EnvSpec):
    """Build ``lidar(map, agent, facing) -> int32[B * n_slots]`` for a legacy
    core observation (OBS_LIDAR_V0 / OBS_LIDAR_INV)."""
    H = sp.map_size
    if sp.obs_mode == S.OBS_LIDAR_V0:
        # novel_gridworld_v0_env.py:52-57 — 5 beams, 180°, per-item fill.
        # The fill value is max_beam_range FROZEN at construction (:54);
        # reset(map_size=N) keeps the original (spec.lidar_max_range).
        num_beams = sp.lidar_num_beams
        max_range = sp.lidar_max_range
        # unbounded while-loop in the reference; wall ring guarantees a hit
        # within the map diameter, so 2*H steps always suffice
        table = beam_offsets(num_beams, 2 * H, full_circle=False)
        n_slots = sp.n_items - 1           # ids 1..I-1 (air excluded)
        slot_of_item = np.arange(sp.n_items, dtype=np.int32) - 1
        fill = max_range
    elif sp.obs_mode == S.OBS_LIDAR_FRONT:
        # observation_wrappers.py:32-68 — 360°, items-{air,goal}, bounded range
        # = hypotenuse of the interior square, 0-fill.  The item subset is the
        # wrap-time snapshot stored by ngx.transforms.lidar_in_front (items a
        # novelty appends afterwards don't get beams, matching the reference
        # wrapper whose lidar_items freeze at construction).  max_beam_range
        # is likewise frozen at wrap time (observation_wrappers.py:25) and
        # carried in spec.lidar_max_range — not recomputed from map_size.
        num_beams = sp.lidar_num_beams
        max_range = sp.lidar_max_range
        table = beam_offsets(num_beams, max_range, full_circle=True)
        lidar_sorted = sorted(sp.lidar_items)
        n_slots = len(lidar_sorted)
        slot_of_item = np.full((sp.n_items,), -1, dtype=np.int32)
        for i, name in enumerate(sp.items):
            if name in lidar_sorted:
                slot_of_item[i] = lidar_sorted.index(name)
        fill = 0
    else:
        # novel_gridworld_v1_env.py:139-175 — 8 beams, 360°, item subset, 0-fill
        num_beams = sp.lidar_num_beams
        max_range = sp.lidar_max_range
        table = beam_offsets(num_beams, max_range, full_circle=True)
        n_slots = len(sp.lidar_items)
        # lidar ids assigned alphabetically from 1 (set_items_id on the subset)
        lidar_sorted = sorted(sp.lidar_items)
        slot_of_item = np.full((sp.n_items,), -1, dtype=np.int32)
        for i, name in enumerate(sp.items):
            if name in lidar_sorted:
                slot_of_item[i] = lidar_sorted.index(name)
        fill = 0

    def lidar(m, agent, facing):
        # host tables embedded as constants at trace time; ``m`` is the FLAT
        # int32[H*W] map (see EnvState.map) so the beam probe is one 1-D gather
        table_j = jnp.asarray(table)
        slots_j = jnp.asarray(slot_of_item)
        off = table_j[facing]                          # [B, D, 2]
        rr = jnp.clip(agent[0] + off[..., 0], 0, H - 1)
        cc = jnp.clip(agent[1] + off[..., 1], 0, H - 1)
        vals = m[rr * H + cc]                          # [B, D]
        hit = vals != 0
        first = jnp.argmax(hit, axis=1)                # first hit index
        has = jnp.any(hit, axis=1)
        dist = (first + 1).astype(jnp.int32)
        hv = jnp.take_along_axis(vals, first[:, None], axis=1)[:, 0]
        slot = slots_j[hv]                             # [B]
        cols = jnp.arange(n_slots, dtype=jnp.int32)
        sig = jnp.where(
            has[:, None] & (slot[:, None] == cols[None, :]) & (slot[:, None] >= 0),
            dist[:, None],
            jnp.int32(fill),
        )
        return sig.reshape(-1)

    lidar.n_slots = n_slots
    lidar.num_beams = num_beams
    return lidar
