"""EnvState — the dynamic environment state as a JAX pytree.

Mirrors the mutable attributes of the reference env classes
(``pogostick_v1_env.py:26-84``) with fixed-shape arrays so the whole state
batches under ``vmap`` and shards over a device mesh along the env axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field is a leaf,
    flattened in declaration order), with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])


@_pytree_dataclass
class StepInfo:
    """Device-side encoding of the reference ``info`` dict
    (pogostick_v1_env.py:359). Strings live host-side; see ngx.compat."""

    result: jnp.ndarray      # bool — action succeeded
    step_cost: jnp.ndarray   # float32 — simulated Minecraft time economy
    msg_code: jnp.ndarray    # int32 — MSG_* constant
    msg_arg: jnp.ndarray     # int32 — item id / recipe idx parameter


@_pytree_dataclass
class EnvState:
    # The map is stored FLAT, row-major int32[H*W] (use ``.map2d`` for the
    # [H, W] view): every map-wide op in the step kernel is then a plain
    # [B, H*W] elementwise pass with no small trailing dimension.
    map: jnp.ndarray         # int32[H*W], row-major; 0 == air
    agent: jnp.ndarray       # int32[2] (row, col)
    facing: jnp.ndarray      # int32 — NORTH/SOUTH/WEST/EAST = 0/1/2/3
    inventory: jnp.ndarray   # int32[I]
    selected: jnp.ndarray    # int32 item id; -1 == '' (nothing selected)
    step_count: jnp.ndarray  # int32
    last_action: jnp.ndarray  # int32 action id
    last_reward: jnp.ndarray  # float32
    last_cost: jnp.ndarray    # float32
    last_done: jnp.ndarray    # bool

    @property
    def map2d(self) -> jnp.ndarray:
        """[..., H, W] view of the flat map (works on batched states too)."""
        H = int(np.sqrt(self.map.shape[-1]))
        return self.map.reshape(self.map.shape[:-1] + (H, H))


def zeros_state(spec) -> EnvState:
    """Blank state (pre-reset) with the right shapes for ``spec``."""
    H = spec.map_size
    return EnvState(
        map=jnp.zeros((H * H,), dtype=jnp.int32),
        agent=jnp.array([1, 1], dtype=jnp.int32),
        facing=jnp.array(0, dtype=jnp.int32),
        inventory=jnp.zeros((spec.n_items,), dtype=jnp.int32),
        selected=jnp.array(-1, dtype=jnp.int32),
        step_count=jnp.array(0, dtype=jnp.int32),
        last_action=jnp.array(0, dtype=jnp.int32),
        last_reward=jnp.array(0.0, dtype=jnp.float32),
        last_cost=jnp.array(0.0, dtype=jnp.float32),
        last_done=jnp.array(False),
    )


def state_from_numpy(spec, map_arr, agent, facing, inventory, selected=-1,
                     step_count=0, last_action=0, last_reward=0.0,
                     last_cost=0.0, last_done=False) -> EnvState:
    """Build an EnvState from host values (e.g. a reference-env snapshot,
    for the conformance harness / restore-chaining)."""
    return EnvState(
        map=jnp.asarray(np.asarray(map_arr).reshape(-1), dtype=jnp.int32),
        agent=jnp.asarray(np.asarray(agent), dtype=jnp.int32),
        facing=jnp.asarray(facing, dtype=jnp.int32),
        inventory=jnp.asarray(np.asarray(inventory), dtype=jnp.int32),
        selected=jnp.asarray(selected, dtype=jnp.int32),
        step_count=jnp.asarray(step_count, dtype=jnp.int32),
        last_action=jnp.asarray(last_action, dtype=jnp.int32),
        last_reward=jnp.asarray(last_reward, dtype=jnp.float32),
        last_cost=jnp.asarray(last_cost, dtype=jnp.float32),
        last_done=jnp.asarray(last_done, dtype=bool),
    )


def make_state_packers(spec):
    """Lossless bit-packing of a BATCHED EnvState into a compact int32
    carry — the HBM-bytes lever for scan-carried rollouts.

    Whether it pays depends on the regime: it trades carry bytes for
    shift/mask work per step, so it can help where the rollout is
    carry-bound and cost where it is compute-bound (``bench.py`` runs both
    forms at the headline batch).  Layout (per env):

    * map: 6 cells x 5 bits per word (item ids < 32 — ``max_items=20``
      bounds the reference id space, pogostick_v1_env.py:75) —
      ceil(H*W/6) words;
    * inventory: 2 counts x 15 bits per word — exact while every count
      stays < 32,768 (any bench/training rollout: counts grow at most ~2
      per step);
    * scalars: agent row/col (5+5), facing (2), selected+1 (6),
      last_action (6), last_done (1) in one word; step_count its own word;
    * last_reward / last_cost: float32 bit-cast, one word each.

    Returns ``(pack, unpack, n_words)`` with ``pack(state[B]) ->
    int32[B, n_words]`` and ``unpack(packed) -> EnvState[B]``;
    ``unpack(pack(s)) == s`` exactly (tests/test_vector.py).
    """
    H = spec.map_size
    HW = H * H
    I = spec.n_items
    assert I <= 31, "5-bit map cells need item ids < 32"
    assert H <= 32, "5-bit agent coordinates need map_size <= 32"
    assert spec.n_actions <= 63, "6-bit last_action needs < 64 actions"
    MAP_W = -(-HW // 6)
    INV_W = -(-I // 2)
    n_words = MAP_W + INV_W + 4     # + scalars, step_count, 2 floats

    map_pad = MAP_W * 6 - HW
    inv_pad = INV_W * 2 - I
    shifts5 = jnp.asarray(np.arange(6, dtype=np.int32) * 5)

    def pack(st: EnvState) -> jnp.ndarray:
        B = st.map.shape[0]
        m = jnp.pad(st.map, ((0, 0), (0, map_pad))).reshape(B, MAP_W, 6)
        mw = jnp.sum(m << shifts5[None, None, :], axis=-1)
        inv = jnp.pad(st.inventory, ((0, 0), (0, inv_pad))).reshape(
            B, INV_W, 2)
        iw = inv[:, :, 0] | (inv[:, :, 1] << 15)
        sc = (st.agent[:, 0] | (st.agent[:, 1] << 5) | (st.facing << 10)
              | ((st.selected + 1) << 12) | (st.last_action << 18)
              | (jnp.where(st.last_done, 1, 0) << 24))
        fl = jnp.stack(
            [jax.lax.bitcast_convert_type(st.last_reward, jnp.int32),
             jax.lax.bitcast_convert_type(st.last_cost, jnp.int32)],
            axis=-1)
        return jnp.concatenate(
            [mw, iw, sc[:, None], st.step_count[:, None], fl], axis=-1)

    def unpack(p: jnp.ndarray) -> EnvState:
        B = p.shape[0]
        mw = p[:, :MAP_W]
        m = ((mw[:, :, None] >> shifts5[None, None, :]) & 31).reshape(
            B, MAP_W * 6)[:, :HW]
        iw = p[:, MAP_W:MAP_W + INV_W]
        inv = jnp.stack([iw & 0x7FFF, (iw >> 15) & 0x7FFF],
                        axis=-1).reshape(B, INV_W * 2)[:, :I]
        sc = p[:, MAP_W + INV_W]
        cnt = p[:, MAP_W + INV_W + 1]
        lr = jax.lax.bitcast_convert_type(p[:, MAP_W + INV_W + 2],
                                          jnp.float32)
        lc = jax.lax.bitcast_convert_type(p[:, MAP_W + INV_W + 3],
                                          jnp.float32)
        return EnvState(
            map=m,
            agent=jnp.stack([sc & 31, (sc >> 5) & 31], axis=-1),
            facing=(sc >> 10) & 3,
            inventory=inv,
            selected=((sc >> 12) & 63) - 1,
            step_count=cnt,
            last_action=(sc >> 18) & 63,
            last_reward=lr,
            last_cost=lc,
            last_done=((sc >> 24) & 1) != 0,
        )

    return pack, unpack, n_words

