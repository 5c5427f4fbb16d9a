"""The fused, branchless step kernel.

One compiled function implements the step semantics of *all* reference
environments and novelty wrappers, driven entirely by :class:`ngx.core.spec.EnvSpec`
tables.  The reference dispatches through a Python if/elif chain per action
(``pogostick_v1_env.py:230-367``) and novelty wrappers re-implement whole
Break/Craft paths inline (``novelty_wrappers.py:37-114``); here every op class
is evaluated as masked arithmetic and combined with ``jnp.where`` selects so
the kernel is a single straight-line XLA program — no per-env control-flow
divergence under ``vmap``, so 8k+ environments step in lockstep.

Layout notes:
- All map cell reads/writes are ONE-HOT masked ops (mask-select-reduce /
  mask-select-write) instead of gathers/scatters: with per-env dynamic
  indices, XLA lowers ``m[fr, fc]`` under vmap to a gather and ``.at[].set``
  to a scatter; the masked forms are element-wise work over the batched map.
- The map lives FLAT (int32[H*W]), so batched kernels work on [B, H*W]
  arrays.  Neighbor reads are bounds-checked one-hot reads of the flat map,
  never clamped dynamic indices.
- Small per-action/per-item/per-recipe table lookups use one-hot contractions
  for the same reason.
- Op families absent from the spec's action table (chop/jump/fused/extract/…)
  are gated out statically, so each env config compiles exactly the code it
  needs.

Semantics are cited per-op to the reference implementation and verified
bit-exactly by the conformance suites in ``tests/``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import spec as S
from .state import EnvState, StepInfo
from ..utils import debug


def _goal_check(sp: S.EnvSpec, inv, front_after):
    """Termination predicate evaluated at the tail of every step
    (pogostick_v1_env.py:354-357, novel_gridworld_v0_env.py:236-239)."""
    if sp.goal_mode == S.GOAL_FRONT_ITEM:
        return front_after == sp.goal_front_item
    counts = jnp.asarray(np.asarray(sp.goal_counts, np.int32))
    active = counts > 0
    ge = inv >= counts
    if sp.goal_any:
        return jnp.any(ge & active)
    return jnp.all(ge | ~active)


def make_step(sp: S.EnvSpec, with_obs: bool = True):
    """Compile a pure ``step(state, action) -> (state, obs, reward, done, info)``
    for one spec.  All spec tables become XLA constants embedded from host
    numpy at trace time.

    ``with_obs=False`` returns ``obs=None`` — for throughput rollouts, where
    the obs is unused."""

    I = sp.n_items
    H = sp.map_size
    A = sp.n_actions

    action_op = np.asarray(sp.action_op, dtype=np.int32)
    action_arg = np.asarray(sp.action_arg, dtype=np.int32)
    cost_ok = np.asarray(sp.action_cost_success, dtype=np.float32)
    cost_fail = np.asarray(sp.action_cost_fail, dtype=np.float32)
    unbreakable = np.asarray(sp.unbreakable, dtype=np.int32)
    break_reward = np.asarray(sp.break_reward, dtype=np.float32)
    break_yield = np.asarray(sp.break_yield, dtype=np.int32)
    entity_mask = np.asarray(sp.entity_mask, dtype=np.int32)

    R = max(sp.n_recipes, 1)
    recipes_in = np.asarray(
        sp.recipes_in if sp.n_recipes else np.zeros((1, I), np.int32), dtype=np.int32)
    recipes_out = np.asarray(
        sp.recipes_out if sp.n_recipes else np.zeros((1, I), np.int32), dtype=np.int32)
    recipe_multi = np.asarray(
        sp.recipe_multi if sp.n_recipes else np.zeros((1,), bool),
        dtype=np.int32)
    ccost_ok = np.asarray(
        sp.craft_cost_success if sp.n_recipes else np.zeros((1,), np.float32), dtype=np.float32)
    ccost_missing = np.asarray(
        sp.craft_cost_missing if sp.n_recipes else np.zeros((1,), np.float32), dtype=np.float32)
    ccost_notable = np.asarray(
        sp.craft_cost_no_table if sp.n_recipes else np.zeros((1,), np.float32), dtype=np.float32)
    deadend_recipes = np.asarray(
        sp.deadend_recipes if sp.n_recipes else np.zeros((1,), bool),
        dtype=np.int32)

    crate_contents = np.asarray(
        sp.crate_contents if sp.crate_contents is not None else np.zeros((I,), np.int32),
        dtype=np.int32)

    # static op-presence flags — compile only the families this spec uses
    ops = set(action_op.tolist())
    HAS_FWD = S.OP_FORWARD in ops
    HAS_TURN = S.OP_LEFT in ops or S.OP_RIGHT in ops
    HAS_BREAK = S.OP_BREAK in ops
    HAS_PLACE = S.OP_PLACE in ops
    HAS_EXR = S.OP_EXTRACT_RUBBER in ops
    HAS_EXS = S.OP_EXTRACT_STRING in ops
    HAS_CRAFT = S.OP_CRAFT in ops
    HAS_SELECT = S.OP_SELECT in ops
    HAS_FUSED = S.OP_FUSED_PLACE_EXTRACT in ops
    HAS_CHOP = S.OP_CHOP in ops
    HAS_JUMP = S.OP_JUMP in ops
    NEEDS_NEXT_TO_TREE = HAS_PLACE or HAS_EXR or HAS_FUSED

    # legacy craft-nag recipe/item indices (novel_gridworld_v2_env.py:313-323,
    # novel_gridworld_v4_env.py:398-405)
    stick_r = sp.recipe_names.index("stick") if "stick" in sp.recipe_names else -1
    tap_r = sp.recipe_names.index("tree_tap") if "tree_tap" in sp.recipe_names else -1
    plank_i = sp.items.index("plank") if "plank" in sp.items else 0
    stick_i = sp.items.index("stick") if "stick" in sp.items else 0
    tap_i = sp.items.index("tree_tap") if "tree_tap" in sp.items else 0
    rubber_i = sp.items.index("rubber") if "rubber" in sp.items else 0

    from ..ops.rays import make_lidar_fn  # local import to avoid cycles
    lidar_fn = (make_lidar_fn(sp)
                if sp.obs_mode not in (S.OBS_DICT, S.OBS_AGENT_MAP) else None)

    def get_obs(state: EnvState):
        if sp.obs_mode == S.OBS_DICT:
            # pogostick_v1_env.py:214-228 — raw-state dict
            return {
                "map": state.map.reshape(H, H),
                "agent_location": state.agent,
                "agent_facing_id": state.facing,
                "inventory_items_quantity": state.inventory,
            }
        if sp.obs_mode == S.OBS_AGENT_MAP:
            # observation_wrappers.py:102-129 — 11x11 window centred on the
            # agent (extend=5, zero-padded)
            ext = 5
            padded = jnp.pad(state.map.reshape(H, H), ext)
            win = jax.lax.dynamic_slice(
                padded, (state.agent[0], state.agent[1]),
                (2 * ext + 1, 2 * ext + 1))
            return {
                "agent_map": win,
                "agent_facing_id": state.facing,
                "inventory_items_quantity": state.inventory,
            }
        lidar = lidar_fn(state.map, state.agent, state.facing)
        if sp.obs_mode == S.OBS_LIDAR_V0:
            return lidar
        if sp.obs_mode == S.OBS_LIDAR_FRONT:
            # observation_wrappers.py:70-80 — lidar + inventory over
            # name-sorted items minus unbreakables (the reference reads the
            # live inventory dict in sorted order, so novelty-appended item
            # ids interleave alphabetically)
            keep = [i for _, i in sorted((n, i) for i, n in enumerate(sp.items))
                    if not sp.unbreakable[i]]
            return jnp.concatenate([lidar, state.inventory[jnp.asarray(keep)]])
        # novel_gridworld_v1_env.py:194-204 — lidar + name-sorted inventory
        keep = [i for _, i in sorted((n, i) for i, n in enumerate(sp.items))
                if i != 0]
        return jnp.concatenate([lidar, state.inventory[jnp.asarray(keep)]])

    # ---------------- one-hot / mask helpers (see module docstring) --------
    # The map is FLAT int32[H*W] (see EnvState.map): one-hot cell masks are
    # 1-D, so the whole batched kernel runs on [B, H*W] arrays.
    HW = H * H

    def cell_mask(r, c):
        """[H*W] bool one-hot of (r, c); all-false when out of range (the
        bounds predicate also kills flat-index aliasing, e.g. (1,-1)≡(0,W-1)).
        The out-of-range case folds into the compared index (-1 never matches
        the iota) instead of AND-ing a scalar bool."""
        inb = (r >= 0) & (r < H) & (c >= 0) & (c < H)
        return jnp.asarray(IOTA_HW) == jnp.where(inb, r * H + c, -1)

    def mread(m, mask):
        """Value of the (single) masked cell; 0 (air) if mask is empty."""
        return jnp.sum(jnp.where(mask, m, 0))

    def read_at(m, r, c):
        """m[r, c], 0 (air) when out of range."""
        return mread(m, cell_mask(r, c))

    def t1(table_np, oh, dtype):
        """One-hot read of a 1-D table."""
        t = jnp.asarray(table_np)
        return jnp.sum(jnp.where(oh, t, jnp.zeros((), dtype)))

    # Mixed-rank boolean helpers: `vec_bool & scalar_bool` and
    # `where(scalar_bool, vec, vec)` with the broadcast routed through an
    # int32 0/1 — semantics identical (XLA folds it right back).
    def sb(scalar_bool):
        """int32 0/1 of a scalar bool."""
        return jnp.where(scalar_bool, 1, 0)

    def vand(vec_bool, scalar_bool):
        """vec_bool & scalar_bool without an i1 rank expansion."""
        return (jnp.where(vec_bool, 1, 0) * sb(scalar_bool)) > 0

    def vsel(scalar_bool, a, b):
        """where(scalar_bool, a, b) for int vectors, i1-reshape-free."""
        d = sb(scalar_bool)
        return a * d + b * (1 - d)

    # np-backed index literals, embedded as constants at trace time.
    IOTA_HW = np.arange(HW, dtype=np.int32)
    IOTA_A = np.arange(A, dtype=np.int32)
    IOTA_I = np.arange(I, dtype=np.int32)
    IOTA_R = np.arange(R, dtype=np.int32)
    IOTA_4 = np.arange(4, dtype=np.int32)

    def step(state: EnvState, action):
        action = jnp.asarray(action, dtype=jnp.int32)
        oh_a = action == jnp.asarray(IOTA_A)                 # [A]
        op = t1(action_op, oh_a, jnp.int32)
        arg = t1(action_arg, oh_a, jnp.int32)
        oh_argI = arg == jnp.asarray(IOTA_I)                 # [I] (item-typed args)

        m = state.map
        r, c = state.agent[0], state.agent[1]
        inv = state.inventory
        facing = state.facing
        oh_f = facing == jnp.asarray(IOTA_4)                 # [4]

        dr = t1(S.FACING_DELTAS[:, 0], oh_f, jnp.int32)
        dc = t1(S.FACING_DELTAS[:, 1], oh_f, jnp.int32)
        fr, fc = r + dr, c + dc
        front_m = cell_mask(fr, fc)
        front = mread(m, front_m)
        oh_frontI = front == jnp.asarray(IOTA_I)             # [I]

        # ---------------- Forward / turns (pogostick_v1_env.py:244-279) ----
        is_fwd = (op == S.OP_FORWARD) if HAS_FWD else jnp.asarray(False)
        fwd_ok = front == 0
        new_agent = vsel(is_fwd & fwd_ok, jnp.stack([fr, fc]), state.agent)

        if HAS_TURN:
            is_left = op == S.OP_LEFT
            is_right = op == S.OP_RIGHT
            new_facing = jnp.where(
                is_left, t1(S.TURN_LEFT, oh_f, jnp.int32),
                jnp.where(is_right, t1(S.TURN_RIGHT, oh_f, jnp.int32), facing))
        else:
            new_facing = facing

        # ---------------- Jump (novelty_wrappers.py:1360-1382) -------------
        if HAS_JUMP:
            is_jump = op == S.OP_JUMP
            jr, jc = r + 2 * dr, c + 2 * dc
            j_in = (jr >= 0) & (jr <= H - 1) & (jc >= 0) & (jc <= H - 1)
            j_val = mread(m, cell_mask(jr, jc))
            jump_ok = j_in & (j_val == 0)
            new_agent = vsel(is_jump & jump_ok, jnp.stack([jr, jc]),
                             new_agent)
        else:
            is_jump = jnp.asarray(False)
            jump_ok = jnp.asarray(False)

        # ---------------- Break (+ axe / fence / crate folds) --------------
        is_break = (op == S.OP_BREAK) if HAS_BREAK else jnp.asarray(False)
        breakable = (front != 0) & ~jnp.any(
            oh_frontI & (jnp.asarray(unbreakable) > 0))

        axe_sel = jnp.asarray(False)
        if sp.axe_mode != S.AXE_NONE:
            # novelty_wrappers.py:56,67 — axe in inventory AND selected
            axe_sel = (inv[sp.axe_id] >= 1) & (state.selected == sp.axe_id)

        fence_blocked = jnp.asarray(False)
        if sp.fence_restrict == S.FENCE_MEDIUM:
            # novelty_wrappers.py:933-941 — agent's perpendicular sides fence-free
            ns = (facing == S.NORTH) | (facing == S.SOUTH)
            side_a = jnp.where(ns, read_at(m, r, c - 1), read_at(m, r - 1, c))
            side_b = jnp.where(ns, read_at(m, r, c + 1), read_at(m, r + 1, c))
            fence_blocked = (side_a == sp.fence_id) | (side_b == sp.fence_id)
        elif sp.fence_restrict == S.FENCE_HARD:
            # novelty_wrappers.py:943-949 — whole 3x3 around target fence-free
            fence_blocked = jnp.asarray(False)
            for ddr in (-1, 0, 1):
                for ddc in (-1, 0, 1):
                    fence_blocked = fence_blocked | (
                        read_at(m, fr + ddr, fc + ddc) == sp.fence_id)
        if sp.fence_restrict != S.FENCE_NONE:
            # the fence itself is always breakable (novelty_wrappers.py:928-930)
            fence_blocked = fence_blocked & (front != sp.fence_id)

        if sp.axe_mode == S.AXE_REQUIRED:
            break_ok = breakable & ~fence_blocked & axe_sel
        else:
            break_ok = breakable & ~fence_blocked

        if sp.axe_mode != S.AXE_NONE:
            # axe overrides: +10 with axe on ANY breakable; reward stays -1
            # without axe even for bonus items; the cost discount applies only
            # on a successful axe break (novelty_wrappers.py:45-84)
            brk_reward = jnp.where(axe_sel, sp.reward_intermediate, sp.reward_step)
            byield = jnp.where(axe_sel & sp.axe_breakincrease, 2, 1)
            brk_cost = jnp.where(axe_sel & break_ok,
                                 sp.break_cost * sp.axe_cost_mult,
                                 jnp.float32(sp.break_cost))
        else:
            brk_reward = t1(break_reward, oh_frontI, jnp.float32)
            byield = t1(break_yield, oh_frontI, jnp.int32)
            brk_cost = jnp.float32(sp.break_cost)

        # Crate novelty adds contents whenever Break targets a crate, before
        # the inner break resolves (novelty_wrappers.py:1085-1088).
        crate_add = (is_break & (front == sp.crate_id)
                     if sp.crate_id >= 0 else jnp.asarray(False))

        fence_active = sp.fence_restrict != S.FENCE_NONE

        # ---------------- Chop (novelty_wrappers.py:1288-1307) -------------
        is_chop = (op == S.OP_CHOP) if HAS_CHOP else jnp.asarray(False)
        chop_ok = breakable

        # neighbors of the front cell (is_block_in_front_next_to,
        # pogostick_v1_env.py:391-411) — bounds-checked one-hot reads
        if NEEDS_NEXT_TO_TREE:
            adj = sp.place_adjacent_item
            next_to_tree = (
                (read_at(m, fr - 1, fc) == adj)
                | (read_at(m, fr + 1, fc) == adj)
                | (read_at(m, fr, fc - 1) == adj)
                | (read_at(m, fr, fc + 1) == adj))
        else:
            next_to_tree = jnp.asarray(False)

        # ---------------- Place (pogostick_v1_env.py:295-314) --------------
        if HAS_PLACE:
            is_place = op == S.OP_PLACE
            have_place = jnp.sum(jnp.where(oh_argI, inv, 0)) >= 1
            place_ok = have_place & (front == 0)
        else:
            is_place = jnp.asarray(False)
            have_place = jnp.asarray(False)
            place_ok = jnp.asarray(False)

        # ---------------- Extract rubber (pogostick_v1_env.py:315-331) -----
        if HAS_EXR:
            is_exr = op == S.OP_EXTRACT_RUBBER
            exr_at_tap = front == sp.extract_source_item
            exr_ok = exr_at_tap & next_to_tree
        else:
            is_exr = jnp.asarray(False)
            exr_at_tap = jnp.asarray(False)
            exr_ok = jnp.asarray(False)

        # ---------------- Extract string (bow_v0_env.py:293-304) -----------
        if HAS_EXS:
            is_exs = op == S.OP_EXTRACT_STRING
            exs_ok = front == sp.extract_source_item
        else:
            is_exs = jnp.asarray(False)
            exs_ok = jnp.asarray(False)

        # ---------------- Fused place+extract (v4:277-305, v5:291-319) -----
        if HAS_FUSED:
            is_fused = op == S.OP_FUSED_PLACE_EXTRACT
            taps_on_map = jnp.sum(m == tap_i)
            fused_place = ((taps_on_map == 0) & (inv[tap_i] >= 1)
                           & next_to_tree & (front == 0))
            fused_extract = (taps_on_map == 1) & next_to_tree & (front == tap_i)
        else:
            is_fused = jnp.asarray(False)
            fused_place = jnp.asarray(False)
            fused_extract = jnp.asarray(False)

        # ---------------- Craft (pogostick_v1_env.py:413-474 + legacy) -----
        if HAS_CRAFT:
            is_craft = op == S.OP_CRAFT
            rec = jnp.clip(arg, 0, R - 1)
            oh_rec = rec == jnp.asarray(IOTA_R)              # [R]
            oh_rec_i = jnp.where(oh_rec, 1, 0)         # [R] int32
            need = jnp.sum(jnp.asarray(recipes_in) * oh_rec_i[:, None],
                           axis=0)                     # [I]
            rec_out = jnp.sum(jnp.asarray(recipes_out) * oh_rec_i[:, None],
                              axis=0)
            have_all = jnp.all(inv >= need)
            multi = jnp.any(oh_rec & (jnp.asarray(recipe_multi) > 0))
            at_table = front == sp.crafting_table_id
            if sp.craft_variant == S.CRAFT_MODERN:
                craft_missing = ~have_all
                craft_notable = have_all & multi & ~at_table
            elif sp.craft_variant == S.CRAFT_LEGACY_TABLE_FIRST:
                craft_notable = multi & ~at_table
                craft_missing = ~craft_notable & ~have_all
            else:  # CRAFT_LEGACY_NO_TABLE (v2)
                craft_notable = jnp.asarray(False)
                craft_missing = ~have_all
            craft_ok = ~craft_missing & ~craft_notable

            if sp.craft_nag == S.NAG_V2:
                # plank checked AFTER consumption (novel_gridworld_v2_env.py:306-323)
                plank_after = inv[plank_i] + rec_out[plank_i] - need[plank_i]
                nag = (rec == stick_r) & (plank_after < 8)
            elif sp.craft_nag == S.NAG_V4:
                nag = ((rec == stick_r) & (inv[plank_i] < 8)) | \
                      ((rec == tap_r) & (inv[stick_i] < 8))
            else:
                nag = jnp.asarray(False)
            craft_reward = jnp.where(craft_ok,
                                     jnp.where(nag, sp.reward_step,
                                               jnp.float32(sp.craft_success_reward)),
                                     sp.reward_step)
        else:
            is_craft = jnp.asarray(False)
            rec = jnp.int32(0)
            oh_rec = jnp.zeros((R,), bool)
            need = jnp.zeros((I,), jnp.int32)
            rec_out = jnp.zeros((I,), jnp.int32)
            craft_missing = jnp.asarray(False)
            craft_notable = jnp.asarray(False)
            craft_ok = jnp.asarray(False)
            craft_reward = jnp.float32(sp.reward_step)

        # ---------------- Select (pogostick_v1_env.py:338-347) -------------
        if HAS_SELECT:
            is_select = op == S.OP_SELECT
            sel_ok = jnp.sum(jnp.where(oh_argI, inv, 0)) >= 1
            new_selected = jnp.where(is_select & sel_ok, arg, state.selected)
        else:
            is_select = jnp.asarray(False)
            sel_ok = jnp.asarray(False)
            new_selected = state.selected

        # ================= consolidate map write (all ops write front) =====
        write_break = (is_break & break_ok) | (is_chop & chop_ok) | (is_exs & exs_ok)
        write_place = (is_place & place_ok) | (is_fused & fused_place)
        front_new = jnp.where(write_break, 0,
                              jnp.where(write_place,
                                        jnp.where(is_fused, tap_i, arg), front))
        new_map = jnp.where(vand(front_m, write_break | write_place),
                            front_new, m)

        # ================= consolidate inventory ===========================
        gain_break = jnp.where(is_break & break_ok, byield,
                               jnp.where(is_chop & chop_ok, 2, 0))
        inv_delta = jnp.where(oh_frontI, gain_break, 0)
        if sp.crate_id >= 0:
            inv_delta = inv_delta + jnp.asarray(crate_contents) * sb(crate_add)
        if HAS_PLACE:
            inv_delta = inv_delta - jnp.where(oh_argI,
                                              sb(is_place & place_ok), 0)
        if HAS_EXR or HAS_FUSED:
            oh_rubber = jnp.asarray(IOTA_I) == rubber_i
            inv_delta = inv_delta + jnp.where(
                oh_rubber,
                jnp.where(is_exr & exr_ok, sp.extract_amount, 0)
                + jnp.where(is_fused & (fused_place | fused_extract), 1, 0), 0)
        if HAS_EXS and sp.extract_yield_item >= 0 and sp.extract_source_item >= 0:
            oh_yield = jnp.asarray(IOTA_I) == sp.extract_yield_item
            inv_delta = inv_delta + jnp.where(
                oh_yield, sb(is_exs & exs_ok) * sp.extract_amount, 0)
        if HAS_FUSED:
            oh_tap = jnp.asarray(IOTA_I) == tap_i
            inv_delta = inv_delta - jnp.where(oh_tap,
                                              sb(is_fused & fused_place), 0)
        if HAS_CRAFT:
            inv_delta = inv_delta + (rec_out - need) * sb(is_craft & craft_ok)
        new_inv = inv + inv_delta

        # ================= reward / result / cost / message ================
        reward = jnp.float32(sp.reward_step)
        result = jnp.asarray(True)
        msg = jnp.int32(S.MSG_NONE)
        msg_arg = jnp.int32(0)

        def sel(cond, a, b):
            return jnp.where(cond, a, b)

        # forward / jump failures
        result = result & ~(is_fwd & ~fwd_ok)
        msg = sel((is_fwd & ~fwd_ok) | (is_jump & ~jump_ok), S.MSG_BLOCK_IN_PATH, msg)
        result = result & ~(is_jump & ~jump_ok)

        # break
        reward = sel(is_break & break_ok, brk_reward, reward)
        result = result & ~(is_break & ~break_ok)
        msg = sel(is_break & ~breakable, S.MSG_CANNOT_BREAK, msg)
        msg_arg = sel(is_break & ~breakable, front, msg_arg)
        if sp.fence_restrict != S.FENCE_NONE:
            fb = is_break & breakable & fence_blocked
            msg = sel(fb, S.MSG_FENCE_RESTRICTION, msg)
        if sp.axe_mode == S.AXE_REQUIRED:
            nb = is_break & breakable & ~fence_blocked & ~axe_sel
            msg = sel(nb, S.MSG_NEED_AXE, msg)
            msg_arg = sel(nb, sp.axe_id, msg_arg)

        # chop
        if HAS_CHOP:
            reward = sel(is_chop & chop_ok, jnp.float32(sp.reward_intermediate), reward)
            result = result & ~(is_chop & ~chop_ok)
            msg = sel(is_chop & ~chop_ok, S.MSG_CANNOT_CHOP, msg)
            msg_arg = sel(is_chop & ~chop_ok, front, msg_arg)

        # place
        if HAS_PLACE:
            reward = sel(is_place & place_ok & next_to_tree,
                         jnp.float32(sp.reward_intermediate), reward)
            result = result & ~(is_place & ~place_ok)
            msg = sel(is_place & place_ok, S.MSG_TAP_PLACED, msg)
            msg = sel(is_place & have_place & (front != 0), S.MSG_BLOCK_EXISTS, msg)
            msg_arg = sel(is_place & have_place & (front != 0), front, msg_arg)
            msg = sel(is_place & ~have_place, S.MSG_ITEM_NOT_FOUND, msg)

        # extract rubber
        if HAS_EXR:
            reward = sel(is_exr & exr_ok, jnp.float32(sp.reward_intermediate), reward)
            result = result & ~(is_exr & ~exr_ok)
            msg = sel(is_exr & exr_at_tap & ~next_to_tree, S.MSG_NO_TREE_NEAR_TAP, msg)
            msg = sel(is_exr & ~exr_at_tap, S.MSG_NO_TAP, msg)

        # extract string
        if HAS_EXS:
            reward = sel(is_exs & exs_ok, jnp.float32(sp.reward_intermediate), reward)
            result = result & ~(is_exs & ~exs_ok)
            msg = sel(is_exs & ~exs_ok, S.MSG_NO_WOOL, msg)

        # craft
        if HAS_CRAFT:
            reward = sel(is_craft, craft_reward, reward)
            result = result & ~(is_craft & ~craft_ok)
            msg = sel(is_craft & craft_missing, S.MSG_MISSING_ITEMS, msg)
            msg = sel(is_craft & craft_notable, S.MSG_NEED_TABLE, msg)
            msg = sel(is_craft & craft_ok, S.MSG_CRAFTED, msg)
            msg_arg = sel(is_craft, rec, msg_arg)

        # fused place+extract (v4:291-303) — rewards 20 / 15
        if HAS_FUSED:
            reward = sel(is_fused & fused_place, 20.0, reward)
            reward = sel(is_fused & fused_extract, 15.0, reward)

        # select
        if HAS_SELECT:
            result = result & ~(is_select & ~sel_ok)
            msg = sel(is_select & ~sel_ok, S.MSG_ITEM_NOT_FOUND, msg)

        # step costs (zero for legacy envs — their tables are all 0)
        cost = jnp.where(result, t1(cost_ok, oh_a, jnp.float32),
                         t1(cost_fail, oh_a, jnp.float32))
        if HAS_BREAK:
            cost = sel(is_break, brk_cost, cost)
        if HAS_CRAFT and sp.n_recipes:
            craft_cost = jnp.where(
                craft_ok, t1(ccost_ok, oh_rec, jnp.float32),
                jnp.where(craft_notable, t1(ccost_notable, oh_rec, jnp.float32),
                          t1(ccost_missing, oh_rec, jnp.float32)))
            cost = sel(is_craft, craft_cost, cost)

        # FenceRestriction tail-override quirk: every DELEGATED break (front
        # breakable, not fence-gated) reports result=True / cost=3600 /
        # msg='' and step_count += 2 — even when the inner wrapper's break
        # FAILED (e.g. an axetobreak below without the axe selected: the
        # wrapper rebinds info after ``self.env.step`` and rebuilds it from
        # its own result/message, novelty_wrappers.py:930,950-984).  The
        # inner reward/mutation are kept.
        if fence_active:
            fdel = is_break & breakable & ~fence_blocked
            result = result | fdel
            msg = sel(fdel, S.MSG_NONE, msg)
            cost = sel(fdel, jnp.float32(sp.break_cost), cost)
            step_inc = jnp.where(fdel, 2, 1)
        else:
            step_inc = jnp.int32(1)

        # ================= post-step tail ==================================
        # grab_entities (pogostick_v1_env.py:538-554) — 3x3 around agent
        nr, nc = new_agent[0], new_agent[1]
        if sp.grab_entities_enabled and bool(np.asarray(sp.entity_mask).any()):
            win3 = jnp.zeros((HW,), bool)
            for ddr in (-1, 0, 1):
                for ddc in (-1, 0, 1):
                    win3 = win3 | cell_mask(nr + ddr, nc + ddc)
            map_ohI = new_map[:, None] == jnp.asarray(IOTA_I)       # [H*W, I]
            is_ent = jnp.any(map_ohI & (jnp.asarray(entity_mask) > 0),
                             axis=-1)
            grab = win3 & is_ent
            new_inv = new_inv + jnp.sum(
                jnp.where(map_ohI, jnp.where(grab, 1, 0)[:, None], 0),
                axis=0, dtype=jnp.int32)
            new_map = jnp.where(grab, 0, new_map)

        # block-in-front AFTER the action (pogostick_v1_env.py:352)
        oh_f2 = new_facing == jnp.asarray(IOTA_4)
        d2r = t1(S.FACING_DELTAS[:, 0], oh_f2, jnp.int32)
        d2c = t1(S.FACING_DELTAS[:, 1], oh_f2, jnp.int32)
        front_after = mread(new_map, cell_mask(nr + d2r, nc + d2c))

        goal_met = _goal_check(sp, new_inv, front_after)
        reward = jnp.where(goal_met, jnp.float32(sp.reward_done), reward)
        done = goal_met

        # dead-end termination (novel_gridworld_v2_env.py:263-266)
        if bool(deadend_recipes.any()):
            craftable = jnp.all(new_inv[None, :] >= jnp.asarray(recipes_in), axis=1)
            deadend = ~jnp.any(craftable
                               & (jnp.asarray(deadend_recipes) > 0))
            done = done | (~goal_met & deadend)

        # firewall death — post-everything override (novelty_wrappers.py:1171-1189)
        if sp.fire_item >= 0:
            on_fire = (
                (read_at(new_map, nr - 1, nc) == sp.fire_item)
                | (read_at(new_map, nr + 1, nc) == sp.fire_item)
                | (read_at(new_map, nr, nc - 1) == sp.fire_item)
                | (read_at(new_map, nr, nc + 1) == sp.fire_item))
            reward = jnp.where(on_fire, jnp.float32(-(int(sp.reward_done) // 2)), reward)
            done = done | on_fire
            msg = jnp.where(on_fire, S.MSG_DIED_FIREWALL, msg)

        new_state = EnvState(
            map=new_map,
            agent=new_agent,
            facing=new_facing,
            inventory=new_inv,
            selected=new_selected,
            step_count=state.step_count + step_inc,
            last_action=action,
            last_reward=reward,
            last_cost=cost,
            last_done=done,
        )
        obs = get_obs(new_state) if with_obs else None
        info = StepInfo(result=result, step_cost=cost, msg_code=msg, msg_arg=msg_arg)
        return new_state, obs, reward, done, info

    if debug.enabled():
        inner_step = step

        def step(state: EnvState, action):  # noqa: F811 — debug wrapper
            debug.validate_state(sp, state)
            out = inner_step(state, action)
            debug.kernel_asserts(sp, out[0], "step")
            return out

        step.get_obs = get_obs
        return step

    step.get_obs = get_obs
    return step
