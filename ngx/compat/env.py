"""The Gym-classic env facade (single env over the jitted kernel).

Mirrors the attribute and method surface of the reference env classes
(``pogostick_v1_env.py:26-84`` and the legacy template) so reference driver
code ports with an import change.  Resets replay the reference's exact
``np.random`` draw sequence via :mod:`ngx.core.mirror` (so a user who seeds
``np.random.seed(s)`` gets byte-identical maps); set ``reset_mode='native'``
for the jax-random reset used by the batched device path.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

import jax

from ..core import spec as S
from ..core.mirror import mirror_reset
from ..core.reset import make_reset
from ..core.state import EnvState, state_from_numpy
from ..core.step import make_step
from ..core.spec import DIRECTION_NAMES, FACING_DELTAS
from ..presets import make_spec
from .messages import decode_message
from .spaces import Box, Dict, Discrete

_KERNEL_CACHE = {}
_GET_OBS_CACHE = {}


def _kernels(spec):
    key = spec.key
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = (jax.jit(make_step(spec)),
                              jax.jit(make_reset(spec)))
    return _KERNEL_CACHE[key]


def _get_obs_fn(spec):
    """Cached un-jitted ``get_obs`` for ``spec`` — building ``make_step`` per
    observation call is pure waste for anyone driving the facade in a loop."""
    key = spec.key
    if key not in _GET_OBS_CACHE:
        _GET_OBS_CACHE[key] = make_step(spec).get_obs
    return _GET_OBS_CACHE[key]


class NGXEnv:
    """Single-environment facade with the reference's API surface."""

    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(self, spec, env: Optional["NGXEnv"] = None,
                 reset_mode: str = "mirror", seed: Optional[int] = None):
        self._spec = spec
        self.env = env              # restore-chaining (pogostick_v1_env.py:29)
        self.reset_mode = reset_mode
        self._key = jax.random.key(0 if seed is None else seed)
        self._step, self._reset = _kernels(spec)
        self._state: Optional[EnvState] = None
        self._prev_inventory = None
        self._renderer = None
        self.last_action = 0
        self.last_step_cost = 0.0
        # LimitActions state (wrappers.py:57-85): when set, the agent-visible
        # action space is Discrete(len(limited_actions_id)) and step ids are
        # translated by NAME through the full spec table — names absent from
        # the spec (e.g. a novelty action listed before its novelty is
        # injected) fail with the reference's per-step assert.
        self.limited_actions = None
        self.limited_actions_id = None
        # AddJump/AddChop set their own Discrete(len(full actions_id)) on the
        # wrapper, shadowing a LimitActions Discrete below
        # (novelty_wrappers.py:1278,1350); frozen at injection time
        self.action_space_n_override = None

    # -- identity / static tables ------------------------------------------
    @property
    def spec(self):
        return self._spec

    @property
    def env_id(self):
        return self._spec.env_id

    env_name = env_id

    @property
    def map_size(self):
        return self._spec.map_size

    @property
    def items(self):
        return set(self._spec.items) - ({"air"} if not self._modern else set())

    @property
    def _modern(self):
        return self._spec.obs_mode in (S.OBS_DICT, S.OBS_LIDAR_FRONT,
                                       S.OBS_AGENT_MAP)

    @property
    def items_id(self):
        d = self._spec.items_id
        if not self._modern:
            d = {k: v for k, v in d.items() if k != "air"}
        return d

    @property
    def actions_id(self):
        return self._spec.actions_id

    @property
    def action_str(self):
        return {i: n for i, n in enumerate(self._spec.actions)}

    @property
    def manipulation_actions_id(self):
        ops = np.asarray(self._spec.action_op)
        return {n: i for i, n in enumerate(self._spec.actions)
                if ops[i] not in (S.OP_CRAFT, S.OP_SELECT)}

    @property
    def craft_actions_id(self):
        return {n: i for i, n in enumerate(self._spec.actions)
                if n.startswith("Craft")}

    @property
    def select_actions_id(self):
        return {n: i for i, n in enumerate(self._spec.actions)
                if n.startswith("Select")}

    @property
    def recipes(self):
        sp = self._spec
        out = {}
        for r, name in enumerate(sp.recipe_names):
            out[name] = {
                "input": {it: int(sp.recipes_in[r][sp.items.index(it)])
                          for it in sp.recipe_input_order[r]},
                "output": {sp.items[i]: int(q)
                           for i, q in enumerate(sp.recipes_out[r]) if q},
            }
        return out

    @property
    def items_quantity(self):
        sp = self._spec
        return {sp.items[i]: int(q)
                for i, q in zip(sp.spawn_items, sp.spawn_qty)}

    @property
    def unbreakable_items(self):
        return {n for i, n in enumerate(self._spec.items)
                if self._spec.unbreakable[i]}

    @property
    def goal_item_to_craft(self):
        sp = self._spec
        return sp.items[sp.goal_item] if sp.goal_item >= 0 else ""

    @property
    def reward_intermediate(self):
        return self._spec.reward_intermediate

    @property
    def reward_done(self):
        return self._spec.reward_done

    @property
    def entities(self):
        return {n for i, n in enumerate(self._spec.items)
                if self._spec.entity_mask[i]}

    @property
    def action_space(self):
        if self.action_space_n_override is not None:
            return Discrete(self.action_space_n_override)
        if self.limited_actions_id is not None:
            return Discrete(len(self.limited_actions_id))
        return Discrete(self._spec.n_actions)

    @property
    def observation_space(self):
        sp = self._spec
        H = sp.map_size
        if sp.obs_mode == S.OBS_DICT:
            return Dict({"map": Box(0, 20, (H, H, 1))})
        if sp.obs_mode == S.OBS_AGENT_MAP:
            return Dict({"agent_map": Box(0, 20, (5, 5, 1))})
        obs = self.get_observation()
        return Box(np.zeros_like(obs), np.full_like(obs, 40))

    # -- dynamic state (host views of the device state) ---------------------
    def _np(self, x):
        return np.asarray(x)

    @property
    def map(self):
        H = self._spec.map_size
        return self._np(self._state.map).reshape(H, H)

    @property
    def agent_location(self):
        return tuple(int(v) for v in self._np(self._state.agent))

    @property
    def agent_facing_id(self):
        return int(self._state.facing)

    @property
    def agent_facing_str(self):
        return DIRECTION_NAMES[self.agent_facing_id]

    @property
    def inventory_items_quantity(self):
        inv = self._np(self._state.inventory)
        items = self._spec.items if self._modern else self._spec.items[1:]
        off = 0 if self._modern else 1
        return {n: int(inv[i + off]) for i, n in enumerate(items)}

    @property
    def selected_item(self):
        s = int(self._state.selected)
        return self._spec.items[s] if s >= 0 else ""

    @property
    def step_count(self):
        return int(self._state.step_count)

    @property
    def last_reward(self):
        return float(self._state.last_reward)

    @property
    def last_done(self):
        return bool(self._state.last_done)

    @property
    def block_in_front_location(self):
        r, c = self.agent_location
        d = FACING_DELTAS[self.agent_facing_id]
        return (r + int(d[0]), c + int(d[1]))

    @property
    def block_in_front_id(self):
        fr, fc = self.block_in_front_location
        return int(self.map[fr][fc])

    @property
    def block_in_front_str(self):
        return self._spec.items[self.block_in_front_id]

    def update_block_in_front(self):  # API parity; views are always live
        pass

    # -- core API -----------------------------------------------------------
    def seed(self, seed=None):
        if seed is not None:
            np.random.seed(seed)
            self._key = jax.random.key(seed)
        return [seed]

    def set_state(self, state: EnvState):
        self._state = state

    def get_state(self) -> EnvState:
        return self._state

    def reset(self, map_size=None, items_id=None, items_quantity=None):
        sp = self._spec
        if map_size is not None and map_size != sp.map_size:
            sp = sp.replace(map_size=map_size)
            self._spec = sp
            self._step, self._reset = _kernels(sp)
        if items_quantity is not None:
            spawn = [(sp.items.index(n), q) for n, q in items_quantity.items()]
            sp = sp.replace(
                spawn_items=np.asarray([i for i, _ in spawn], np.int32),
                spawn_qty=np.asarray([q for _, q in spawn], np.int32))
            self._spec = sp
            self._step, self._reset = _kernels(sp)

        if self.env is not None and self.env._state is not None:
            # restore-chaining: adopt the previous env's terminal state
            # (pogostick_v1_env.py:89-109) — mapped by item NAME so chained
            # envs with different item tables stay consistent
            prev = self.env
            remap = np.zeros((prev._spec.n_items,), np.int64)
            for i, n in enumerate(prev._spec.items):
                remap[i] = sp.items.index(n) if n in sp.items else 0
            m = remap[prev.map]
            inv = np.zeros((sp.n_items,), np.int64)
            for n, q in prev.inventory_items_quantity.items():
                if n in sp.items:
                    inv[sp.items.index(n)] = q
            self._state = state_from_numpy(
                sp, m, prev.agent_location, prev.agent_facing_id, inv,
                selected=(sp.items.index(prev.selected_item)
                          if prev.selected_item else -1),
                step_count=prev.step_count,
                last_reward=prev.last_reward, last_done=prev.last_done)
            print("RESTORING LAST ENV ...")
        elif self.reset_mode == "mirror":
            self._state = mirror_reset(
                sp.replace(reset_inv_set=None)
                if sp.reset_inv_set is not None else sp)
        else:
            self._key, k = jax.random.split(self._key)
            reset_fn = (_kernels(sp.replace(reset_inv_set=None))[1]
                        if sp.reset_inv_set is not None else self._reset)
            self._state, _ = reset_fn(k)

        # Post-reset inventory grant (AxeEasy et al.) applied HOST-side so the
        # returned obs can reproduce the reference's materialization order:
        # an array obs built below the novelty is computed before the grant
        # (stale, novelty_wrappers.py:29-35), a dict obs aliases the live
        # inventory and shows it (see EnvSpec.stale_reset_obs).
        def _apply_grant():
            setv = np.asarray(sp.reset_inv_set)
            inv = np.asarray(self._state.inventory)
            self._state = self._state.replace(
                inventory=np.where(setv >= 0, setv, inv).astype(np.int32))

        self.last_action = 0
        self.last_step_cost = 0.0
        base_mode = sp.base_obs_mode if sp.base_obs_mode >= 0 else sp.obs_mode
        # staleness follows the obs that is actually RETURNED: a fence-family
        # reset hands back the BASE env's obs (reset_obs_base), and when that
        # base obs is the raw dict it aliases the live inventory — the
        # reference's get_observation embeds the inventory dict itself
        # (pogostick_v1_env.py:214-228) — so an inner axe re-grant IS visible
        # through it even though the stack's own obs is a (stale) array.
        stale = sp.stale_reset_obs and not (sp.reset_obs_base
                                            and base_mode == S.OBS_DICT)
        if sp.reset_inv_set is not None and not stale:
            _apply_grant()
        if sp.reset_obs_base and base_mode != sp.obs_mode:
            # Fence/AddItem/ReplaceItem resets return the BASE env's
            # observation, bypassing any obs wrapper in the stack
            # (novelty_wrappers.py:885,1030,1146; EnvSpec.reset_obs_base)
            sp_b = sp.replace(obs_mode=base_mode)
            obs = self._decode_obs(_get_obs_fn(sp_b)(self._state), sp_b)
        else:
            obs = self.get_observation()
        if sp.reset_inv_set is not None and stale:
            _apply_grant()
        self._prev_inventory = np.asarray(self._state.inventory)
        return obs

    def _assert_limited_novelties(self, ids):
        """The reference novelty wrappers assert their own actions survived
        limiting on EVERY step when a LimitActions sits below
        (novelty_wrappers.py:39-43,262-268,466-468,677-683,912-914,
        1079-1081,1282-1284,1427-1429,1506-1511).  The reference raises on the
        first post-wrap step; so does this."""
        sp = self._spec
        tag = sp.novelty_tag
        if sp.axe_mode != S.AXE_NONE:
            axe = sp.items[sp.axe_id]
            required = sp.axe_mode == S.AXE_REQUIRED
            if "Craft_" + axe in sp.actions:  # hard variants add the recipe
                label = "AxetoBreakHard" if required else "AxeHard"
                assert "Craft_" + axe in ids, (
                    "Cannot use " + label + " novelty because you do not have "
                    + "Craft_" + axe + " in LimitActions")
            assert "Break" in ids, (
                "Cannot use axetobreak novelty because you do not have Break "
                "in LimitActions" if required else
                "Cannot use breakincrease novelty_arg2 because you do not "
                "have Break in LimitActions")
        if "|fencerestr-" in tag:
            # the reference asserts at ANY difficulty, including easy (which
            # behaves as a plain fence) — novelty_wrappers.py:912-914
            assert "Break" in ids, ("Cannot use fencerestriction novelty "
                                    "because you do not have Break in "
                                    "LimitActions")
        if sp.crate_id >= 0:
            assert "Break" in ids, ("Cannot use crate novelty because you do "
                                    "not have Break in LimitActions")
        if "|addchop" in tag:
            assert "Chop" in ids, ("Cannot use addchop novelty because you do "
                                   "not have Chop in LimitActions")
        if "|addjump" in tag:
            assert "Jump" in ids, ("Cannot use addjump novelty because you do "
                                   "not have Jump in LimitActions")
        if "|breakincrease" in tag:
            assert "Break" in ids, ("Cannot use breakincrease novelty because "
                                    "you do not have Break in LimitActions")
        if "|extract-" in tag:
            assert any(a.startswith("Extract") for a in ids), (
                "Cannot use extractincdec novelty because you do not have "
                "Extract action in LimitActions")

    def step(self, action_id: int):
        sp = self._spec
        if self.limited_actions_id is not None:
            # LimitActions.step (wrappers.py:74-83): compact id -> name ->
            # full-table id, with the reference's per-step asserts
            ids = self.limited_actions_id
            self._assert_limited_novelties(ids)
            assert int(action_id) in ids.values(), (
                "Action ID " + str(action_id) + " is not valid, max"
                "action ID is " + str(len(ids) - 1))
            name = list(ids.keys())[list(ids.values()).index(int(action_id))]
            assert name in sp.actions_id, \
                name + " is not a valid action for " + self.env_id
            action_id = sp.actions_id[name]
        if not 0 <= int(action_id) < sp.n_actions:
            raise AssertionError(
                f"action_id {action_id} not in Discrete({sp.n_actions})")
        prev_inv = np.asarray(self._state.inventory)
        state, obs, reward, done, info = self._step(self._state,
                                                    int(action_id))
        self._state = state
        self._prev_inventory = prev_inv
        self.last_action = sp.actions[int(action_id)]
        self.last_step_cost = float(info.step_cost)
        if self._modern:
            info_d = {
                "result": bool(info.result),
                "step_cost": float(info.step_cost),
                "message": decode_message(sp, info.msg_code, info.msg_arg,
                                          prev_inv),
            }
        else:
            info_d = {}
        return (self._decode_obs(obs), float(reward), bool(done), info_d)

    def get_observation(self):
        if self._state is None:
            raise RuntimeError("reset() the env first")
        return self._decode_obs(_get_obs_fn(self._spec)(self._state))

    def _decode_obs(self, obs, sp=None):
        if sp is None:
            sp = self._spec
        if sp.obs_mode == S.OBS_DICT:
            return {
                "map": np.asarray(obs["map"]),
                "agent_location": tuple(int(v) for v in np.asarray(obs["agent_location"])),
                "agent_facing_id": int(obs["agent_facing_id"]),
                "inventory_items_quantity": {
                    n: int(np.asarray(obs["inventory_items_quantity"])[i])
                    for i, n in enumerate(sp.items)},
            }
        if sp.obs_mode == S.OBS_AGENT_MAP:
            return {
                "agent_map": np.asarray(obs["agent_map"]),
                "agent_facing_id": int(obs["agent_facing_id"]),
                "inventory_items_quantity": {
                    n: int(np.asarray(obs["inventory_items_quantity"])[i])
                    for i, n in enumerate(sp.items)},
            }
        return np.asarray(obs)

    # -- mutation hooks (novelty / driver parity) ---------------------------
    def set_agent_location(self, r, c):
        self._state = self._state.replace(
            agent=np.asarray([r, c], np.int32))

    def set_agent_facing(self, direction_str):
        self._state = self._state.replace(
            facing=np.int32(DIRECTION_NAMES.index(direction_str)))

    def set_lasts(self, lasts):
        """Restore step bookkeeping (pogostick_v1_env.py:192-198)."""
        self.last_action = lasts["last_action"]
        self.last_step_cost = float(lasts["last_step_cost"])
        self._state = self._state.replace(
            step_count=np.int32(lasts["step_count"]),
            last_reward=np.float32(lasts["last_reward"]),
            last_done=np.asarray(bool(lasts["last_done"])))

    def add_new_items(self, new_items_quantity):
        """Grow the item table and respawn (pogostick_v1_env.py:495-501):
        new items get the next id (no Select action is added), the spawn
        table is dict.update'd, and the env resets."""
        from ..novelty import _append_item

        sp = self._spec
        for item, qty in new_items_quantity.items():
            if item not in sp.items:
                sp = _append_item(sp, item, select_action=False)
            spawn = list(sp.spawn_items)
            qtys = list(sp.spawn_qty)
            iid = sp.items.index(item)
            if iid in spawn:
                qtys[spawn.index(iid)] = qty
            else:
                spawn.append(iid)
                qtys.append(qty)
            sp = sp.replace(spawn_items=np.asarray(spawn, np.int32),
                            spawn_qty=np.asarray(qtys, np.int32))
        self._spec = sp
        self._step, self._reset = _kernels(sp)
        self.reset()

    def block_items(self, item_to_block, item_to_block_from):
        """Ring each ``item_to_block`` cell with ``item_to_block_from`` on its
        4 air neighbors, skipping the agent cell (pogostick_v1_env.py:503-522)."""
        m = self.map.copy()
        bid = self._spec.items_id[item_to_block]
        fid = self._spec.items_id[item_to_block_from]
        agent = self.agent_location
        rows, cols = np.where(m == bid)
        for r, c in zip(rows, cols):
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                if (0 <= rr <= self.map_size - 1
                        and 0 <= cc <= self.map_size - 1
                        and m[rr][cc] == 0 and (rr, cc) != agent):
                    m[rr][cc] = fid
        self._state = self._state.replace(map=m.reshape(-1).astype(np.int32))

    def add_fence_around(self, item_location, fence_name):
        """Fill the 3x3 air neighborhood of ``item_location`` with
        ``fence_name``, skipping the agent cell (pogostick_v1_env.py:524-536)."""
        m = self.map.copy()
        fid = self._spec.items_id[fence_name]
        agent = self.agent_location
        r, c = item_location
        for rr in (r - 1, r, r + 1):
            for cc in (c - 1, c, c + 1):
                if m[rr][cc] == 0 and (rr, cc) != agent:
                    m[rr][cc] = fid
        self._state = self._state.replace(map=m.reshape(-1).astype(np.int32))

    def set_limited_actions_id(self, limited_actions_id):
        """Reference LimitActions hook (wrappers.py:71-73)."""
        self.limited_actions_id = dict(limited_actions_id)

    def remap_action(self, actions_id=None, start_action_id=0):
        """Reference signature (pogostick_v1_env.py:476-493): reshuffle the
        given name->id dict (same np.random.shuffle draw loop) and return it.
        With no argument, remaps this env's whole action table in place
        (rebuilding the kernel for the new ordering).  v0 is special: the
        reference's ``NovelGridworldV0Env.remap_action`` takes no argument and
        shuffles ``action_str`` with the **stdlib** ``random.shuffle``
        (novel_gridworld_v0_env.py:271-285, the repo's only stdlib-RNG site),
        so a user who seeds ``random.seed(s)`` must get the reference's
        permutation."""
        if actions_id is not None:
            actions_id = dict(actions_id)
            while True:
                actions = list(actions_id.keys())
                np.random.shuffle(actions)
                new = {actions[i - start_action_id]: i for i in
                       range(start_action_id,
                             start_action_id + len(actions))}
                if actions_id != new:
                    print("New remapped actions: ", new)
                    return new
        if self.env_id == "NovelGridworld-v0":
            import random
            action_str = self.action_str
            while True:
                actions = list(action_str.values())
                random.shuffle(actions)
                new = {i: a for i, a in enumerate(actions)}
                if action_str != new:
                    break
            from .. import transforms
            self._spec = transforms.actions._gather_actions(
                self._spec, [new[i] for i in range(len(new))], "|remap-v0")
            self._step, self._reset = _kernels(self._spec)
            print("New remapped actions: ", self.action_str)
            return self.action_str
        from ..transforms.actions import remap_actions
        self._spec = remap_actions(self._spec, "hard")
        self._step, self._reset = _kernels(self._spec)
        return self._spec.actions_id

    # -- rendering ----------------------------------------------------------
    def render(self, mode="human", title=None):
        from .render import render_env
        return render_env(self, mode=mode, title=title)

    def close(self):
        if self._renderer is not None:
            self._renderer.close()

    def __repr__(self):
        return f"<NGXEnv {self.env_id} ({'modern' if self._modern else 'legacy'})>"


def make(env_id: str, env: Optional[NGXEnv] = None, map_size: int = 10,
         reset_mode: str = "mirror", seed: Optional[int] = None) -> NGXEnv:
    """``gym.make``-alike over the 11 presets (reference __init__.py:7-60)."""
    return NGXEnv(make_spec(env_id, map_size=map_size), env=env,
                  reset_mode=reset_mode, seed=seed)
