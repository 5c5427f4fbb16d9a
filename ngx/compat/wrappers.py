"""Reference-named wrappers and novelty injection for the facade.

Each "wrapper" returns a fresh :class:`NGXEnv` whose spec was rewritten by the
corresponding pure transform — the reference's class names and call shapes
(``wrappers.py``, ``observation_wrappers.py``, ``novelty_wrappers.py:1586``)
kept so driver code ports mechanically.
"""

from __future__ import annotations

import os
import pickle
from datetime import datetime

import numpy as np

from ..core.mirror import mirror_reset
from ..novelty import inject_novelty as spec_inject
from ..transforms import actions as T_actions
from ..transforms import observations as T_obs
from .env import NGXEnv  # noqa: F401 (re-exported)


def _rewrap(env: NGXEnv, spec) -> NGXEnv:
    new = NGXEnv(spec, env=env.env, reset_mode=env.reset_mode)
    new._key = env._key
    if env._state is not None and spec.n_items == env._spec.n_items:
        new._state = env._state
    # a LimitActions below survives any wrap above it (the reference stacks
    # novelties over the limiter and reaches limited_actions_id by gym
    # attribute forwarding, novelty_wrappers.py:39-43)
    new.limited_actions = env.limited_actions
    new.limited_actions_id = env.limited_actions_id
    new.action_space_n_override = env.action_space_n_override
    return new


def LidarInFront(env: NGXEnv, num_beams: int = 8) -> NGXEnv:
    return _rewrap(env, T_obs.lidar_in_front(env._spec, num_beams))


def AgentMap(env: NGXEnv) -> NGXEnv:
    return _rewrap(env, T_obs.agent_map(env._spec))


def LimitActions(env: NGXEnv, limited_actions) -> NGXEnv:
    """Facade LimitActions (wrappers.py:57-85): per-step NAME translation over
    the full spec, exactly like the reference — names are NOT validated at
    construction (the reference allows pre-listing actions a later novelty
    will add; stepping them before that raises the per-step assert), and a
    novelty injected above does not grow the agent-visible space.  The pure
    spec-gather transform (ngx.transforms.actions.limit_actions) remains the
    batched device path."""
    new = _rewrap(env, env._spec)
    new.limited_actions = set(limited_actions)
    new.limited_actions_id = {a: i for i, a in
                              enumerate(sorted(new.limited_actions))}
    # a fresh limiter's Discrete is the visible space again (it sits above
    # any earlier AddJump/AddChop override)
    new.action_space_n_override = None
    return new


def inject_novelty(env: NGXEnv, novelty_name: str, difficulty: str = "hard",
                   novelty_arg1: str = "", novelty_arg2: str = "") -> NGXEnv:
    """Reference entry point (novelty_wrappers.py:1586-1674).  In mirror
    mode the construction-time RNG side effects are replayed too: AxeMedium /
    AxetoBreakMedium / AxeHard-iron call add_new_items which resets the env
    during wrapper construction (novelty_wrappers.py:129,552,249), consuming
    np.random draws."""
    if novelty_name == "remapaction" and env.limited_actions_id is not None:
        # with a LimitActions below, the reference remaps ONLY the limited
        # table, in place, regardless of difficulty
        # (novelty_wrappers.py:1209-1210) — the full-spec remap must not run
        # (different semantics AND a different np.random draw sequence)
        env.set_limited_actions_id(
            env.remap_action(env.limited_actions_id, 0))
        return env
    spec = spec_inject(env._spec, novelty_name, difficulty, novelty_arg1,
                       novelty_arg2)
    new = _rewrap(env, spec)
    new._state = None  # novelty wrap requires a fresh reset, as in reference
    if novelty_name in ("addjump", "addchop"):
        # these wrappers declare Discrete(len(full actions_id)) on
        # THEMSELVES, shadowing a LimitActions Discrete below and freezing
        # the count at injection time (novelty_wrappers.py:1278,1350) —
        # stepping still translates through the limited table
        new.action_space_n_override = spec.n_actions
    if env.reset_mode == "mirror":
        construction_resets = (
            (novelty_name in ("axe", "axetobreak") and difficulty == "medium")
            or (novelty_name == "axe" and difficulty == "hard"
                and novelty_arg1 == "iron"))
        if construction_resets:
            mirror_reset(spec)  # throwaway draw, keeps np.random in sync
    return new


class BlockItem:
    """Fence every crafting_table after a successful rubber extraction
    (novelty_wrappers.py:1232-1264).  Not reachable via ``inject_novelty``
    in the reference either — direct construction only.

    The reference's step calls ``env.add_fence_around((r, c))`` without the
    required ``fence_name`` argument (novelty_wrappers.py:1259-1261), a
    latent TypeError on first trigger — the class is effectively dead code
    (SURVEY §2.4).  Here the evident intent is implemented (fence material
    ``'fence'``, the item its own ``__init__`` registers); the divergence is
    deliberate and documented, not silent.
    """

    def __init__(self, env: NGXEnv):
        from ..novelty import _append_item

        old_spec = env._spec
        spec = old_spec
        if "fence" not in spec.items:
            # items_id.setdefault only — no Select action, no spawn entry
            # (novelty_wrappers.py:1243-1244)
            spec = _append_item(spec, "fence", select_action=False)
        self.env = _rewrap(env, spec)
        if env._state is not None and spec.n_items > old_spec.n_items:
            # live state survives the wrap (the reference never resets here):
            # pad the inventory for the appended item ids
            st = env._state
            pad = np.zeros((spec.n_items - old_spec.n_items,), np.int32)
            self.env._state = st.replace(
                inventory=np.concatenate([np.asarray(st.inventory), pad]))
        self.items_to_block = "crafting_table"
        self.item_to_block_from = "tree_log"

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action_id):
        old_rubber = self.env.inventory_items_quantity["rubber"]
        out = self.env.step(action_id)
        if (action_id == self.env.actions_id["Extract_rubber"]
                and old_rubber < self.env.inventory_items_quantity["rubber"]):
            rows, cols = np.where(
                self.env.map == self.env.items_id[self.items_to_block])
            for r, c in zip(rows, cols):
                self.env.add_fence_around((int(r), int(c)), "fence")
        return out


class SaveTrajectories:
    """Per-step full-state recording (wrappers.py:9-54), pickle-compatible."""

    def __init__(self, env: NGXEnv, save_path: str):
        self.env = env
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self.state_trajectories = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action_id):
        out = self.env.step(action_id)
        self.state_trajectories.append(self.get_state())
        return out

    def get_state(self):
        e = self.env
        return {"map_size": e.map_size,
                "map": e.map,
                "agent_location": e.agent_location,
                "agent_facing_str": e.agent_facing_str,
                "block_in_front_id": e.block_in_front_id,
                "items_id": e.items_id,
                "items_quantity": e.items_quantity,
                "inventory_items_quantity": e.inventory_items_quantity,
                "action_str": e.actions_id,
                "last_action": e.last_action,
                "last_done": e.last_done}

    def save(self):
        path = os.path.join(
            self.save_path,
            datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            + "_{env}.bin".format(env=self.env.env_id))
        with open(path, "wb") as f:
            pickle.dump(self.state_trajectories, f)
        print("Trajectories saved at: ", path)
        return path
