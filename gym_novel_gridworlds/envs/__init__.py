"""The 11 reference env classes as facade constructors.

Each class name matches the reference's ``envs/__init__.py:1-13`` export; a
call returns an :class:`ngx.compat.NGXEnv` backed by the jitted step kernel
with the same attribute/method surface (``reset/step/render``, ``items_id``,
``actions_id``, ``inventory_items_quantity``, restore-chaining ``env=`` ctor
arg, mutation hooks).  Constructor signatures match the reference
(``pogostick_v1_env.py:26``: ``__init__(self, env=None)``; v0/v1 take no
args — extra kwargs here are an accepted superset).
"""

from ngx.compat import make as _make


def _env_class(env_id):
    class _Env:
        def __new__(cls, env=None, map_size=10, **kw):
            return _make(env_id, env=env, map_size=map_size, **kw)

    _Env.__name__ = _Env.__qualname__ = _CLASS_NAMES[env_id]
    _Env.__doc__ = f"Facade constructor for {env_id} (returns NGXEnv)."
    return _Env


_CLASS_NAMES = {
    "NovelGridworld-v0": "NovelGridworldV0Env",
    "NovelGridworld-v1": "NovelGridworldV1Env",
    "NovelGridworld-v2": "NovelGridworldV2Env",
    "NovelGridworld-v3": "NovelGridworldV3Env",
    "NovelGridworld-v4": "NovelGridworldV4Env",
    "NovelGridworld-v5": "NovelGridworldV5Env",
    "NovelGridworld-v6": "NovelGridworldV6Env",
    "NovelGridworld-Bow-v0": "BowV0Env",
    "NovelGridworld-Bow-v1": "BowV1Env",
    "NovelGridworld-Pogostick-v0": "PogostickV0Env",
    "NovelGridworld-Pogostick-v1": "PogostickV1Env",
}

NovelGridworldV0Env = _env_class("NovelGridworld-v0")
NovelGridworldV1Env = _env_class("NovelGridworld-v1")
NovelGridworldV2Env = _env_class("NovelGridworld-v2")
NovelGridworldV3Env = _env_class("NovelGridworld-v3")
NovelGridworldV4Env = _env_class("NovelGridworld-v4")
NovelGridworldV5Env = _env_class("NovelGridworld-v5")
NovelGridworldV6Env = _env_class("NovelGridworld-v6")
BowV0Env = _env_class("NovelGridworld-Bow-v0")
BowV1Env = _env_class("NovelGridworld-Bow-v1")
PogostickV0Env = _env_class("NovelGridworld-Pogostick-v0")
PogostickV1Env = _env_class("NovelGridworld-Pogostick-v1")
