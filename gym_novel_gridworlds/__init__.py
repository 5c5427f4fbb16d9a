"""Drop-in import alias for the reference package name.

Reference users do ``import gym_novel_gridworlds`` and then either
``gym.make('NovelGridworld-*')`` or construct env classes / wrappers directly
(reference ``gym_novel_gridworlds/__init__.py:1-60``).  This package keeps
that exact import surface working on top of the batched JAX ``ngx`` engine:

* the 11 env classes under :mod:`gym_novel_gridworlds.envs`
* ``constant.env_key`` keyboard maps
* ``wrappers`` / ``observation_wrappers`` / ``novelty_wrappers`` modules with
  the reference class names and constructor signatures
* if ``gym`` is importable, the 11 ids are registered so ``gym.make`` works
  unchanged; otherwise :func:`make` here is a registry-free equivalent.

Like the reference, importing the package imports the wrapper modules as a
side effect.
"""

from ngx.compat import make  # noqa: F401  (gym.make-alike over the presets)

from . import constant  # noqa: F401
from . import wrappers  # noqa: F401
from . import observation_wrappers  # noqa: F401
from . import novelty_wrappers  # noqa: F401
from . import envs  # noqa: F401

ENV_IDS = (
    "NovelGridworld-v0",
    "NovelGridworld-v1",
    "NovelGridworld-v2",
    "NovelGridworld-v3",
    "NovelGridworld-v4",
    "NovelGridworld-v5",
    "NovelGridworld-v6",
    "NovelGridworld-Bow-v0",
    "NovelGridworld-Bow-v1",
    "NovelGridworld-Pogostick-v0",
    "NovelGridworld-Pogostick-v1",
)

_ENTRY_POINTS = {
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


def _register_with_gym():
    """Mirror the reference's 11 ``gym.register`` calls
    (reference ``__init__.py:7-60``) when a gym is importable.  Gated: the
    engine does not need gym, and most installs lack it."""
    try:
        from gym.envs.registration import register
    except Exception:  # pragma: no cover - no gym in the image
        return False
    for env_id, cls in _ENTRY_POINTS.items():
        try:
            register(id=env_id,
                     entry_point="gym_novel_gridworlds.envs:" + cls)
        except Exception:  # already registered (gym raises on duplicates)
            pass
    return True


GYM_REGISTERED = _register_with_gym()
