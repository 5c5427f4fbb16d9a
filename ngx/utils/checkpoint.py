"""Checkpoint / resume via orbax.

The reference's checkpointing is (1) SB2 model zips, (2) the env-restore
ctor, (3) trajectory pickles (SURVEY.md §5).  Here everything — policy
TrainState, batched EnvState, config metadata — is a pytree, so one
serializer covers model and environment checkpoints alike.
"""

from __future__ import annotations

import os

import jax

from .extras import require


def _checkpointer():
    ocp = require("orbax.checkpoint", "ckpt")
    return ocp.PyTreeCheckpointer()


def save_pytree(path: str, tree) -> str:
    """Save any pytree (TrainState, EnvState, dict of both) to ``path``."""
    path = os.path.abspath(path)
    _checkpointer().save(path, jax.device_get(tree), force=True)
    return path


def restore_pytree(path: str, like=None):
    """Restore a pytree.  Pass ``like`` (a template with the same structure,
    e.g. an EnvState or TrainState) to get the restored leaves re-assembled
    into that container type; otherwise plain dicts/lists come back."""
    path = os.path.abspath(path)
    restored = _checkpointer().restore(path)
    if like is None:
        return restored

    def rebuild(template, value):
        if isinstance(value, dict) and not isinstance(template, dict) \
                and hasattr(template, "__dataclass_fields__"):
            kw = {k: rebuild(getattr(template, k), v) for k, v in value.items()}
            return type(template)(**kw)
        if isinstance(value, dict) and isinstance(template, tuple) \
                and hasattr(template, "_fields"):
            # NamedTuples (e.g. optax optimizer states) round-trip as dicts
            # keyed by field name
            return type(template)(**{
                k: rebuild(getattr(template, k), v) for k, v in value.items()})
        if isinstance(value, dict):
            return {k: rebuild(template[k], v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(template)(rebuild(t, v)
                                  for t, v in zip(template, value))
        return value

    return rebuild(like, restored)
