"""Imports of the optional dependencies, each named with its install extra."""

from __future__ import annotations

import importlib


def require(module: str, extra: str):
    """Import ``module``; if it is missing, raise an ImportError that names
    the ``pip`` extra providing it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{module} is not installed; it comes with the '{extra}' extra: "
            f"pip install 'novelgridworlds-ngx[{extra}]'") from e
