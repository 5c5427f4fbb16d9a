from . import rays  # noqa: F401
