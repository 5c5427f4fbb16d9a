"""Driver scripts (the reference's L5 layer — enjoy.py, tests/*.py —
rebuilt over the batched engine).  Run as ``python -m ngx.cli.<name>``."""

from ..utils.compile_cache import enable_compile_cache

PLATFORMS = ("cpu", "gpu", "auto")


def set_platform(platform: str) -> None:
    """Pin JAX's platform for a driver before its first device use, and
    turn on the persistent compile cache.

    ``auto`` keeps JAX's own choice (``JAX_PLATFORMS`` if set, else the GPU
    when one is present); ``cpu`` and ``gpu`` pin it.  Uses
    ``jax.config.update``, which takes effect as long as no backend has
    initialised yet (they initialise lazily on first device use).
    """
    if platform != "auto":
        import jax
        jax.config.update("jax_platforms", platform)
    enable_compile_cache()
