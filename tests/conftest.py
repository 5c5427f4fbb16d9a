import os
import sys

# Tests run on CPU with 8 virtual devices so the sharding layer is exercised
# without accelerators (tests marked ``gpu`` need a card and skip without
# one).  The platform is pinned via jax.config, which works even when jax was
# imported before this file; XLA_FLAGS is read lazily at CPU-client init.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# NGX_TEST_GPU=1 (with ``-m gpu``) runs the card-only tests: the default
# device is then the GPU and the CPU stays available as their reference.
jax.config.update("jax_platforms",
                  "cuda,cpu" if os.environ.get("NGX_TEST_GPU") else "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test when there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA device: run NGX_TEST_GPU=1 python -m "
                    "pytest tests/ -m gpu on a GPU machine")
    return devs[0]
