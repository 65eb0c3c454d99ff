"""Test configuration.

JAX-dependent tests run on a virtual 8-device CPU mesh (SURVEY.md §4's
multi-host test plan).  jax.config is updated directly as well as the
environment, in case jax was imported before this file.  Tests that need
a card are marked ``gpu`` and skip through the ``gpu`` fixture unless
the suite runs on one: ``PYAMG_TESTS_ON_GPU=1 python -m pytest -m gpu``
leaves the platform to JAX's default.
"""

import os
import sys

ON_GPU = os.environ.get("PYAMG_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the first JAX device is a GPU (decided at run time,
    never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _release_jit_executables_per_module():
    """Release compiled executables between test modules.

    On the CPU backend every jitted program keeps JIT code pages
    mapped; across the full suite the accumulated map count exceeds
    vm.max_map_count (default 65530) and LLVM aborts mid-compile
    (observed round 3: Fatal Python error in
    test_distributed_block_setup_gspmd after ~290 green tests — the
    same failure mode bench.py's phase-B clear_caches guards against).
    Nothing shares compilations across modules, so the clear only costs
    a few redundant recompiles.
    """
    yield
    jax.clear_caches()
