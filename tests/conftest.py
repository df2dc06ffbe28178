"""Test harness: JAX on the CPU with an 8-device virtual mesh.

Multi-chip sharding tests run on emulated host devices per SURVEY.md
section 4's test plan, and Pallas kernels run in interpret mode. Tests
that need the card are marked ``gpu`` and take the ``gpu`` fixture,
which skips them here; on a machine with an NVIDIA GPU run them with

    GNSS_SDR_TEST_GPU=1 python -m pytest -m gpu tests/

which leaves the platform to JAX instead of pinning the CPU.
"""
import os

import jax
import pytest

if os.environ.get("GNSS_SDR_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from gnss_sdr.utils.host import tune_host_allocator  # noqa: E402

tune_host_allocator()


@pytest.fixture
def gpu():
    """The GPU device; skips the test on any other platform."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (GNSS_SDR_TEST_GPU=1 "
                    "python -m pytest -m gpu tests/)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """The full suite runs ~300 tests' worth of XLA:CPU compiles in one
    process; past ~250 the LLVM backend intermittently SIGABRTs inside
    backend_compile_and_load (observed at varying test positions, not
    OOM — 125 GB free). Dropping the compiled-executable caches at
    module boundaries bounds the accumulated compiler state; modules
    recompile their own graphs anyway."""
    yield
    jax.clear_caches()
