"""Test config: the CPU backend with 8 virtual devices (SURVEY.md §4.2.4).

The platform is set through ``jax.config`` before any backend initializes.
``SFMX_TESTS_ON_GPU=1`` leaves the platform alone so the tests marked
``gpu`` (compiled kernels, no interpret mode) can run on a card:

    SFMX_TESTS_ON_GPU=1 python -m pytest -n 0 -m gpu tests/test_top2.py

Every other test expects the CPU.
"""
import os

import jax

if os.environ.get("SFMX_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

from sfmx.utils.cache import enable_compile_cache  # noqa: E402

# the suite is dominated by cold XLA:CPU compiles; cached executables make
# reruns fast
enable_compile_cache()
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips unless JAX's backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU path "
                    "(their arithmetic is tested in interpret mode)")
