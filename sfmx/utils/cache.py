"""JAX's persistent compile cache, set up the same way by every entry point.

- If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and sfmx sets
  no cache path.
- Otherwise the cache lives at ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``).

The CLI, ``bench.py``, ``chip_smoke.py`` and the test suite all call
:func:`enable_compile_cache`.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """Where compiled programs are kept."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache for programs that take at least
    a second to compile; returns its directory."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
