"""One place chooses the implementation; nothing hides the device.

- ``backend`` accepts gpu and cpu and raises on anything else;
- on the CPU the production entries run the plain references (no
  ``pallas_call`` in their programs);
- the production matchers' device memory does not grow with the pair count
  or the landmark pool;
- the compile cache honours ``JAX_COMPILATION_CACHE_DIR``;
- the main path imports without PIL, aiohttp, cv2 or yaml;
- ``chip_smoke.py`` refuses to run without a GPU.
"""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sfmx.kernels import backend, matching, top2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="rocm"):
        backend.platform()
    with pytest.raises(RuntimeError):
        top2.top2(jnp.zeros((4, 8)), jnp.zeros((6, 8)), jnp.ones(6, bool))


def test_cpu_runs_the_references():
    assert backend.platform() == "cpu"
    assert not backend.use_kernels()


def _lmap(P=512, C=4, D=128, Kc=16):
    from __graft_entry__ import _example_map

    return _example_map(P=P, C=C, D=D, Kc=Kc)


def _streaming_jaxpr():
    from sfmx.localize import localize_batch_streaming

    B, K = 2, 32
    return jax.make_jaxpr(lambda d, u, m: localize_batch_streaming(
        _lmap(), d, u, m, jnp.asarray([280.0, 280, 160, 120, 0, 0, 0]),
        jax.random.PRNGKey(0), k_hypotheses=16))(
        jnp.zeros((B, K, 128)), jnp.zeros((B, K, 2)), jnp.ones((B, K), bool))


def _sharded_jaxpr():
    from sfmx.dist import mesh as meshlib
    from sfmx.localize import localize_batch_sharded, shard_localization_map
    from sfmx.localize.sharded import AXIS

    mesh = meshlib.make_mesh(AXIS)
    slmap = shard_localization_map(_lmap(), mesh)
    B, K = 2, 32
    return jax.make_jaxpr(lambda d, u, m: localize_batch_sharded(
        slmap, d, u, m, jnp.asarray([280.0, 280, 160, 120, 0, 0, 0]),
        jax.random.PRNGKey(0), mesh=mesh, k_hypotheses=16))(
        jnp.zeros((B, K, 128)), jnp.zeros((B, K, 2)), jnp.ones((B, K), bool))


def _pairs_jaxpr():
    return jax.make_jaxpr(matching.match_pairs_float_auto)(
        jnp.zeros((4, 64, 128)), jnp.ones((4, 64), bool),
        jnp.asarray([[0, 1], [2, 3]], jnp.int32))


@pytest.mark.parametrize("entry", [_streaming_jaxpr, _sharded_jaxpr,
                                   _pairs_jaxpr])
def test_cpu_entries_have_no_pallas_call(entry):
    text = str(entry())
    assert "pallas_call" not in text


def _temp_bytes(fn, *args):
    return fn.lower(*args).compile().memory_analysis().temp_size_in_bytes


def test_pair_matcher_memory_independent_of_pair_count(rng):
    """Chunked plain matcher: temp memory is one batch of (K, K)
    similarities, whatever Np (the dense one needs Np of them)."""
    C, K = 16, 128
    d = jnp.asarray(rng.standard_normal((C, K, 128)), jnp.float32)
    m = jnp.ones((C, K), bool)
    fn = jax.jit(partial(matching.match_pairs_float_chunked, batch=8))
    small = _temp_bytes(fn, d, m, jnp.zeros((64, 2), jnp.int32))
    big = _temp_bytes(fn, d, m, jnp.zeros((512, 2), jnp.int32))
    dense = _temp_bytes(matching.match_pairs_float, d, m,
                        jnp.zeros((512, 2), jnp.int32))
    # the outputs are (Np, K): allow a few bytes per output row, never a
    # (K, K) similarity per extra pair
    assert big - small < (512 - 64) * K * 16
    assert dense - big > (512 - 64) * K * K


def test_streaming_memory_independent_of_pool_size(rng):
    """Chunked plain top-2: temp memory may hold a copy of the pool (P x D),
    never the (Q, P) similarity."""
    Q, D = 2048, 128
    q = jnp.zeros((Q, D), jnp.float32)
    fn = jax.jit(partial(top2.top2_scan, chunk=1024))
    small = _temp_bytes(fn, q, jnp.zeros((8192, D)), jnp.ones(8192, bool))
    big = _temp_bytes(fn, q, jnp.zeros((65536, D)), jnp.ones(65536, bool))
    per_row = (big - small) / (65536 - 8192)
    assert per_row <= 2 * D * 4 < Q * 4


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from sfmx.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets no path


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from sfmx.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        REPO, ".jax_cache")


_BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("PIL", "aiohttp", "cv2", "yaml"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import {module}
"""


@pytest.mark.parametrize("module", ["sfmx.cli.pipeline", "sfmx.serve.server",
                                    "chip_smoke"])
def test_main_path_imports_without_io_packages(module):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _BLOCK.format(repo=REPO, module=module)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
