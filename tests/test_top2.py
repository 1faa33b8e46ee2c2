"""Top-2 kernel (Pallas, interpret mode) and its plain versions.

The kernel's arithmetic is checked here on the CPU; what only the GPU's
compiler can say is checked by ``chip_smoke.py``.  The CUDA lowering test
runs the Pallas -> Triton lowering (not Triton's own compiler) on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sfmx.kernels import top2


def unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ref_pairs(q, pool, mask, pairs):
    out = [top2.top2_reference(q[a], pool[b], mask[b]) for a, b in pairs]
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(3)]


@pytest.mark.parametrize("kq,kp,block_q,block_p,split,masked", [
    (100, 300, 32, 32, None, False),   # neither size a multiple of a block
    (64, 20, 32, 32, None, False),     # pool smaller than one block
    (48, 200, 16, 64, 1, True),        # masked candidates
    (40, 260, 32, 32, 3, True),        # candidate split, uneven tiles
    (128, 96, 64, 32, 2, False),       # split merge
])
def test_top2_kernel_parity(rng, kq, kp, block_q, block_p, split, masked):
    q = jnp.asarray(unit(rng, kq, 128))
    p = jnp.asarray(unit(rng, kp, 128))
    m = jnp.asarray(rng.random(kp) > 0.3) if masked else jnp.ones(kp, bool)
    k1, ki, k2 = top2.top2_kernel(q[None], p[None], m[None],
                                  jnp.zeros((1, 2), jnp.int32),
                                  block_q=block_q, block_p=block_p,
                                  split=split, interpret=True)
    r1, ri, r2 = top2.top2_reference(q, p, m)
    np.testing.assert_allclose(np.asarray(k1[0]), np.asarray(r1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(k2[0]), np.asarray(r2), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ki[0]), np.asarray(ri))
    assert bool(np.asarray(m)[np.asarray(ki[0])].all())


def test_top2_kernel_pair_axis(rng):
    """Each grid row reads its own pair's images, in any order."""
    C, K = 4, 80
    d = jnp.asarray(unit(rng, C, K, 128))
    m = jnp.asarray(rng.random((C, K)) > 0.2)
    pairs = np.asarray([[0, 1], [3, 2], [1, 1], [2, 0]], np.int32)
    got = top2.top2_kernel(d, d, m, jnp.asarray(pairs), block_q=32,
                           block_p=32, interpret=True)
    want = _ref_pairs(d, d, m, pairs)
    np.testing.assert_allclose(np.asarray(got[0]), want[0], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    np.testing.assert_allclose(np.asarray(got[2]), want[2], atol=1e-6)


def test_top2_kernel_ties(rng):
    """Duplicated candidates: s2 == s1 and the index is one of the twins."""
    q = unit(rng, 32, 128)
    p = unit(rng, 96, 128)
    p[10] = q[5]
    p[75] = q[5]            # a twin in another tile and column slot
    k1, ki, k2 = top2.top2_kernel(
        jnp.asarray(q)[None], jnp.asarray(p)[None], jnp.ones((1, 96), bool),
        jnp.zeros((1, 2), jnp.int32), block_q=32, block_p=32, interpret=True)
    assert int(ki[0, 5]) in (10, 75)
    assert float(k1[0, 5]) == float(k2[0, 5])


def test_top2_no_valid_candidate(rng):
    q = jnp.asarray(unit(rng, 16, 128))
    p = jnp.asarray(unit(rng, 40, 128))
    m = jnp.zeros(40, bool)
    k1, _, k2 = top2.top2_kernel(q[None], p[None], m[None],
                                 jnp.zeros((1, 2), jnp.int32), block_q=16,
                                 block_p=16, interpret=True)
    s1, _, s2 = top2.top2_scan(q, p, m, chunk=16)
    for x in (k1, k2, s1, s2):
        assert float(jnp.max(x)) <= top2.NEG / 2


@pytest.mark.parametrize("chunk", [64, 1024])
def test_top2_scan_matches_reference(rng, chunk):
    q = jnp.asarray(unit(rng, 50, 128))
    p = jnp.asarray(unit(rng, 700, 128))
    m = jnp.asarray(rng.random(700) > 0.1)
    s = top2.top2_scan(q, p, m, chunk=chunk)
    r = top2.top2_reference(q, p, m)
    np.testing.assert_allclose(np.asarray(s[0]), np.asarray(r[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s[2]), np.asarray(r[2]), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(s[1]), np.asarray(r[1]))


def test_merge_splits_exact():
    s1 = jnp.asarray([[0.9, 0.1], [0.5, 0.8], [0.7, 0.3]])
    i1 = jnp.asarray([[1, 2], [3, 4], [5, 6]], jnp.int32)
    s2 = jnp.asarray([[0.6, 0.0], [0.4, 0.2], [0.65, 0.25]])
    m1, mi, m2 = top2._merge_splits(s1, i1, s2)
    np.testing.assert_allclose(np.asarray(m1), [0.9, 0.8])
    np.testing.assert_array_equal(np.asarray(mi), [1, 4])
    # row 0: winner split 0 (second 0.6) vs other bests 0.5, 0.7 -> 0.7
    np.testing.assert_allclose(np.asarray(m2), [0.7, 0.3])


def test_top2_kernel_lowers_to_triton():
    """The wrapper lowers for CUDA on the CPU into one Triton call."""
    q = jnp.zeros((300, 128), jnp.float32)
    p = jnp.zeros((1000, 128), jnp.float32)
    m = jnp.ones(1000, bool)
    fn = jax.jit(lambda q, p, m: top2.top2_kernel(
        q[None], p[None], m[None], jnp.zeros((1, 2), jnp.int32)))
    text = fn.trace(q, p, m).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.gpu
def test_top2_kernel_compiled_on_gpu(gpu, rng):
    """The compiled Triton kernel against the dense reference (chip_smoke's
    serve_streaming phase runs the same check at the serving size)."""
    q = jnp.asarray(unit(rng, 1024, 128))
    p = jnp.asarray(unit(rng, 20_000, 128))
    m = jnp.asarray(rng.random(20_000) > 0.05)
    k1, ki, k2 = top2.top2(q, p, m)
    r1, ri, r2 = top2.top2_reference(q, p, m)
    assert float(jnp.max(jnp.abs(k1 - r1))) <= 2e-3
    assert float(jnp.max(jnp.abs(k2 - r2))) <= 2e-3
    clear = np.asarray(r1 - r2) > 4e-3
    np.testing.assert_array_equal(np.asarray(ki)[clear], np.asarray(ri)[clear])
