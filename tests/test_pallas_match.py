"""Top-2 streaming matcher kernel (Pallas, interpret mode): parity with the
dense top-2 reference, and the streaming matcher against the dense one."""
import jax.numpy as jnp
import numpy as np

from sfmx.kernels import matching
from sfmx.kernels.top2 import (match_float_streaming, top2_kernel,
                               top2_reference)


def unit_rows(rng, n, d=128):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _kernel(a, b, mask=None, **kw):
    mask = jnp.ones(b.shape[0], bool) if mask is None else mask
    s1, i1, s2 = top2_kernel(a[None], b[None], mask[None],
                             jnp.zeros((1, 2), jnp.int32), interpret=True,
                             **kw)
    return s1[0], i1[0], s2[0]


def test_match_top2_parity_small(rng):
    a = jnp.asarray(unit_rows(rng, 64))
    b = jnp.asarray(unit_rows(rng, 256))
    s1, i1, s2 = _kernel(a, b, block_q=32, block_p=64)
    r1, j1, r2 = top2_reference(a, b, jnp.ones(256, bool))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(r1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(r2), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(j1))


def test_match_top2_with_planted_matches(rng):
    # plant near-duplicates across tile boundaries
    a = unit_rows(rng, 32)
    b = unit_rows(rng, 128)
    b[70] = a[3] + 0.01 * rng.standard_normal(128).astype(np.float32)
    b[70] /= np.linalg.norm(b[70])
    b[127] = a[31]
    s1, i1, s2 = _kernel(jnp.asarray(a), jnp.asarray(b), block_q=32,
                         block_p=32)
    assert int(i1[3]) == 70
    assert int(i1[31]) == 127
    assert float(s1[31]) > 0.999


def test_streaming_matcher_agrees_with_dense(rng):
    """match_float_streaming == match_float (minus cross-check) on valid rows."""
    n_pts = 200
    base = unit_rows(rng, n_pts)
    noise = 0.05
    Ka, Kb = 96, 160
    da = np.zeros((Ka, 128), np.float32)
    db = np.zeros((Kb, 128), np.float32)
    ma = np.zeros(Ka, bool)
    mb = np.zeros(Kb, bool)
    ia = rng.permutation(n_pts)[:80]
    ib = rng.permutation(n_pts)[:150]
    da[:80] = base[ia] + noise * rng.standard_normal((80, 128)).astype(np.float32)
    db[:150] = base[ib] + noise * rng.standard_normal((150, 128)).astype(np.float32)
    da[:80] /= np.linalg.norm(da[:80], axis=1, keepdims=True)
    db[:150] /= np.linalg.norm(db[:150], axis=1, keepdims=True)
    ma[:80] = True
    mb[:150] = True

    res_s = match_float_streaming(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        ratio=0.8)
    res_d = matching.match_float(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        ratio=0.8, cross_check=False,
    )
    vs, vd = np.asarray(res_s.valid), np.asarray(res_d.valid)
    # masked candidates score NEG in both: the accept sets are identical
    np.testing.assert_array_equal(vs, vd)
    np.testing.assert_array_equal(np.asarray(res_s.idx)[vs],
                                  np.asarray(res_d.idx)[vd])
