"""Pair matcher through the top-2 kernel (interpret mode) vs the dense
plain matcher.

The kernel path must reproduce ``matching.match_pairs_float``'s accept set
and winners: masked candidates score NEG in both, and the cross-check is a
second kernel call with A and B swapped.
"""
import numpy as np
import jax.numpy as jnp

from sfmx.kernels import matching


def _descs(rng, C=6, K=256, D=128):
    d = rng.standard_normal((C, K, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d


def _kernel(d, masks, pairs):
    return matching.match_pairs_float_kernel(
        jnp.asarray(d), jnp.asarray(masks), jnp.asarray(pairs),
        interpret=True)


def test_pairs_kernel_parity_full_masks(rng):
    d = _descs(rng)
    # plant true correspondences between images 0 and 1 so accepts exist
    d[1, :64] = d[0, :64] + 0.05 * rng.standard_normal((64, 128)).astype(np.float32)
    d[1] /= np.linalg.norm(d[1], axis=-1, keepdims=True)
    masks = np.ones(d.shape[:2], bool)
    pairs = np.asarray([[0, 1], [2, 3], [1, 4]], np.int32)

    ref = matching.match_pairs_float(jnp.asarray(d), jnp.asarray(masks),
                                     jnp.asarray(pairs))
    got = _kernel(d, masks, pairs)
    ref_v, got_v = np.asarray(ref.valid), np.asarray(got.valid)
    assert np.asarray(ref.valid[0]).sum() > 32  # the planted matches accept
    # identical accept set and identical winners on accepted rows
    np.testing.assert_array_equal(ref_v, got_v)
    np.testing.assert_array_equal(np.asarray(ref.idx)[ref_v],
                                  np.asarray(got.idx)[got_v])


def test_pairs_kernel_masked_conservative(rng):
    d = _descs(rng, C=4)
    d[1, :48] = d[0, :48]
    d[1] /= np.linalg.norm(d[1], axis=-1, keepdims=True)
    masks = rng.random(d.shape[:2]) > 0.3
    pairs = np.asarray([[0, 1], [2, 3]], np.int32)

    ref = matching.match_pairs_float(jnp.asarray(d), jnp.asarray(masks),
                                     jnp.asarray(pairs))
    got = _kernel(d, masks, pairs)
    ref_v, got_v = np.asarray(ref.valid), np.asarray(got.valid)
    np.testing.assert_array_equal(ref_v, got_v)
    np.testing.assert_array_equal(np.asarray(ref.idx)[ref_v],
                                  np.asarray(got.idx)[got_v])
    assert ref_v.sum() > 16
    # masked query rows are never accepted
    mask_a = masks[pairs[:, 0]]
    assert not np.any(got_v & ~mask_a)
