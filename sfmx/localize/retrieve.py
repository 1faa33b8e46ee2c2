"""Image retrieval (C8): visual vocabulary + VLAD global descriptors.

Capability parity: the reference restricts query matching to likely map
keyframes with a BoW-style visual vocabulary (SURVEY C8).  Design: a
small k-means vocabulary (built once per map, jitted Lloyd iterations) and
VLAD aggregation — residuals-to-assigned-word sums via one-hot GEMM — give a
(V*D) global descriptor whose scoring against all keyframes is a single
GEMM.  Much sharper than mean-pooling local descriptors (tested) while
keeping retrieval one matmul.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n_words", "iters"))
def build_vocabulary(desc: jax.Array, mask: jax.Array, key: jax.Array, *,
                     n_words: int = 16, iters: int = 15) -> jax.Array:
    """k-means over unit descriptors (cosine Lloyd's). desc (N,D), mask (N,).

    Returns (n_words, D) unit-norm centroids.
    """
    N, D = desc.shape
    # farthest-point (k-means++-style) seeding: random first word, then
    # repeatedly take the valid point least similar to any chosen word —
    # random seeding routinely drops a cluster and splits another.
    first = jax.random.choice(key, N, p=mask.astype(jnp.float32) / jnp.maximum(mask.sum(), 1))
    C0 = jnp.zeros((n_words, D), desc.dtype).at[0].set(desc[first])

    def seed_step(i, C):
        sim = desc @ C.T                               # (N,V)
        active = jax.lax.broadcasted_iota(jnp.int32, sim.shape, 1) < i
        best = jnp.max(jnp.where(active, sim, -jnp.inf), axis=1)
        cand = jnp.argmin(jnp.where(mask, best, jnp.inf))
        return C.at[i].set(desc[cand])

    C = jax.lax.fori_loop(1, n_words, seed_step, C0)

    def step(C, _):
        sim = desc @ C.T                               # (N,V)
        a = jnp.argmax(sim, axis=1)
        onehot = jax.nn.one_hot(a, n_words, dtype=desc.dtype) * mask[:, None]
        sums = onehot.T @ desc                          # (V,D)
        counts = jnp.sum(onehot, axis=0)[:, None]
        C2 = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), C)
        C2 = C2 / jnp.maximum(jnp.linalg.norm(C2, axis=1, keepdims=True), 1e-8)
        return C2, None

    C, _ = jax.lax.scan(step, C, None, length=iters)
    return C


def vlad_encode(desc: jax.Array, mask: jax.Array, vocab: jax.Array) -> jax.Array:
    """VLAD: per-word sum of residuals, intra-normalized. -> (V*D,) unit vec.

    Batched over leading dims via vmap at call sites.
    """
    V, D = vocab.shape
    sim = desc @ vocab.T                               # (K,V)
    a = jnp.argmax(sim, axis=1)
    onehot = jax.nn.one_hot(a, V, dtype=desc.dtype) * mask[:, None]
    sums = onehot.T @ desc                             # (V,D) residual part 1
    counts = jnp.sum(onehot, axis=0)[:, None]
    resid = sums - counts * vocab                      # sum(d - c_word)
    # intra-normalization (power-law burstiness suppression)
    resid = resid / jnp.maximum(jnp.linalg.norm(resid, axis=1, keepdims=True), 1e-8)
    v = resid.reshape(V * D)
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-8)


vlad_encode_b = jax.vmap(vlad_encode, in_axes=(0, 0, None))


def retrieval_scores(kf_vlad: jax.Array, q_vlad: jax.Array) -> jax.Array:
    """(C,VD) x (VD,) -> (C,) cosine scores (one GEMV/MXU pass)."""
    return kf_vlad @ q_vlad


def recall_at_k(kf_gdesc: jax.Array, kf_centers: jax.Array,
                kf_alive: jax.Array, q_gdesc: jax.Array,
                q_centers: jax.Array, k: int = 8,
                radius: float | None = None) -> float:
    """Retrieval quality metric (SURVEY C8): fraction of queries for which
    the top-k retrieval surfaces a spatially co-located keyframe — the
    retrieval's whole job (VERDICT r3 item 7).

    radius: a hit = some retrieved keyframe center lies within ``radius``
    of the query's true position.  None auto-sizes it to
    max(3x the nearest-keyframe distance, 4x median keyframe spacing):
    on densely sampled walkthroughs (mm-scale frame spacing) hundreds of
    keyframes are visually identical, so "THE single nearest frame in
    top-k" is near-chance by construction and measures nothing — any
    same-spot keyframe serves 2D-3D matching equally well.
    """
    kf_g = np.asarray(kf_gdesc)
    alive = np.asarray(kf_alive)
    kfc = np.asarray(kf_centers)
    qc = np.asarray(q_centers)
    scores = np.asarray(q_gdesc) @ kf_g.T                # (Q,C)
    scores[:, ~alive] = -np.inf
    d = np.sqrt(np.sum((qc[:, None] - kfc[None]) ** 2, -1))
    d[:, ~alive] = np.inf
    if radius is None:
        ai = np.flatnonzero(alive)
        if len(ai) > 4096:  # spacing estimate from a subsample (O(n^2) mem)
            ai = ai[:: len(ai) // 4096 + 1]
        if len(ai) > 1:
            kd = np.sqrt(np.sum((kfc[ai][:, None] - kfc[ai][None]) ** 2, -1))
            np.fill_diagonal(kd, np.inf)
            spacing = float(np.median(kd.min(axis=1)))
        else:
            spacing = 0.0
        radius = np.maximum(3.0 * d.min(axis=1), 4.0 * spacing)  # (Q,)
    kk = min(k, int(alive.sum()))
    topk = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
    d_top = np.take_along_axis(d, topk, axis=1)          # (Q,kk)
    hit = (d_top <= np.asarray(radius).reshape(-1, 1)
           if np.ndim(radius) else d_top <= radius).any(axis=1)
    return float(hit.mean())


def strict_recall_at_k(kf_gdesc: jax.Array, kf_centers: jax.Array,
                       kf_alive: jax.Array, q_gdesc: jax.Array,
                       q_centers: jax.Array, k: int = 8) -> float:
    """STRICT recall (VERDICT r4 item 7): fraction of queries whose single
    spatially-NEAREST alive keyframe appears in the retrieval top-k.

    On mm-spaced walkthroughs this is near-chance by construction (hundreds
    of keyframes are visually identical) — report it alongside
    :func:`recall_at_k` anyway: on visually-diverse maps (multi-room
    corridors, config-5 city blocks) rooms ARE distinguishable and a poor
    strict number exposes an under-capacity vocabulary.
    """
    kf_g = np.asarray(kf_gdesc)
    alive = np.asarray(kf_alive)
    kfc = np.asarray(kf_centers)
    qc = np.asarray(q_centers)
    scores = np.asarray(q_gdesc) @ kf_g.T
    scores[:, ~alive] = -np.inf
    d = np.sqrt(np.sum((qc[:, None] - kfc[None]) ** 2, -1))
    d[:, ~alive] = np.inf
    nearest = d.argmin(axis=1)                           # (Q,)
    kk = min(k, int(alive.sum()))
    topk = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
    return float((topk == nearest[:, None]).any(axis=1).mean())
