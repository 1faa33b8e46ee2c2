"""Batched-hypothesis RANSAC: all minimal samples drawn and scored at once.

Capability parity: OpenMVG's ACRANSAC / OpenCV's RANSAC loops, which iterate
sequentially with data-dependent early exit.  Design (SURVEY.md §7.4):
draw a static number K of minimal samples up front, vmap the minimal solver
over all K, score all hypotheses against all data in one (K,N) pass, argmax.
No data-dependent trip counts, no host round-trips; K replaces the adaptive
iteration schedule (K=512-2048 covers inlier ratios well below anything the
sequential loop would survive).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def sample_minimal(key: jax.Array, mask: jax.Array, k_hyp: int, sample_size: int) -> jax.Array:
    """Draw k_hyp minimal samples (without replacement) among valid indices.

    Gumbel-top-k trick: per hypothesis, add iid Gumbel noise to log(mask) and
    take the top ``sample_size`` — a uniform without-replacement sample of the
    valid entries, fully batched. Returns (k_hyp, sample_size) int32 indices.
    """
    n = mask.shape[0]
    g = jax.random.gumbel(key, (k_hyp, n))
    scores = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, sample_size)
    return idx


def ransac(
    key: jax.Array,
    solver: Callable,
    residual_fn: Callable,
    data: tuple,
    mask: jax.Array,
    *,
    k_hypotheses: int = 1024,
    sample_size: int,
    inlier_threshold: float,
    n_candidates: int = 1,
):
    """Generic batched RANSAC.

    Args:
      solver: (sampled_data...) -> model pytree. vmapped over hypotheses.
        With n_candidates > 1 the solver returns a pytree whose leaves carry
        a leading candidate axis (multi-root minimal solvers like P3P); all
        candidates join the hypothesis pool and argmax selects across them.
      residual_fn: (model, data...) -> (N,) nonnegative residuals.
      data: tuple of (N,...) arrays; rows are correspondences.
      mask: (N,) bool — valid correspondences.

    Returns (best_model, inlier_mask, best_count).
    """
    idx = sample_minimal(key, mask, k_hypotheses, sample_size)

    def solve_one(sample_idx):
        sampled = tuple(d[sample_idx] for d in data)
        return solver(*sampled)

    models = jax.vmap(solve_one)(idx)  # pytree with leading k_hyp axis
    if n_candidates > 1:
        models = jax.tree_util.tree_map(
            lambda x: x.reshape((k_hypotheses * n_candidates,) + x.shape[2:]),
            models)

    def score_one(model):
        r = residual_fn(model, *data)
        inl = (r < inlier_threshold) & mask
        return jnp.sum(inl.astype(jnp.int32))

    counts = jax.vmap(score_one)(models)
    best = jnp.argmax(counts)
    best_model = jax.tree_util.tree_map(lambda x: x[best], models)
    r = residual_fn(best_model, *data)
    inliers = (r < inlier_threshold) & mask
    return best_model, inliers, counts[best]
