"""Small-matrix linear-algebra helpers tuned for large vmapped batches."""
from __future__ import annotations

import jax
import jax.numpy as jnp


def smallest_eigvec_spd(A: jax.Array, iters: int = 6, shift: float = 1e-8,
                        exact_fallback: bool = True) -> jax.Array:
    """Smallest eigenvector of a symmetric PSD matrix via inverse iteration.

    One Cholesky + `iters` triangular solves — far cheaper than a full
    `eigh` for the (9x9 / 12x12) normal matrices inside vmapped RANSAC
    minimal solvers, where thousands of independent systems run at once and
    a clean minimal sample has a large eigen-gap (fast convergence).
    Degenerate samples converge slowly and simply yield a bad hypothesis,
    which RANSAC scoring discards — exactness there buys nothing.

    exact_fallback: on Cholesky breakdown (singular-ish A) recover with a
    full ``eigh``.  MUST be False inside vmapped RANSAC hot paths: under
    vmap ``lax.cond`` lowers to ``select`` and the eigh branch would execute
    for EVERY hypothesis (measured 8x slowdown of the whole localize path);
    there a finite garbage vector is returned instead, which scores zero
    inliers and is discarded.
    """
    n = A.shape[-1]
    tr = jnp.trace(A) / n
    M = A + (shift * tr + 1e-20) * jnp.eye(n, dtype=A.dtype)
    L = jnp.linalg.cholesky(M)
    # deterministic start vector with components in every eigenspace
    v0 = jnp.ones((n,), A.dtype) / jnp.sqrt(jnp.asarray(n, A.dtype))

    def body(_, v):
        y = jax.scipy.linalg.cho_solve((L, True), v)
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v0)
    # Cholesky of a singular-ish matrix can produce NaN
    bad = ~jnp.all(jnp.isfinite(v))
    if not exact_fallback:
        return jnp.where(bad, v0, v)

    def fallback(_):
        _, V = jnp.linalg.eigh(A)
        return V[:, 0]

    return jax.lax.cond(bad, fallback, lambda _: v, None)
