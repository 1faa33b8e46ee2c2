"""Epipolar geometry: normalized 8-point F/E, pose-from-E, Sampson scoring.

Capability parity: OpenMVG's geometric filtering (F/E ACRANSAC) during
matching and its two-view initializer (relative pose from E + cheirality
disambiguation).  Design: every solver consumes a fixed-capacity masked
correspondence set and is built from small symmetric eigenproblems
(9x9 / 3x3 ``eigh``) so it vmaps across thousands of RANSAC hypotheses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _hartley_normalize(x: jax.Array, mask: jax.Array):
    """Similarity-normalize 2D points to zero mean, sqrt(2) RMS radius."""
    w = mask.astype(x.dtype)[:, None]
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(x * w, axis=0) / n
    xc = (x - mu) * w
    rms = jnp.sqrt(jnp.sum(xc * xc) / n)
    s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-12)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], x.dtype)
    T = T.at[0, 0].set(s).at[1, 1].set(s).at[0, 2].set(-s * mu[0]).at[1, 2].set(-s * mu[1])
    return (x - mu) * s, T


def eight_point(x1: jax.Array, x2: jax.Array, mask: jax.Array, essential: bool = False) -> jax.Array:
    """Normalized 8-point algorithm.

    Args:
      x1, x2: (N,2) corresponding points (pixels for F, normalized cam coords
        for E). N may exceed 8 — masked least squares over all valid rows.
      mask: (N,) bool.
      essential: if True enforce the (s,s,0) singular structure, else rank-2.

    Returns 3x3 matrix with x2^T M x1 = 0.
    """
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    one = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=1)
    A = A * mask.astype(A.dtype)[:, None]
    # Direct SVD of A (not eigh of A^T A, which squares the conditioning and
    # costs ~3 digits of f32 accuracy in the recovered epipolar constraint).
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[8].reshape(3, 3)
    F = T2.T @ F @ T1
    # Structure enforcement AFTER denormalization: the Hartley similarities
    # do not commute with the singular-value structure (for E the equal-pair
    # constraint only holds in the original normalized-camera frame).
    U, D, Vt = jnp.linalg.svd(F)
    if essential:
        s = 0.5 * (D[0] + D[1])
        D = jnp.stack([s, s, jnp.zeros_like(s)])
    else:
        D = D.at[2].set(0.0)
    F = U @ jnp.diag(D) @ Vt
    # Scale-normalize for stable thresholding downstream.
    return F / jnp.maximum(jnp.linalg.norm(F), 1e-12)


def sampson_error(F: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) distance, (N,)."""
    ones = jnp.ones_like(x1[:, :1])
    p1 = jnp.concatenate([x1, ones], axis=1)  # (N,3)
    p2 = jnp.concatenate([x2, ones], axis=1)
    Fp1 = p1 @ F.T  # (N,3) = F @ p1
    Ftp2 = p2 @ F  # (N,3) = F^T @ p2
    num = jnp.sum(p2 * Fp1, axis=1) ** 2
    den = Fp1[:, 0] ** 2 + Fp1[:, 1] ** 2 + Ftp2[:, 0] ** 2 + Ftp2[:, 1] ** 2
    # a vanishing denominator means the point sits at the epipole or F is
    # degenerate (e.g. an all-zero solve) — that must REJECT, not accept:
    # num/max(den,eps) would return 0 for F=0 and admit every match
    return jnp.where(den > 1e-18, num / jnp.maximum(den, 1e-18), jnp.inf)


_W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def decompose_essential(E: jax.Array):
    """E -> 4 candidate (R, t) with ||t||=1. Caller disambiguates by cheirality."""
    U, _, Vt = jnp.linalg.svd(E)
    # Make proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = _W.astype(E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def relative_pose_from_essential(E: jax.Array, xn1: jax.Array, xn2: jax.Array, mask: jax.Array):
    """Select the (R,t) among the 4 E-decompositions maximizing front-of-both-cameras count.

    Camera 1 is identity; returns world-to-cam2 (R, t) with unit baseline,
    plus the winning in-front count.
    """
    from .triangulate import triangulate_two_view

    Rs, ts = decompose_essential(E)
    I3 = jnp.eye(3, dtype=E.dtype)
    z3 = jnp.zeros(3, dtype=E.dtype)

    def score(R, t):
        X, ok = triangulate_two_view(I3, z3, R, t, xn1, xn2)
        return jnp.sum((ok & mask).astype(jnp.int32)), X

    counts, Xs = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], counts[best], Xs[best]


# ---------------------------------------------------------------------------
# Batched SVD-free 8-point: the geometric-verification hot path
# ---------------------------------------------------------------------------
# `eight_point` above runs TWO jnp.linalg.svd per call; vmapped over
# (pairs x hypotheses) that is ~10^5 small SVDs per build chunk, which XLA
# lowers to slow iterative device loops.  RANSAC hypothesis
# generation doesn't need SVD accuracy: here the null vector of the 8-point
# system comes from an unrolled 9x9 Cholesky + inverse iteration on the
# normal matrix A^T A, every step a component-wise op over the batch lane
# axis — no linalg primitive anywhere, so the whole (Np*H)-hypothesis batch
# compiles to a handful of fused elementwise kernels.  The squared conditioning
# costs ~3 f32 digits vs direct SVD, which is irrelevant for hypothesis
# SCORING; winners are re-fit with the weighted variant and (for E) get the
# (s,s,0) structure enforced once per pair.


def _chol9_solve(M, b, eps_rel: float = 1e-7):
    """Solve (M + eps*I) x = b for a batch of symmetric 9x9 systems.

    M: 9x9 nested list of (B,) components (symmetric; lower triangle read).
    b: list of 9 (B,) components.  Returns list of 9 (B,) components.
    Unrolled Cholesky — 45 lane-wide rsqrt/fma chains, no linalg calls.
    """
    tr = sum(M[i][i] for i in range(9))
    eps = eps_rel * tr / 9.0 + 1e-20
    L = [[None] * 9 for _ in range(9)]
    for j in range(9):
        d = M[j][j] + eps - sum(L[j][k] * L[j][k] for k in range(j))
        inv = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
        L[j][j] = 1.0 / inv
        for i in range(j + 1, 9):
            off = M[i][j] - sum(L[i][k] * L[j][k] for k in range(j))
            L[i][j] = off * inv
    y = [None] * 9
    for i in range(9):
        y[i] = (b[i] - sum(L[i][k] * y[k] for k in range(i))) / L[i][i]
    x = [None] * 9
    for i in reversed(range(9)):
        x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, 9))) / L[i][i]
    return x


def eight_point_batch(x1: jax.Array, x2: jax.Array, w: jax.Array,
                      n_iter: int = 2) -> jax.Array:
    """Weighted 8-point over a batch: (B,N,2),(B,N,2),(B,N) -> F (B,3,3).

    Component-wise Hartley normalization, normal matrix M = A^T W A, and
    ``n_iter`` damped inverse-iteration steps (each one `_chol9_solve`)
    recover the null direction.  ||F||_F = 1.  Works for minimal samples
    (N=8, w=1) and weighted least-squares refits alike; rank-2 / essential
    structure is NOT enforced (callers enforce on winners only).
    """
    w = w.astype(x1.dtype)
    n = jnp.maximum(jnp.sum(w, axis=1), 1.0)                       # (B,)

    def norm(x):
        mu = jnp.sum(x * w[..., None], axis=1) / n[:, None]        # (B,2)
        xc = (x - mu[:, None, :]) * w[..., None]
        rms = jnp.sqrt(jnp.sum(xc * xc, axis=(1, 2)) / n)
        # rms floor 1e-4 (not 1e-12): a (near-)coincident degenerate sample
        # would otherwise scale coords by ~1e12, overflow M to inf in f32
        # and collapse the solve to F=0
        s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-4)                 # (B,)
        return (x - mu[:, None, :]) * s[:, None, None], mu, s

    x1n, mu1, s1 = norm(x1)
    x2n, mu2, s2 = norm(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]                              # (B,N)
    u2, v2 = x2n[..., 0], x2n[..., 1]
    one = jnp.ones_like(u1)
    a = [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one]
    M = [[None] * 9 for _ in range(9)]
    for i in range(9):
        for j in range(i + 1):
            M[i][j] = M[j][i] = jnp.sum(w * a[i] * a[j], axis=1)   # (B,)
    B = u1.shape[0]
    v = [jnp.full((B,), 1.0 / 3.0, x1.dtype) for _ in range(9)]
    for _ in range(n_iter):
        v = _chol9_solve(M, v)
        nv = jax.lax.rsqrt(sum(c * c for c in v) + 1e-30)
        v = [c * nv for c in v]
    # denormalize F = T2^T Fn T1 (T similarity transforms), component-wise
    f = [v[3 * r + c] for r in range(3) for c in range(3)]
    g = [s2 * f[0], s2 * f[1], s2 * f[2],
         s2 * f[3], s2 * f[4], s2 * f[5], None, None, None]
    m2x, m2y = mu2[:, 0] * s2, mu2[:, 1] * s2
    g[6] = -m2x * f[0] - m2y * f[3] + f[6]
    g[7] = -m2x * f[1] - m2y * f[4] + f[7]
    g[8] = -m2x * f[2] - m2y * f[5] + f[8]
    m1x, m1y = mu1[:, 0] * s1, mu1[:, 1] * s1
    F = [None] * 9
    for r in range(3):
        F[3 * r + 0] = s1 * g[3 * r + 0]
        F[3 * r + 1] = s1 * g[3 * r + 1]
        F[3 * r + 2] = (-m1x * g[3 * r + 0] - m1y * g[3 * r + 1]
                        + g[3 * r + 2])
    nf = jax.lax.rsqrt(sum(c * c for c in F) + 1e-30)
    Fm = jnp.stack([c * nf for c in F], axis=-1).reshape(B, 3, 3)
    return Fm


def enforce_essential_batch(F: jax.Array) -> jax.Array:
    """(B,3,3) -> nearest essential matrices ((s,s,0) singular structure)."""
    def one(Fi):
        U, D, Vt = jnp.linalg.svd(Fi)
        s = 0.5 * (D[0] + D[1])
        E = U @ jnp.diag(jnp.stack([s, s, jnp.zeros_like(s)])) @ Vt
        return E / jnp.maximum(jnp.linalg.norm(E), 1e-12)

    return jax.vmap(one)(F)


def sampson_error_batch(F: jax.Array, x1: jax.Array, x2: jax.Array):
    """Sampson distance, batched over hypotheses: F (...,3,3), x1/x2
    (B,N,2) broadcast against leading F dims -> (...,N)."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Fp1 = jnp.einsum("...ij,...nj->...ni", F, p1)
    Ftp2 = jnp.einsum("...ji,...nj->...ni", F, p2)
    num = jnp.sum(p2 * Fp1, axis=-1) ** 2
    den = (Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2
           + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2)
    # degenerate denominator (epipole hit / zero F) REJECTS — see
    # sampson_error
    return jnp.where(den > 1e-18, num / jnp.maximum(den, 1e-18), jnp.inf)
