"""Perspective-n-Point: DLT minimal solver + Gauss-Newton refinement.

Capability parity: OpenCV's ``solvePnPRansac`` (P3P/EPnP hypotheses + LM
refine) used by the reference's localizer and OpenMVG's resection step.

Design: the minimal solver is a 6-point DLT — one 12x12 symmetric
eigenproblem per hypothesis — chosen over P3P because it is branch-free and
vmaps to thousands of RANSAC hypotheses with no quartic root-finding; the
larger sample size is paid for with hypothesis count, which is nearly free
on an accelerator.  Refinement is fixed-iteration Gauss-Newton on the masked
inlier set (6x6 normal equations).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import se3

MIN_SAMPLE = 6


def dlt_pnp(xn: jax.Array, X: jax.Array, mask: jax.Array):
    """Direct linear transform camera resection.

    Args:
      xn: (N,2) undistorted normalized image coords.
      X:  (N,3) world points.
      mask: (N,) bool valid correspondences (need >=6 non-degenerate).

    Returns (R, t) world-to-camera with R in SO(3).
    """
    w = mask.astype(X.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    # Condition world points: zero-mean, unit RMS scale.
    muX = jnp.sum(X * w[:, None], axis=0) / n
    Xc = X - muX
    rms = jnp.sqrt(jnp.sum(jnp.sum(Xc * Xc, axis=1) * w) / n)
    sX = 1.0 / jnp.maximum(rms, 1e-12)
    Xs = Xc * sX

    x, y = xn[:, 0], xn[:, 1]
    Xh = jnp.concatenate([Xs, jnp.ones_like(Xs[:, :1])], axis=1)  # (N,4)
    zeros = jnp.zeros_like(Xh)
    # Rows: [X 0 -x*X ; 0 X -y*X] for P (3,4) row-major 12-vector.
    r0 = jnp.concatenate([Xh, zeros, -x[:, None] * Xh], axis=1)  # (N,12)
    r1 = jnp.concatenate([zeros, Xh, -y[:, None] * Xh], axis=1)
    A = jnp.concatenate([r0 * w[:, None], r1 * w[:, None]], axis=0)  # (2N,12)
    AtA = A.T @ A
    # inverse iteration beats a full 12x12 eigh by ~an order of magnitude in
    # the vmapped RANSAC hot path (thousands of independent solves); the
    # exact-eigh breakdown fallback must stay OFF here — under vmap it would
    # run for every hypothesis (lax.cond -> select)
    from .linalg import smallest_eigvec_spd

    p = smallest_eigvec_spd(AtA, exact_fallback=False)
    P = p.reshape(3, 4)
    M = P[:, :3]
    # Recover scale/sign: s.t. M/s is a rotation and depths are positive.
    # For M near a scaled rotation sQ, ||M||_F = s*sqrt(3) — avoids an SVD.
    scale = jnp.linalg.norm(M) / jnp.sqrt(jnp.asarray(3.0, M.dtype))
    sign = jnp.sign(jnp.sum((Xs @ M[2, :].T + P[2, 3]) * w))  # majority depth sign
    sign = jnp.where(sign == 0, 1.0, sign)
    Mn = M * (sign / jnp.maximum(scale, 1e-12))
    R = se3.project_to_so3_fast(Mn)
    t_s = P[:, 3] * (sign / jnp.maximum(scale, 1e-12))
    # Undo world conditioning: xn ~ R*(sX*(X-muX)) + t_s  =>  t = t_s/sX... careful:
    # R @ Xs + t_s = R sX (X - muX) + t_s; want R X + t => divide by sX:
    t = t_s / sX - R @ muX
    return R, t


def dlt_pnp_minimal(xn: jax.Array, X: jax.Array):
    """Minimal-sample entry for RANSAC: all rows valid (shape (6,...))."""
    return dlt_pnp(xn, X, jnp.ones(xn.shape[0], dtype=bool))


def pnp_residual(R, t, xn, X):
    """Normalized-coordinate reprojection residual, (N,2)."""
    Xc = X @ R.T + t
    z = Xc[:, 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return Xc[:, :2] / zsafe[:, None] - xn


def refine_pnp_gn(R, t, xn, X, mask, iters: int = 10, damping: float = 1e-6):
    """Fixed-iteration Gauss-Newton on SE(3) (left-perturbation parameterization)."""
    w = mask.astype(X.dtype)

    def step(carry, _):
        R, t = carry

        def resid(delta):
            R2, t2 = se3.perturb(R, t, delta)
            r = pnp_residual(R2, t2, xn, X) * w[:, None]
            return r.reshape(-1)

        zero = jnp.zeros(6, dtype=X.dtype)
        r0 = resid(zero)
        J = jax.jacfwd(resid)(zero)  # (2N,6)
        H = J.T @ J + damping * jnp.eye(6, dtype=X.dtype)
        g = J.T @ r0
        delta = -jnp.linalg.solve(H, g)
        R2, t2 = se3.perturb(R, t, delta)
        # Accept only if cost decreases (guards divergence on outlier-heavy sets).
        c0 = jnp.sum(r0 * r0)
        r2 = pnp_residual(R2, t2, xn, X) * w[:, None]
        c2 = jnp.sum(r2 * r2)
        better = c2 < c0
        Rn = jnp.where(better, R2, R)
        tn = jnp.where(better, t2, t)
        return (Rn, tn), c2

    (R, t), _ = jax.lax.scan(step, (R, t), None, length=iters)
    return R, t
