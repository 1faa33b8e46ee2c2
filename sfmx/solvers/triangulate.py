"""DLT triangulation: two-view and masked N-view, fully vmapped.

Capability parity: OpenMVG's ``TriangulateDLT`` / N-view triangulation used
inside the incremental engine.  Design: one fused path that triangulates
a whole batch of tracks at once — each track has up to ``V`` observing views
(static capacity, mask for real ones); the per-track 4x4 normal matrix is
built by a masked sum over views and solved by symmetric eigendecomposition
(``eigh``; general SVD of tall matrices is avoided).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _dlt_rows(P: jax.Array, xn: jax.Array) -> jax.Array:
    """Two DLT rows for one observation. P: (3,4) projection, xn: (2,) normalized."""
    r0 = xn[0] * P[2] - P[0]
    r1 = xn[1] * P[2] - P[1]
    return jnp.stack([r0, r1])  # (2,4)


def triangulate_nview(Ps: jax.Array, xns: jax.Array, mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Triangulate one point from up to V views.

    Args:
      Ps:   (V,3,4) projection matrices (normalized coords: P = [R|t]).
      xns:  (V,2) normalized image coords.
      mask: (V,) bool — which views actually observe the point.

    Returns: (X (3,), ok) where ok requires >=2 valid views.
    """
    rows = jax.vmap(_dlt_rows)(Ps, xns)  # (V,2,4)
    w = mask.astype(Ps.dtype)[:, None, None]
    rows = rows * w
    A = rows.reshape(-1, 4)  # (2V,4)
    # Normal matrix route: smallest eigenvector of A^T A (4x4 symmetric).
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    Xh = V[:, 0]
    w_h = Xh[3]
    X = Xh[:3] / jnp.where(jnp.abs(w_h) < 1e-12, 1e-12, w_h)
    ok = jnp.sum(mask) >= 2
    return X, ok


# Batched over tracks: Ps (N,V,3,4), xns (N,V,2), mask (N,V) -> X (N,3), ok (N,)
triangulate_nview_b = jax.vmap(triangulate_nview)


def triangulate_two_view(R1, t1, R2, t2, xn1, xn2):
    """Batch two-view DLT. xn1, xn2: (N,2) normalized coords.

    Returns X (N,3) world points and a cheirality+parallax validity mask.
    """
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)  # (3,4)
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)
    n = xn1.shape[0]
    Ps = jnp.broadcast_to(jnp.stack([P1, P2]), (n, 2, 3, 4))
    xns = jnp.stack([xn1, xn2], axis=1)  # (N,2,2)
    mask = jnp.ones((n, 2), dtype=bool)
    X, _ = triangulate_nview_b(Ps, xns, mask)
    ok = cheirality(R1, t1, X) & cheirality(R2, t2, X)
    return X, ok


def cheirality(R, t, X, min_depth=1e-4, max_depth=1e6):
    """Positive-depth test in a camera. X: (...,3)."""
    z = (X @ R.T + t)[..., 2]
    return (z > min_depth) & (z < max_depth)


def parallax_deg(c1, c2, X):
    """Triangulation angle in degrees at point X between camera centers c1,c2."""
    a = c1 - X
    b = c2 - X
    an = jnp.linalg.norm(a, axis=-1)
    bn = jnp.linalg.norm(b, axis=-1)
    cosang = jnp.sum(a * b, axis=-1) / jnp.maximum(an * bn, 1e-12)
    return jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
