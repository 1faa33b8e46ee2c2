"""Intrinsics refinement (self-calibration) — alternating GN step.

Capability parity: OpenMVG's ``Bundle_Adjustment_Ceres`` refines intrinsics
(focal, principal point, distortion) together with poses by default; maps
built from EXIF-free images start from a guessed focal (ingest uses
f = 1.2*max(w,h)) and need this to converge to metric-quality geometry.

Design: rather than widening the Schur system with global columns
(intrinsics couple every camera sharing them), refinement alternates with
the pose/point LM: holding geometry fixed, each intrinsics group solves an
independent <=5x5 GN system assembled with one segment_sum over its
observations — trivially batched over groups, no change to the Schur
structure.  Alternation converges fast because intrinsics<->geometry
coupling is weak after the first BA round.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import cameras

# which components of the length-7 intrinsics vector are refined
# [fx, fy, cx, cy, k1, k2, k3] — fx==fy enforced via a shared focal delta
PARAM_SPEC = {
    "f": (0, 1),      # shared focal
    "cx": (2,),
    "cy": (3,),
    "k1": (4,),
    "k2": (5,),
}


def _delta_to_intr(k, delta, params):
    """Apply a small parameter vector delta (len(params),) to intrinsics k."""
    out = k
    for i, name in enumerate(params):
        for comp in PARAM_SPEC[name]:
            out = out.at[comp].add(delta[i])
    return out


@partial(jax.jit, static_argnames=("params", "iters"))
def refine_intrinsics_gn(
    intr: jax.Array,      # (I,7)
    k_idx: jax.Array,     # (C,)
    R: jax.Array, t: jax.Array, X: jax.Array,
    cam_id: jax.Array, pt_id: jax.Array, uv: jax.Array, w: jax.Array,
    *, params: tuple = ("f", "k1"), iters: int = 3, damping: float = 1e-3,
):
    """GN on the intrinsics table with geometry held fixed.

    Returns the refined (I,7) table.  Residuals are focal-normalized like
    the BA's; each group's system is assembled by segment_sum over its
    observations (obs -> group via k_idx[cam_id]).
    """
    I = intr.shape[0]
    n_p = len(params)
    group = k_idx[cam_id]  # (O,)

    def gn_iter(intr, _):
        f_ref = jnp.mean(0.5 * (intr[:, 0] + intr[:, 1]))

        def one(kc, Rc, tc, Xp, uv_o):
            def f(d):
                k2 = _delta_to_intr(kc, d, params)
                return cameras.reprojection_residual(k2, Rc, tc, Xp, uv_o) / f_ref

            zero = jnp.zeros(n_p, intr.dtype)
            r = f(zero)
            J = jax.jacfwd(f)(zero)  # (2, n_p)
            return r, J

        ko = intr[group]
        r, J = jax.vmap(one)(ko, R[cam_id], t[cam_id], X[pt_id], uv)
        ws = w[:, None, None]
        H_o = jnp.einsum("oik,oil->okl", J * ws, J)      # (O,n_p,n_p)
        g_o = jnp.einsum("oik,oi->ok", J * ws, r)        # (O,n_p)
        H = jax.ops.segment_sum(H_o, group, num_segments=I)
        g = jax.ops.segment_sum(g_o, group, num_segments=I)
        # multiplicative damping: focal (pixels) and distortion (unitless)
        # differ by ~3 orders of magnitude — absolute damping cripples one
        d = jnp.diagonal(H, axis1=-2, axis2=-1)
        H = H + jnp.eye(n_p, dtype=intr.dtype) * (damping * d + 1e-12)[..., None, :]
        delta = -jnp.linalg.solve(H, g[..., None])[..., 0]  # (I,n_p)
        intr2 = jax.vmap(lambda k, d: _delta_to_intr(k, d, params))(intr, delta)

        # accept only if the global cost decreased (guards divergence)
        def cost(it):
            ko2 = it[group]
            rr = jax.vmap(cameras.reprojection_residual)(
                ko2, R[cam_id], t[cam_id], X[pt_id], uv)
            return jnp.sum(jnp.sum(rr * rr, -1) * w)

        better = cost(intr2) < cost(intr)
        return jnp.where(better, intr2, intr), None

    intr, _ = jax.lax.scan(gn_iter, intr, None, length=iters)
    return intr
