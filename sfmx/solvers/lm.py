"""Levenberg-Marquardt bundle adjustment over the flat observation table.

Capability parity: Ceres ``Solve`` with Huber loss + Schur elimination as
driven by OpenMVG's ``Bundle_Adjustment_Ceres`` (reference hot loop,
SURVEY.md §3.4).  Design: the whole LM iteration — residuals, analytic
Jacobians (via per-observation ``jacfwd``, vmapped), block assembly,
Schur reduction, PCG, back-substitution, trust-region accept/reject — is one
jitted function with static capacities; the outer iteration runs as a
``lax.scan`` so an entire BA solve is a single device program.

Gauge: the first alive camera is held fixed (mask); scale gauge is
controlled by LM damping.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import cameras, se3
from . import schur


class BAState(NamedTuple):
    R: jax.Array        # (C,3,3)
    t: jax.Array        # (C,3)
    X: jax.Array        # (P,3)
    lam: jax.Array      # () LM damping
    cost: jax.Array     # () robust cost at current params


def _residual_one(k, R, t, X, uv):
    """Focal-normalized reprojection residual (~= radians).

    Working in r_px / f instead of pixels keeps Jacobian entries O(1), which
    measurably lowers the f32 cancellation floor in the Schur assembly
    (SURVEY §7.4 'numerical precision'); costs/thresholds are normalized the
    same way so the optimum is unchanged.
    """
    f = 0.5 * (k[0] + k[1])
    return cameras.reprojection_residual(k, R, t, X, uv) / f


def _jacobians(intr, k_idx, R, t, X, cam_id, pt_id, uv):
    """Per-observation residual + Jacobians wrt (cam tangent 6, point 3)."""

    def one(kc, Rc, tc, Xp, uv_o):
        def f(p):
            R2, t2 = se3.perturb(Rc, tc, p[:6])
            return _residual_one(kc, R2, t2, Xp + p[6:9], uv_o)

        zero = jnp.zeros(9, dtype=X.dtype)
        r = f(zero)
        J = jax.jacfwd(f)(zero)  # (2,9)
        return r, J[:, :6], J[:, 6:9]

    ko = intr[k_idx[cam_id]]
    return jax.vmap(one)(ko, R[cam_id], t[cam_id], X[pt_id], uv)


def _jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv):
    """Analytic residual + Jacobians in PLANES layout: (O,2), (O,12), (O,6).

    Same math as ``_jacobians`` (parity-tested) but every intermediate is an
    (O,)-wide component array and every output is 2D with the O axis
    leading, instead of (O,2,6)/(O,2,9) blocks with two small minor dims.
    Column order of Jc: [du/d(w,t) (6) | dv/d(w,t) (6)];
    Jp: [du/dX (3) | dv/dX (3)] — consumed by ``schur.assemble_planes``.
    """
    ko = intr[k_idx[cam_id]]                 # (O,7) — 2D, fine
    Rf = R.reshape(-1, 9)[cam_id]            # (O,9) rows r00..r22
    tf = t[cam_id]                           # (O,3)
    Xf = X[pt_id]                            # (O,3)
    fx, fy = ko[:, 0], ko[:, 1]
    cx, cy = ko[:, 2], ko[:, 3]
    k1, k2, k3 = ko[:, 4], ko[:, 5], ko[:, 6]
    fm = 0.5 * (fx + fy)
    X0, X1, X2 = Xf[:, 0], Xf[:, 1], Xf[:, 2]
    # s = R X ;  Xc = s + t
    s0 = Rf[:, 0] * X0 + Rf[:, 1] * X1 + Rf[:, 2] * X2
    s1 = Rf[:, 3] * X0 + Rf[:, 4] * X1 + Rf[:, 5] * X2
    s2 = Rf[:, 6] * X0 + Rf[:, 7] * X1 + Rf[:, 8] * X2
    xc, yc, zc = s0 + tf[:, 0], s1 + tf[:, 1], s2 + tf[:, 2]
    zs = jnp.where(jnp.abs(zc) < 1e-9, 1e-9, zc)
    iz = 1.0 / zs
    xn, yn = xc * iz, yc * iz
    r2 = xn * xn + yn * yn
    fd = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    fp = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)      # d fd / d r2
    ru = (fx * (xn * fd) + cx - uv[:, 0]) / fm
    rv = (fy * (yn * fd) + cy - uv[:, 1]) / fm
    # 2x2 distortion+focal block A (already /fm)
    gx, gy = fx / fm, fy / fm
    A00 = gx * (fd + 2.0 * xn * xn * fp)
    A01 = gx * (2.0 * xn * yn * fp)
    A10 = gy * (2.0 * xn * yn * fp)
    A11 = gy * (fd + 2.0 * yn * yn * fp)
    # B = A @ d xn/d Xc   (2x3): B[i] = [Ai0, Ai1, -(Ai0 xn + Ai1 yn)] * iz
    B00, B01 = A00 * iz, A01 * iz
    B02 = -(A00 * xn + A01 * yn) * iz
    B10, B11 = A10 * iz, A11 * iz
    B12 = -(A10 * xn + A11 * yn) * iz
    # rotation columns: d Xc/d w_j = e_j x s
    # col0=(0,-s2,s1) col1=(s2,0,-s0) col2=(-s1,s0,0)
    Jc = jnp.stack([
        -B01 * s2 + B02 * s1, B00 * s2 - B02 * s0, -B00 * s1 + B01 * s0,
        B00, B01, B02,
        -B11 * s2 + B12 * s1, B10 * s2 - B12 * s0, -B10 * s1 + B11 * s0,
        B10, B11, B12,
    ], axis=-1)                                       # (O,12)
    # Jp = B @ R
    Jp = jnp.stack([
        B00 * Rf[:, 0] + B01 * Rf[:, 3] + B02 * Rf[:, 6],
        B00 * Rf[:, 1] + B01 * Rf[:, 4] + B02 * Rf[:, 7],
        B00 * Rf[:, 2] + B01 * Rf[:, 5] + B02 * Rf[:, 8],
        B10 * Rf[:, 0] + B11 * Rf[:, 3] + B12 * Rf[:, 6],
        B10 * Rf[:, 1] + B11 * Rf[:, 4] + B12 * Rf[:, 7],
        B10 * Rf[:, 2] + B11 * Rf[:, 5] + B12 * Rf[:, 8],
    ], axis=-1)                                       # (O,6)
    r = jnp.stack([ru, rv], axis=-1)                  # (O,2)
    return r, Jc, Jp


def huber_weight(r2: jax.Array, delta: float) -> jax.Array:
    """IRLS weight for Huber loss given squared residual norm."""
    rn = jnp.sqrt(jnp.maximum(r2, 1e-20))
    return jnp.where(rn <= delta, 1.0, delta / rn)


def robust_cost(r2: jax.Array, w_valid: jax.Array, delta: float) -> jax.Array:
    rn = jnp.sqrt(jnp.maximum(r2, 1e-20))
    rho = jnp.where(rn <= delta, r2, delta * (2.0 * rn - delta))
    return 0.5 * jnp.sum(rho * w_valid)


def _eval_cost(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, delta):
    ko = intr[k_idx[cam_id]]
    r = jax.vmap(_residual_one)(ko, R[cam_id], t[cam_id], X[pt_id], uv)
    r2 = jnp.sum(r * r, axis=-1)
    return robust_cost(r2, w_valid, delta)


@partial(jax.jit, static_argnames=("iters", "cg_iters", "tp_cap", "tc_cap",
                                   "return_lam"))
def ba_solve(
    intr: jax.Array,      # (I,7)
    k_idx: jax.Array,     # (C,) int32
    R: jax.Array,         # (C,3,3)
    t: jax.Array,         # (C,3)
    X: jax.Array,         # (P,3)
    cam_id: jax.Array,    # (O,) int32
    pt_id: jax.Array,     # (O,) int32
    uv: jax.Array,        # (O,2)
    w_valid: jax.Array,   # (O,) float 0/1 (dead rows 0)
    fixed_cam_mask: jax.Array,  # (C,) bool
    *,
    iters: int = 20,
    cg_iters: int = 30,
    huber_px: float = 4.0,
    init_lambda: float = 1e-4,
    tp_cap: int | None = None,
    tc_cap: int | None = None,
    return_lam: bool = False,
):
    """Run `iters` LM iterations; returns (R, t, X, costs[iters+1]).

    return_lam=True appends the final LM damping to the return tuple so a
    chunked/checkpointed caller can resume with the trust region intact.

    ``huber_px`` is given in pixels and converted to the normalized-residual
    domain with the mean focal length.

    Formulation: without ``tp_cap`` the LM step runs the einsum +
    sorted-segment-sum formulation (``schur.assemble``/``pcg``); with it,
    the planes formulation (``schur.assemble_planes``/``pcg_planes``).

    tp_cap/tc_cap: static upper bounds on observations per point (track
    length) / per camera.  When given, every segment reduction in the
    Schur/PCG path runs scatter-free via padded per-segment obs tables
    (``schur.SegmentRows``).  MUST be true bounds —
    callers know them (track builder caps track length; a camera has at
    most K feature slots); overflowing observations would be dropped.
    """
    n_cams = R.shape[0]
    n_pts = X.shape[0]
    f_ref = jnp.mean(0.5 * (intr[:, 0] + intr[:, 1]))
    huber_n = huber_px / f_ref

    # Sort the obs table by pt_id once: point-side segment reductions in
    # assembly/PCG then use the sorted-scatter path.  Results are
    # order-invariant (all uses are sums).
    perm = jnp.argsort(pt_id)
    cam_id, pt_id, uv, w_valid = (
        cam_id[perm], pt_id[perm], uv[perm], w_valid[perm])
    pt_rows = (schur.build_rows(pt_id, n_pts, tp_cap, ids_sorted=True)
               if tp_cap else None)
    cam_rows = schur.build_rows(cam_id, n_cams, tc_cap) if tc_cap else None
    cost0 = _eval_cost(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid,
                       huber_n)
    state = BAState(R, t, X, jnp.asarray(init_lambda, X.dtype), cost0)

    def lm_iter(state: BAState, _):
        R, t, X = state.R, state.t, state.X
        if pt_rows is not None:
            r, Jc, Jp = _jacobians_planes(intr, k_idx, R, t, X,
                                          cam_id, pt_id, uv)
            r2 = jnp.sum(r * r, axis=-1)
            w = w_valid * huber_weight(r2, huber_n)
            nbp = schur.assemble_planes(
                Jc, Jp, r, w, cam_id, pt_id, n_cams, n_pts,
                pt_sorted=True, pt_rows=pt_rows, cam_rows=cam_rows)
            sysp = schur.reduce_system_planes(nbp, state.lam,
                                              pt_sorted=True)
            dx_c, _ = schur.pcg_planes(sysp, iters=cg_iters,
                                       fixed_cam_mask=fixed_cam_mask,
                                       pt_sorted=True)
            dx_p = schur.solve_points_planes(sysp, dx_c, pt_sorted=True)
        else:
            r, Jc, Jp = _jacobians(intr, k_idx, R, t, X, cam_id, pt_id, uv)
            r2 = jnp.sum(r * r, axis=-1)
            w = w_valid * huber_weight(r2, huber_n)
            nb = schur.assemble(Jc, Jp, r, w, cam_id, pt_id, n_cams, n_pts,
                                pt_sorted=True)
            sys = schur.reduce_system(nb, state.lam)
            dx_c, _ = schur.pcg(sys, iters=cg_iters,
                                fixed_cam_mask=fixed_cam_mask, pt_sorted=True)
            dx_p = schur.solve_points(sys, dx_c, pt_sorted=True)

        # Step-scaling line search: f32 assembly noise can corrupt the step's
        # components along flat (gauge/low-parallax) directions, making the
        # full step cost-neutral-or-worse even when its well-conditioned
        # component is excellent.  Evaluating a few halvings recovers the
        # descent part (the noise penalty shrinks as alpha^2, the real gain
        # only as alpha).
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625], X.dtype)

        def trial(alpha):
            R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
            X2 = X + alpha * dx_p
            return _eval_cost(intr, k_idx, R2, t2, X2, cam_id, pt_id,
                              uv, w_valid, huber_n)

        trial_costs = jax.vmap(trial)(alphas)
        best = jnp.argmin(trial_costs)
        alpha = alphas[best]
        new_cost = trial_costs[best]
        R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
        X2 = X + alpha * dx_p
        accept = new_cost < state.cost
        full_step = accept & (best == 0)
        lam2 = jnp.where(full_step, state.lam * 0.33,
                         jnp.where(accept, state.lam, state.lam * 4.0))
        lam2 = jnp.clip(lam2, 1e-9, 1e6)
        Rn = jnp.where(accept, R2, R)
        tn = jnp.where(accept, t2, t)
        Xn = jnp.where(accept, X2, X)
        cn = jnp.where(accept, new_cost, state.cost)
        return BAState(Rn, tn, Xn, lam2, cn), cn

    state, costs = jax.lax.scan(lm_iter, state, None, length=iters)
    out = (state.R, state.t, state.X, jnp.concatenate([cost0[None], costs]))
    return out + (state.lam,) if return_lam else out


def reprojection_rmse(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid):
    """Masked RMSE in pixels over the observation table (diagnostic metric)."""
    ko = intr[k_idx[cam_id]]
    r = jax.vmap(cameras.reprojection_residual)(ko, R[cam_id], t[cam_id], X[pt_id], uv)
    r2 = jnp.sum(r * r, axis=-1)
    n = jnp.maximum(jnp.sum(w_valid), 1.0)
    return jnp.sqrt(jnp.sum(r2 * w_valid) / n)


# ---------------------------------------------------------------------------
# Joint pose+point+intrinsics LM (reference refines intrinsics by default)
# ---------------------------------------------------------------------------

def _jacobians_k(intr, k_idx, R, t, X, cam_id, pt_id, uv, params, f_ref):
    """Residual + Jacobians wrt (cam 6, point 3, intrinsics n_p).

    Normalization uses the FIXED f_ref so the focal derivative isn't partly
    absorbed by the per-observation weight.
    """
    from .intrinsics import _delta_to_intr

    n_p = len(params)

    def one(kc, Rc, tc, Xp, uv_o):
        def f(p):
            R2, t2 = se3.perturb(Rc, tc, p[:6])
            k2 = _delta_to_intr(kc, p[9:9 + n_p], params)
            return cameras.reprojection_residual(k2, R2, t2, Xp + p[6:9], uv_o) / f_ref

        zero = jnp.zeros(9 + n_p, dtype=X.dtype)
        r = f(zero)
        J = jax.jacfwd(f)(zero)
        return r, J[:, :6], J[:, 6:9], J[:, 9:]

    ko = intr[k_idx[cam_id]]
    return jax.vmap(one)(ko, R[cam_id], t[cam_id], X[pt_id], uv)


@partial(jax.jit, static_argnames=("iters", "cg_iters", "params"))
def ba_solve_intrinsics(
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed_cam_mask, *,
    params: tuple = ("f", "k1"), iters: int = 20, cg_iters: int = 30,
    huber_px: float = 4.0, init_lambda: float = 1e-4,
):
    """LM over poses, points AND shared intrinsics (joint Schur system).

    Returns (R, t, X, intr, costs).
    """
    from .intrinsics import _delta_to_intr
    from . import schur as schur_mod

    n_cams = R.shape[0]
    n_pts = X.shape[0]
    n_groups = intr.shape[0]
    f_ref = jnp.mean(0.5 * (intr[:, 0] + intr[:, 1]))
    huber_n = huber_px / f_ref
    perm = jnp.argsort(pt_id)  # sorted-scatter fast path (see ba_solve)
    cam_id, pt_id, uv, w_valid = (
        cam_id[perm], pt_id[perm], uv[perm], w_valid[perm])
    cam_group = k_idx
    group = k_idx[cam_id]

    def eval_cost(intr, R, t, X):
        ko = intr[k_idx[cam_id]]
        r = jax.vmap(cameras.reprojection_residual)(
            ko, R[cam_id], t[cam_id], X[pt_id], uv) / f_ref
        r2 = jnp.sum(r * r, axis=-1)
        return robust_cost(r2, w_valid, huber_n)

    cost0 = eval_cost(intr, R, t, X)

    def lm_iter(state, _):
        intr, R, t, X, lam, cost = state
        r, Jc, Jp, Jk = _jacobians_k(intr, k_idx, R, t, X, cam_id, pt_id, uv,
                                     params, f_ref)
        r2 = jnp.sum(r * r, axis=-1)
        w = w_valid * huber_weight(r2, huber_n)
        nbk = schur_mod.assemble_with_intrinsics(
            Jc, Jp, Jk, r, w, cam_id, pt_id, group, cam_group,
            n_cams, n_pts, n_groups, pt_sorted=True)
        sk = schur_mod.reduce_system_k(nbk, lam)
        dx_c, dx_k = schur_mod.pcg_k(sk, iters=cg_iters,
                                     fixed_cam_mask=fixed_cam_mask,
                                     pt_sorted=True)
        dx_p = schur_mod.solve_points_k(sk, dx_c, dx_k, pt_sorted=True)

        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625], X.dtype)

        def trial(alpha):
            R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
            intr2 = jax.vmap(lambda k, d: _delta_to_intr(k, d, params))(
                intr, alpha * dx_k)
            return eval_cost(intr2, R2, t2, X + alpha * dx_p)

        tc = jax.vmap(trial)(alphas)
        best = jnp.argmin(tc)
        alpha = alphas[best]
        new_cost = tc[best]
        R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
        X2 = X + alpha * dx_p
        intr2 = jax.vmap(lambda k, d: _delta_to_intr(k, d, params))(
            intr, alpha * dx_k)
        accept = new_cost < cost
        full = accept & (best == 0)
        lam2 = jnp.clip(jnp.where(full, lam * 0.33,
                                  jnp.where(accept, lam, lam * 4.0)), 1e-9, 1e6)
        sel = lambda a, b: jnp.where(accept, a, b)
        return (sel(intr2, intr), sel(R2, R), sel(t2, t), sel(X2, X), lam2,
                jnp.where(accept, new_cost, cost)), new_cost

    init = (intr, R, t, X, jnp.asarray(init_lambda, X.dtype), cost0)
    (intr, R, t, X, _, _), costs = jax.lax.scan(lm_iter, init, None, length=iters)
    return R, t, X, intr, jnp.concatenate([cost0[None], costs])
