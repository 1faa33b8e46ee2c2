"""Point-sharded distributed bundle adjustment (the config-4/5 scale path).

Capability analog: the reference's Ceres BA is single-node (SURVEY §3.4);
this is the SP/CP-style scale-out SURVEY §2.3/§5.7 specifies — the map's
long axis (trajectory blocks of cameras + their landmarks) is partitioned
over the mesh, and ONLY the covisibility boundary (halo) rides the links.

Contrast with ``dist_ba`` (observation-sharded): that path psums full
(C,6,6)/(P,3,3) block arrays and replicates all camera/point state per
device — fine while the map fits one chip's HBM.  Here every device owns
1/n of the cameras, points, and observations (dist.block_layout builds the
layout), and per-iteration communication is O(Hcap):

  LM iteration:   1 all_gather of halo point positions (Hcap,3)
                  1 ring reduce-scatter of packed halo V/b_p partials (Hcap,12)
                  1 all_gather of halo Vinv*b_p values (Hcap,3)
  CG iteration:   1 ring reduce-scatter (Hcap,3) + 1 all_gather (Hcap,3)
                  + 2 scalar psums
  back-subst:     1 ring reduce-scatter (Hcap,3)
  line search:    1 all_gather (Hcap,3) + scalar psums

The block algebra is the PLANES formulation (solvers.schur planes pipeline:
2D arrays with the big axis leading); camera-side
reductions are fully device-local because observations live with their
camera's block.  ``ring_reduce_scatter`` (dist.halo) moves 1/n-sized chunks
per hop — the ring-attention-style bandwidth-optimal accumulation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core import se3
from ..solvers import lm as lm_mod
from ..solvers import schur as schur_mod
from . import halo as halo_mod
from .block_layout import (BlockLayout, build_block_layout, gather_cams,
                           gather_pts, scatter_cams, scatter_pts)

AXIS = "blk"


def _psum(x):
    return jax.lax.psum(x, AXIS)


def _make_shard_helpers(pb, cb, n, hcap, halo_idx, halo_mask, cam_l, pt_ext,
                        dtype):
    """The three shard-local reduction/gather primitives of the block solve.

    Shared by the pose-only and joint-intrinsics scan bodies (both run
    inside shard_map over AXIS).
    """
    p_ext = pb + n * hcap
    hm = halo_mask.astype(dtype)

    def gather_ext(v):
        """Extend per-owned-point values with all blocks' halo exports."""
        g, _ = halo_mod.halo_gather(v, halo_idx, halo_mask, AXIS)  # (n,Hcap,d)
        return jnp.concatenate([v, g.reshape((n * hcap,) + v.shape[1:])], 0)

    def reduce_pt(vals):
        """Point-side reduction: (Ob,d) obs values -> (Pb,d) at owners.

        Local segment-sum over the extended index space, then the halo part
        (contributions this block computed for points owned elsewhere) is
        ring-reduce-scattered so each owner receives the summed partials for
        exactly its exported points.
        """
        seg = jax.ops.segment_sum(vals, pt_ext, num_segments=p_ext,
                                  indices_are_sorted=True)
        local, halo_part = seg[:pb], seg[pb:]
        recv = halo_mod.ring_reduce_scatter(halo_part, AXIS)       # (Hcap,d)
        recv = recv * hm.reshape((-1,) + (1,) * (vals.ndim - 1))
        return local.at[halo_idx].add(recv)

    def reduce_cam(vals):
        # observations live with their camera's block: fully local
        return jax.ops.segment_sum(vals, cam_l, num_segments=cb)

    return gather_ext, reduce_pt, reduce_cam


def _block_lm_scan(intr, lam0, k_idx, R, t, X, fixed, cam_l, pt_ext, uv,
                   w_valid, halo_idx, halo_mask, *, iters: int, cg_iters: int,
                   huber_px: float, n_blocks: int, hcap: int):
    """Per-shard LM scan body (runs inside shard_map over AXIS).

    Shard-local shapes: R (Cb,3,3), t (Cb,3), X (Pb,3), fixed (Cb,),
    cam_l/pt_ext/uv/w (Ob,...), halo_idx/halo_mask (Hcap,).
    ``pt_ext`` indexes [local points | halo slots]: [0,Pb) local,
    [Pb + b*Hcap + s) the s-th export of block b.
    """
    cb = R.shape[0]
    pb = X.shape[0]
    n = n_blocks
    f_ref = jnp.mean(0.5 * (intr[:, 0] + intr[:, 1]))
    huber_n = huber_px / f_ref
    gather_ext, reduce_pt, reduce_cam = _make_shard_helpers(
        pb, cb, n, hcap, halo_idx, halo_mask, cam_l, pt_ext, X.dtype)

    def eval_cost(R, t, Xext):
        ko = intr[k_idx[cam_l]]
        r = jax.vmap(lm_mod._residual_one)(ko, R[cam_l], t[cam_l],
                                           Xext[pt_ext], uv)
        r2 = jnp.sum(r * r, axis=-1)
        return _psum(lm_mod.robust_cost(r2, w_valid, huber_n))

    def lm_iter(state, _):
        R, t, X, lam, cost = state
        Xext = gather_ext(X)                                        # AG (Hcap,3)
        r, Jc, Jp = lm_mod._jacobians_planes(intr, k_idx, R, t, Xext,
                                             cam_l, pt_ext, uv)
        r2 = jnp.sum(r * r, axis=-1)
        w = w_valid * lm_mod.huber_weight(r2, huber_n)

        # planes assembly: camera side local, point side via halo reduction
        Ju = [Jc[:, a] for a in range(6)]
        Jv = [Jc[:, 6 + a] for a in range(6)]
        Pu = [Jp[:, a] for a in range(3)]
        Pv = [Jp[:, 3 + a] for a in range(3)]
        ru, rv = r[:, 0], r[:, 1]
        U_o = jnp.stack([w * (Ju[a] * Ju[b] + Jv[a] * Jv[b])
                         for a in range(6) for b in range(6)], axis=-1)
        V_o = jnp.stack([w * (Pu[a] * Pu[b] + Pv[a] * Pv[b])
                         for a in range(3) for b in range(3)], axis=-1)
        W18 = jnp.stack([w * (Ju[a] * Pu[b] + Jv[a] * Pv[b])
                         for a in range(6) for b in range(3)], axis=-1)
        bc_o = jnp.stack([-w * (Ju[a] * ru + Jv[a] * rv) for a in range(6)],
                         axis=-1)
        bp_o = jnp.stack([-w * (Pu[b] * ru + Pv[b] * rv) for b in range(3)],
                         axis=-1)
        U = reduce_cam(U_o).reshape(cb, 6, 6)
        b_c = reduce_cam(bc_o)
        Vbp = reduce_pt(jnp.concatenate([V_o, bp_o], axis=-1))      # RS (Hcap,12)
        V9, b_p = Vbp[:, :9], Vbp[:, 9:]

        Ud = schur_mod._damp(U, lam)
        Vinv9 = schur_mod._damp_inv3_planes(V9, lam)
        Vinv_bp = schur_mod._mv3_planes(Vinv9, b_p)                 # (Pb,3)
        Vinv_bp_ext = gather_ext(Vinv_bp)                           # AG (Hcap,3)
        b_red = b_c - reduce_cam(schur_mod._W_x(W18, Vinv_bp_ext[pt_ext]))

        Minv = schur_mod._inv_spd(Ud)

        def proj(x):
            return jnp.where(fixed[:, None], 0.0, x)

        def matvec(x):
            Ux = jnp.einsum("cij,cj->ci", Ud, x)
            Wtx = schur_mod._W_t_x(W18, x[cam_l])                   # (Ob,3)
            y_p = reduce_pt(Wtx)                                    # RS (Hcap,3)
            Vy = schur_mod._mv3_planes(Vinv9, y_p)
            Vy_ext = gather_ext(Vy)                                 # AG (Hcap,3)
            z_o = schur_mod._W_x(W18, Vy_ext[pt_ext])               # (Ob,6)
            return Ux - reduce_cam(z_o)

        def pdot(a, b):
            return _psum(jnp.sum(a * b))

        b0 = proj(b_red)
        x0 = jnp.zeros_like(b0)
        z0 = proj(jnp.einsum("cij,cj->ci", Minv, b0))

        def cg_body(_, carry):
            x, rr, z, p = carry
            Sp = proj(matvec(p))
            rz = pdot(rr, z)
            alpha = rz / jnp.maximum(pdot(p, Sp), 1e-20)
            x2 = x + alpha * p
            r2_ = rr - alpha * Sp
            z2 = proj(jnp.einsum("cij,cj->ci", Minv, r2_))
            beta = pdot(r2_, z2) / jnp.maximum(rz, 1e-20)
            return (x2, r2_, z2, z2 + beta * p)

        dx_c, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                          (x0, b0, z0, z0))

        # back-substitute owned points: dx_p = Vinv (b_p - W^T dx_c)
        Wtx = schur_mod._W_t_x(W18, dx_c[cam_l])
        rhs = b_p - reduce_pt(Wtx)                                  # RS (Hcap,3)
        dx_p = schur_mod._mv3_planes(Vinv9, rhs)
        dxp_ext = gather_ext(dx_p)                                  # AG (Hcap,3)

        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625], X.dtype)

        def trial(alpha):
            R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
            return eval_cost(R2, t2, Xext + alpha * dxp_ext)

        trial_costs = jax.vmap(trial)(alphas)
        best = jnp.argmin(trial_costs)
        alpha = alphas[best]
        new_cost = trial_costs[best]
        R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
        X2 = X + alpha * dx_p
        accept = new_cost < cost
        full = accept & (best == 0)
        lam2 = jnp.clip(
            jnp.where(full, lam * 0.33, jnp.where(accept, lam, lam * 4.0)),
            1e-9, 1e6)
        Rn = jnp.where(accept, R2, R)
        tn = jnp.where(accept, t2, t)
        Xn = jnp.where(accept, X2, X)
        cn = jnp.where(accept, new_cost, cost)
        return (Rn, tn, Xn, lam2, cn), cn

    cost0 = eval_cost(R, t, gather_ext(X))
    init = (R, t, X, jnp.asarray(lam0, X.dtype).reshape(()), cost0)
    (R, t, X, lam, _), costs = jax.lax.scan(lm_iter, init, None, length=iters)
    return R, t, X, jnp.concatenate([cost0[None], costs]), lam


def make_block_ba_step(mesh: Mesh, *, n_blocks: int, hcap: int,
                       iters: int = 10, cg_iters: int = 30,
                       huber_px: float = 4.0):
    """Build the jitted point-sharded BA solver for a mesh.

    Inputs are the stacked per-device arrays from ``dist.block_layout``:
    intr and lam0 (initial LM damping scalar) replicated; k_idx/R/t/fixed
    stacked (n*Cb,...); X (n*Pb,3); cam_l/pt_ext/uv/w (n*Ob,...);
    halo_idx/halo_mask (n*Hcap,).
    Returns (R, t, X, costs, lam) — state in the same stacked layout plus
    the final damping, so a chunked caller resumes the trust region.
    """
    fn = partial(_block_lm_scan, iters=iters, cg_iters=cg_iters,
                 huber_px=huber_px, n_blocks=n_blocks, hcap=hcap)
    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(), P()),
    )
    return jax.jit(sharded)


def _block_lm_scan_k(intr, lam0, k_idx, R, t, X, fixed, cam_l, pt_ext, uv,
                     w_valid, halo_idx, halo_mask, *, params: tuple,
                     iters: int, cg_iters: int, huber_px: float,
                     n_blocks: int, hcap: int):
    """Joint pose+point+INTRINSICS LM scan body (shard_map over AXIS).

    The distributed analog of ``lm.ba_solve_intrinsics`` (SURVEY C6: the
    reference refines intrinsics in BA by default).  Intrinsics groups are
    REPLICATED state: their normal-equation blocks (Ukk, b_k) and every
    intrinsics-side reduction in CG are psum'd across blocks, while the
    pose/point sides keep the pose-only solver's locality (camera blocks
    local, point blocks via halo reduce-scatter).  Per-CG-iteration comm
    grows only by the O(I*n_p) psums — negligible next to the halo traffic.
    """
    from ..solvers.intrinsics import _delta_to_intr

    cb = R.shape[0]
    pb = X.shape[0]
    n = n_blocks
    n_groups = intr.shape[0]
    n_p = len(params)
    f_ref = jnp.mean(0.5 * (intr[:, 0] + intr[:, 1]))
    huber_n = huber_px / f_ref
    gather_ext, reduce_pt, reduce_cam = _make_shard_helpers(
        pb, cb, n, hcap, halo_idx, halo_mask, cam_l, pt_ext, X.dtype)

    def reduce_group(vals):
        # intrinsics groups are replicated: sum locally, then globally
        return _psum(jax.ops.segment_sum(vals, k_idx[cam_l],
                                         num_segments=n_groups))

    def reduce_cam_group(vals):
        # (Cb,d) per-camera values -> (I,d) replicated group sums
        return _psum(jax.ops.segment_sum(vals, k_idx,
                                         num_segments=n_groups))

    def eval_cost(intr_c, R, t, Xext):
        ko = intr_c[k_idx[cam_l]]
        r = jax.vmap(lm_mod.cameras.reprojection_residual)(
            ko, R[cam_l], t[cam_l], Xext[pt_ext], uv) / f_ref
        r2 = jnp.sum(r * r, axis=-1)
        return _psum(lm_mod.robust_cost(r2, w_valid, huber_n))

    def lm_iter(state, _):
        intr_c, R, t, X, lam, cost = state
        Xext = gather_ext(X)                                        # AG
        r, Jc, Jp, Jk = lm_mod._jacobians_k(
            intr_c, k_idx, R, t, Xext, cam_l, pt_ext, uv, params, f_ref)
        r2 = jnp.sum(r * r, axis=-1)
        w = w_valid * lm_mod.huber_weight(r2, huber_n)
        ws = w[:, None, None]

        U_o = jnp.einsum("oik,oil->okl", Jc * ws, Jc)               # (Ob,6,6)
        V_o = jnp.einsum("oik,oil->okl", Jp * ws, Jp).reshape(-1, 9)
        W_o = jnp.einsum("oik,oil->okl", Jc * ws, Jp)               # (Ob,6,3)
        Ukk_o = jnp.einsum("oik,oil->okl", Jk * ws, Jk)             # (Ob,np,np)
        Uck_o = jnp.einsum("oik,oil->okl", Jc * ws, Jk)             # (Ob,6,np)
        Wk_o = jnp.einsum("oik,oil->okl", Jk * ws, Jp)              # (Ob,np,3)
        bc_o = -jnp.einsum("oik,oi->ok", Jc * ws, r)
        bp_o = -jnp.einsum("oik,oi->ok", Jp * ws, r)
        bk_o = -jnp.einsum("oik,oi->ok", Jk * ws, r)

        U = reduce_cam(U_o)
        b_c = reduce_cam(bc_o)
        Uck = reduce_cam(Uck_o)
        Vbp = reduce_pt(jnp.concatenate([V_o, bp_o], axis=-1))      # RS
        V9, b_p = Vbp[:, :9], Vbp[:, 9:]
        Ukk = reduce_group(Ukk_o)                                    # psum
        b_k = reduce_group(bk_o)                                     # psum

        Ud = schur_mod._damp(U, lam)
        Ukk_d = schur_mod._damp(Ukk, lam)
        Vinv9 = schur_mod._damp_inv3_planes(V9, lam)
        Vinv_bp = schur_mod._mv3_planes(Vinv9, b_p)
        Vinv_bp_ext = gather_ext(Vinv_bp)                            # AG
        b_red_c = b_c - reduce_cam(
            jnp.einsum("oij,oj->oi", W_o, Vinv_bp_ext[pt_ext]))
        b_red_k = b_k - reduce_group(
            jnp.einsum("oij,oj->oi", Wk_o, Vinv_bp_ext[pt_ext]))

        Minv_c = schur_mod._inv_spd(Ud)
        Minv_k = schur_mod._inv_spd(Ukk_d)
        gidx = k_idx[cam_l]

        def proj(xc):
            return jnp.where(fixed[:, None], 0.0, xc)

        def matvec(x_c, x_k):
            y_c = jnp.einsum("cij,cj->ci", Ud, x_c)
            y_c += jnp.einsum("cij,cj->ci", Uck, x_k[k_idx])
            y_k = jnp.einsum("gij,gj->gi", Ukk_d, x_k)
            y_k += reduce_cam_group(jnp.einsum("cji,cj->ci", Uck, x_c))
            Wtx = jnp.einsum("oji,oj->oi", W_o, x_c[cam_l])
            Wtx += jnp.einsum("oji,oj->oi", Wk_o, x_k[gidx])
            y_p = reduce_pt(Wtx)                                     # RS
            Vy = schur_mod._mv3_planes(Vinv9, y_p)
            Vy_ext = gather_ext(Vy)                                  # AG
            y_c -= reduce_cam(jnp.einsum("oij,oj->oi", W_o, Vy_ext[pt_ext]))
            y_k -= reduce_group(jnp.einsum("oij,oj->oi", Wk_o, Vy_ext[pt_ext]))
            return y_c, y_k

        def dot(ac, ak, bc, bk):
            # camera part is block-local (psum); intrinsics part replicated
            return _psum(jnp.sum(ac * bc)) + jnp.sum(ak * bk)

        b0_c, b0_k = proj(b_red_c), b_red_k
        z0_c = proj(jnp.einsum("cij,cj->ci", Minv_c, b0_c))
        z0_k = jnp.einsum("gij,gj->gi", Minv_k, b0_k)

        def cg_body(_, carry):
            xc, xk, rc, rk, zc, zk, pc, pk = carry
            Sc, Sk = matvec(pc, pk)
            Sc = proj(Sc)
            rz = dot(rc, rk, zc, zk)
            alpha = rz / jnp.maximum(dot(pc, pk, Sc, Sk), 1e-20)
            xc2, xk2 = xc + alpha * pc, xk + alpha * pk
            rc2, rk2 = rc - alpha * Sc, rk - alpha * Sk
            zc2 = proj(jnp.einsum("cij,cj->ci", Minv_c, rc2))
            zk2 = jnp.einsum("gij,gj->gi", Minv_k, rk2)
            beta = dot(rc2, rk2, zc2, zk2) / jnp.maximum(rz, 1e-20)
            return (xc2, xk2, rc2, rk2, zc2, zk2,
                    zc2 + beta * pc, zk2 + beta * pk)

        zero_c, zero_k = jnp.zeros_like(b0_c), jnp.zeros_like(b0_k)
        dx_c, dx_k, *_ = jax.lax.fori_loop(
            0, cg_iters, cg_body,
            (zero_c, zero_k, b0_c, b0_k, z0_c, z0_k, z0_c, z0_k))

        # back-substitute owned points
        Wtx = jnp.einsum("oji,oj->oi", W_o, dx_c[cam_l])
        Wtx += jnp.einsum("oji,oj->oi", Wk_o, dx_k[gidx])
        rhs = b_p - reduce_pt(Wtx)                                   # RS
        dx_p = schur_mod._mv3_planes(Vinv9, rhs)
        dxp_ext = gather_ext(dx_p)                                   # AG

        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625], X.dtype)

        def apply_k(alpha):
            return jax.vmap(
                lambda k, d: _delta_to_intr(k, d, params))(
                    intr_c, alpha * dx_k)

        def trial(alpha):
            R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
            return eval_cost(apply_k(alpha), R2, t2, Xext + alpha * dxp_ext)

        trial_costs = jax.vmap(trial)(alphas)
        best = jnp.argmin(trial_costs)
        alpha = alphas[best]
        new_cost = trial_costs[best]
        R2, t2 = se3.perturb_b(R, t, alpha * dx_c)
        X2 = X + alpha * dx_p
        intr2 = apply_k(alpha)
        accept = new_cost < cost
        full = accept & (best == 0)
        lam2 = jnp.clip(
            jnp.where(full, lam * 0.33, jnp.where(accept, lam, lam * 4.0)),
            1e-9, 1e6)
        sel = lambda a, b: jnp.where(accept, a, b)
        return (sel(intr2, intr_c), sel(R2, R), sel(t2, t), sel(X2, X),
                lam2, jnp.where(accept, new_cost, cost)), \
            jnp.where(accept, new_cost, cost)

    cost0 = eval_cost(intr, R, t, gather_ext(X))
    init = (intr, R, t, X, jnp.asarray(lam0, X.dtype).reshape(()), cost0)
    (intr, R, t, X, lam, _), costs = jax.lax.scan(lm_iter, init, None,
                                                  length=iters)
    return intr, R, t, X, jnp.concatenate([cost0[None], costs]), lam


def make_block_ba_step_k(mesh: Mesh, *, n_blocks: int, hcap: int,
                         params: tuple = ("f", "k1"), iters: int = 10,
                         cg_iters: int = 30, huber_px: float = 4.0):
    """Jitted point-sharded joint pose+point+intrinsics BA step.

    Same stacked layout as ``make_block_ba_step``; returns
    (intr, R, t, X, costs, lam) with intr replicated.
    """
    fn = partial(_block_lm_scan_k, params=params, iters=iters,
                 cg_iters=cg_iters, huber_px=huber_px, n_blocks=n_blocks,
                 hcap=hcap)
    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(), P()),
    )
    return jax.jit(sharded)


def ba_solve_blocked_intrinsics(intr, k_idx, R, t, X, cam_id, pt_id, uv, w,
                                fixed_cam_mask, mesh: Mesh | None = None, *,
                                layout: BlockLayout | None = None,
                                params: tuple = ("f", "k1"),
                                iters: int = 10, cg_iters: int = 30,
                                huber_px: float = 4.0):
    """Distributed self-calibration: global scene in, refined intrinsics out.

    Returns (R, t, X, intr, costs, stats) — the block-sharded counterpart of
    ``lm.ba_solve_intrinsics`` for configs 4-5 merges of heterogeneous
    sessions (SURVEY C6).
    """
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (AXIS,))
    n_blocks = int(np.prod(mesh.devices.shape))
    n_cams = int(np.asarray(R).shape[0])
    n_pts = int(np.asarray(X).shape[0])
    if layout is None:
        layout = build_block_layout(np.asarray(cam_id), np.asarray(pt_id),
                                    np.asarray(uv), np.asarray(w),
                                    n_cams, n_pts, n_blocks)
    k_l, R_l, t_l, fixed_l = scatter_cams(layout, k_idx, R, t, fixed_cam_mask)
    fixed_l = fixed_l | (layout.cam_global < 0)
    (X_l,) = scatter_pts(layout, X)

    step = make_block_ba_step_k(mesh, n_blocks=n_blocks, hcap=layout.hcap,
                                params=params, iters=iters,
                                cg_iters=cg_iters, huber_px=huber_px)
    intr_f, R_s, t_s, X_s, costs, _ = step(
        jnp.asarray(intr), jnp.asarray(1e-4, jnp.float32), jnp.asarray(k_l),
        jnp.asarray(R_l), jnp.asarray(t_l), jnp.asarray(X_l),
        jnp.asarray(fixed_l),
        jnp.asarray(layout.obs_cam_l), jnp.asarray(layout.obs_pt_ext),
        jnp.asarray(layout.obs_uv), jnp.asarray(layout.obs_w),
        jnp.asarray(layout.halo_idx), jnp.asarray(layout.halo_mask))
    R_g, t_g = gather_cams(layout, n_cams, R_s, t_s)
    (X_g,) = gather_pts(layout, n_pts, X_s)
    return (jnp.asarray(R_g), jnp.asarray(t_g), jnp.asarray(X_g),
            jnp.asarray(intr_f), costs, layout.stats())


def ba_solve_blocked(intr, k_idx, R, t, X, cam_id, pt_id, uv, w,
                     fixed_cam_mask, mesh: Mesh | None = None, *,
                     layout: BlockLayout | None = None,
                     iters: int = 10, cg_iters: int = 30,
                     huber_px: float = 4.0,
                     ckpt_path=None, ckpt_every: int = 10):
    """Convenience wrapper: global scene in, global scene out.

    Builds the block layout for the mesh (or reuses ``layout``), scatters the
    global arrays into per-device blocks, runs the sharded solve, and maps
    results back to global camera/point order.

    ckpt_path: when given, the solve runs in ``ckpt_every``-iteration chunks,
    writing an LM-state checkpoint (global R/t/X + damping + iteration
    count, solvers.ba_ckpt format) between chunks and resuming from an
    existing checkpoint — the SURVEY §5.3 multi-host fault-recovery story
    for the long-running distributed solve.  The block layout and jitted
    step are built ONCE and reused across chunks; state stays in the stacked
    device layout between chunks (gathered only to write the checkpoint).

    Returns (R, t, X, costs, stats) where stats reports halo fraction,
    per-block load and per-device state sizes (the quantities SURVEY §7.4
    says to monitor).
    """
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (AXIS,))
    n_blocks = int(np.prod(mesh.devices.shape))
    n_cams = int(np.asarray(R).shape[0])
    n_pts = int(np.asarray(X).shape[0])
    if layout is None:
        layout = build_block_layout(np.asarray(cam_id), np.asarray(pt_id),
                                    np.asarray(uv), np.asarray(w),
                                    n_cams, n_pts, n_blocks)

    lam = 1e-4
    start = 0
    if ckpt_path is not None:
        from pathlib import Path

        from ..solvers import ba_ckpt

        if Path(ckpt_path).exists():
            R, t, X, lam, start = ba_ckpt.load_ckpt(ckpt_path)

    k_l, R_l, t_l, fixed_l = scatter_cams(layout, k_idx, R, t, fixed_cam_mask)
    fixed_l = fixed_l | (layout.cam_global < 0)   # pads held fixed (gauge-safe)
    (X_l,) = scatter_pts(layout, X)
    intr_j = jnp.asarray(intr)
    static = (jnp.asarray(k_l), jnp.asarray(fixed_l),
              jnp.asarray(layout.obs_cam_l), jnp.asarray(layout.obs_pt_ext),
              jnp.asarray(layout.obs_uv), jnp.asarray(layout.obs_w),
              jnp.asarray(layout.halo_idx), jnp.asarray(layout.halo_mask))

    def run_chunk(step, R_l, t_l, X_l, lam):
        k_j, fixed_j, cam_j, pt_j, uv_j, w_j, hi_j, hm_j = static
        return step(intr_j, jnp.asarray(lam, jnp.float32), k_j,
                    jnp.asarray(R_l), jnp.asarray(t_l), jnp.asarray(X_l),
                    fixed_j, cam_j, pt_j, uv_j, w_j, hi_j, hm_j)

    mk = partial(make_block_ba_step, mesh, n_blocks=n_blocks,
                 hcap=layout.hcap, cg_iters=cg_iters, huber_px=huber_px)
    if ckpt_path is None:
        R_s, t_s, X_s, costs, _ = run_chunk(mk(iters=iters), R_l, t_l, X_l, lam)
    else:
        step = mk(iters=ckpt_every)
        costs_all = []
        it = start
        R_s, t_s, X_s = R_l, t_l, X_l
        while it < iters:
            n = min(ckpt_every, iters - it)
            chunk_step = step if n == ckpt_every else mk(iters=n)
            R_s, t_s, X_s, costs, lam = run_chunk(chunk_step, R_s, t_s, X_s, lam)
            lam = float(lam)
            # drop the duplicate leading cost0 on continuation chunks
            c = np.asarray(costs)
            costs_all.extend(c.tolist() if not costs_all else c[1:].tolist())
            it += n
            R_g, t_g = gather_cams(layout, n_cams, R_s, t_s)
            (X_g,) = gather_pts(layout, n_pts, X_s)
            ba_ckpt.save_ckpt(ckpt_path, R_g, t_g, X_g, lam, it)
        costs = jnp.asarray(costs_all)

    R_g, t_g = gather_cams(layout, n_cams, R_s, t_s)
    (X_g,) = gather_pts(layout, n_pts, X_s)
    return (jnp.asarray(R_g), jnp.asarray(t_g), jnp.asarray(X_g),
            costs, layout.stats())
