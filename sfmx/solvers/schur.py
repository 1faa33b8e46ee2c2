"""Block-sparse normal equations + Schur complement for bundle adjustment.

Capability parity: Ceres' SPARSE_SCHUR / ITERATIVE_SCHUR path (the reference's
BA backend via OpenMVG, SURVEY.md §3.4).  Design: the scene's observation
table IS the sparse structure — Jacobian blocks live per-observation in flat
(O, 2, 6) / (O, 2, 3) arrays, and every assembly step is a
``segment_sum`` over camera or point ids.  No sparse matrices, no indices
into CSR structure, no host graph building: everything is dense gathers,
batched 3x3/6x6 linear algebra, and segment reductions — all shardable over
the observation axis.

Layout:
  cams:    flattened camera params updated via se3 left-perturbation, 6/cam
  points:  3/point
  obs:     (cam_id[O], pt_id[O], uv[O,2], w[O]) with w=0 for dead/padded rows

Normal-equation blocks:
  U  (C,6,6)  camera diagonal blocks     = Σ_obs Jc^T Jc
  V  (P,3,3)  point diagonal blocks      = Σ_obs Jp^T Jp
  W  (O,6,3)  per-observation coupling   = Jc^T Jp   (kept per-obs, never
              aggregated into a sparse matrix — applied via segment ops)
Schur complement S = U - W V^{-1} W^T is applied matrix-free in PCG.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class NormalBlocks(NamedTuple):
    U: jax.Array        # (C,6,6)
    V: jax.Array        # (P,3,3)
    Wc: jax.Array       # (O,6,3) per-observation coupling blocks
    b_c: jax.Array      # (C,6)  = -Jc^T r
    b_p: jax.Array      # (P,3)  = -Jp^T r
    cam_id: jax.Array   # (O,)
    pt_id: jax.Array    # (O,)
    pt_rows: "SegmentRows | None" = None   # scatter-free reduction tables
    cam_rows: "SegmentRows | None" = None


def assemble(Jc, Jp, r, w, cam_id, pt_id, n_cams: int, n_pts: int,
             pt_sorted: bool = False, pt_rows=None, cam_rows=None) -> NormalBlocks:
    """Build normal-equation blocks from per-observation Jacobians.

    Args:
      Jc: (O,2,6) residual Jacobian wrt camera tangent.
      Jp: (O,2,3) wrt point.
      r:  (O,2) residuals.
      w:  (O,) weights (0 for invalid; robust-loss weights otherwise).
      pt_sorted: static flag — the obs table is sorted by ``pt_id``.  The
        point-side segment reductions then lower to a sorted scatter.
        Solvers sort once per solve; the obs order does not affect any
        result.
      pt_rows/cam_rows: optional ``SegmentRows`` tables (built once per
        solve) — replaces every segment reduction with gather + dense sum
        (scatter-free).
    """
    ws = w[:, None, None]
    Jc_w = Jc * ws
    # Per-observation outer products (batched small matmuls).
    U_o = jnp.einsum("oik,oil->okl", Jc_w, Jc)          # (O,6,6)
    V_o = jnp.einsum("oik,oil->okl", Jp * ws, Jp)        # (O,3,3)
    W_o = jnp.einsum("oik,oil->okl", Jc_w, Jp)           # (O,6,3)
    bc_o = -jnp.einsum("oik,oi->ok", Jc_w, r)            # (O,6)
    bp_o = -jnp.einsum("oik,oi->ok", Jp * ws, r)         # (O,3)

    if cam_rows is not None:
        U = rows_sum(U_o, cam_rows)
        b_c = rows_sum(bc_o, cam_rows)
    else:
        U = jax.ops.segment_sum(U_o, cam_id, num_segments=n_cams)
        b_c = jax.ops.segment_sum(bc_o, cam_id, num_segments=n_cams)
    if pt_rows is not None:
        V = rows_sum(V_o, pt_rows)
        b_p = rows_sum(bp_o, pt_rows)
    else:
        V = jax.ops.segment_sum(V_o, pt_id, num_segments=n_pts,
                                indices_are_sorted=pt_sorted)
        b_p = jax.ops.segment_sum(bp_o, pt_id, num_segments=n_pts,
                                  indices_are_sorted=pt_sorted)
    return NormalBlocks(U, V, W_o, b_c, b_p, cam_id, pt_id, pt_rows, cam_rows)


def _damp(M: jax.Array, lam: jax.Array) -> jax.Array:
    """Levenberg multiplicative+additive damping of diagonal blocks."""
    k = M.shape[-1]
    if k == 3:
        # jnp.diagonal lowers to a gather (ms-scale on (P,3,3) batches);
        # explicit component slices stay elementwise
        d = jnp.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], axis=-1)
    else:
        d = jnp.diagonal(M, axis1=-2, axis2=-1)
    eye = jnp.eye(k, dtype=M.dtype)
    return M + eye * (lam * d + 1e-10)[..., None, :] * eye


def _inv_spd(M: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Batched SPD inverse with Tikhonov floor (3x3 / 6x6 blocks).

    3x3 blocks use the closed-form adjugate (pure mul/add instead of a
    batched LU for the (P,3,3) V inversion); larger blocks fall back to
    ``jnp.linalg.inv``.
    """
    k = M.shape[-1]
    if k == 6:
        return _inv_spd6(M, eps)
    if k != 3:
        return jnp.linalg.inv(M + eps * jnp.eye(k, dtype=M.dtype))
    # Component-wise adjugate over (...,) planes: elementwise ops over the
    # batch axis, never cross/stack on minor-3 arrays.
    a, b_, c = M[..., 0, 0] + eps, M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1] + eps, M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2] + eps
    A = e * i - f * h
    B = c * h - b_ * i
    Cc = b_ * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b_ * g - a * h
    I = a * e - b_ * d
    det = a * A + b_ * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    inv = jnp.stack([
        jnp.stack([A, B, Cc], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ], axis=-2)
    return inv / det[..., None, None]


def _inv_spd6(M: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Batched SPD 6x6 inverse via 2x2-of-3x3 block Schur complement.

    inv([[A,B],[Bt,D]]) = [[Ai + Ai B Si Bt Ai, -Ai B Si], [-Si Bt Ai, Si]]
    with S = D - Bt Ai B.  Both 3x3 inversions use the closed-form adjugate
    (``_inv_spd``); the block products are (.,3,3) einsums.  The PCG
    preconditioner rebuilds it every LM iteration."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    Bt = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = _inv_spd(A, eps)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
    S = D - jnp.einsum("...ij,...jk->...ik", Bt, AiB)
    Si = _inv_spd(S, eps)
    BtAi = jnp.einsum("...ij,...jk->...ik", Bt, Ai)
    SiBtAi = jnp.einsum("...ij,...jk->...ik", Si, BtAi)
    top_left = Ai + jnp.einsum("...ij,...jk->...ik", AiB, SiBtAi)
    top_right = -jnp.einsum("...ij,...jk->...ik", AiB, Si)
    bot_left = -SiBtAi
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# Padded-CSR segment reduction: scatter-free (gather + dense sum)
# ---------------------------------------------------------------------------

class SegmentRows(NamedTuple):
    """Padded per-segment observation lists: rows[s, j] = obs index (or O,
    the sentinel row) of the j-th observation of segment s."""

    rows: jax.Array       # (S, cap) int32 in [0, O]; O = pad sentinel
    overflow: jax.Array   # () int32 — obs that did not fit (MUST be 0)


def build_rows(ids: jax.Array, n_segments: int, cap: int,
               ids_sorted: bool = False) -> SegmentRows:
    """Invert a segment-id array into padded per-segment obs lists.

    One scatter of O int32 at build time buys scatter-free reductions for
    every later segment_sum over these ids.  ``overflow`` counts entries
    beyond ``cap`` per segment; callers must size cap so it is zero
    (observations per camera are bounded by the feature capacity K; track
    lengths by the track-builder cap).
    """
    O = ids.shape[0]
    if not ids_sorted:
        order = jnp.argsort(ids)
    else:
        order = jnp.arange(O)
    sid = ids[order]
    first = jnp.searchsorted(sid, jnp.arange(n_segments), side="left")
    pos = jnp.arange(O) - first[sid]
    rows = jnp.full((n_segments, cap), O, jnp.int32)
    # overflow entries have pos >= cap -> out of bounds -> dropped
    rows = rows.at[sid, pos].set(order.astype(jnp.int32), mode="drop")
    return SegmentRows(rows, jnp.sum((pos >= cap).astype(jnp.int32)))


def rows_sum(x: jax.Array, sr: SegmentRows) -> jax.Array:
    """segment_sum(x, ids) via gather + dense reduce: (O,...) -> (S,...)."""
    xp = jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)], axis=0)
    return jnp.sum(xp[sr.rows], axis=1)


class TrackBlocks(NamedTuple):
    """Track-blocked (dense-padded per-point) view of the coupling blocks.

    The CG matvec over the raw obs table is bound by narrow gathers/scatters
    of (O,3)/(O,6) rows.  This view pregathers Wc into a dense (P,Tp,6,3) tensor ONCE per LM iteration
    (hoisted out of the CG loop by XLA's while-loop invariant code motion),
    so each CG iteration is wide dense reads + batched einsums + one padded
    camera-side reduction."""

    Wg: jax.Array | None     # (P,Tp,6,3); zero blocks in padded slots
    cam_tbl: jax.Array       # (P,Tp) int32 camera of each slot (C for pads)
    cam_rows_flat: "SegmentRows"   # (C,Tc) indices into flattened (P*Tp)


def build_track_blocks_static(cam_id, pt_rows: "SegmentRows", n_cams: int,
                              tc_cap: int) -> TrackBlocks:
    """The iteration-INVARIANT part (index tables — includes a 640k-scale
    argsort; must be built once per solve, never inside the LM loop)."""
    cam_pad = jnp.concatenate(
        [cam_id, jnp.full((1,), n_cams, cam_id.dtype)])[pt_rows.rows]  # (P,Tp)
    # flat camera-side reduction table; padded slots have id n_cams -> dropped
    cam_rows_flat = build_rows(cam_pad.reshape(-1), n_cams, tc_cap)
    return TrackBlocks(None, cam_pad, cam_rows_flat)


def with_coupling(tb: TrackBlocks, Wc, pt_rows: "SegmentRows") -> TrackBlocks:
    """Per-LM-iteration part: pregather the fresh coupling blocks (wide)."""
    Wg = jnp.concatenate([Wc, jnp.zeros((1, 6, 3), Wc.dtype)])[pt_rows.rows]
    return tb._replace(Wg=Wg)


def schur_matvec_blocked(sys: "SchurSystem", tb: TrackBlocks,
                         x: jax.Array) -> jax.Array:
    """S @ x in the track-blocked layout (see TrackBlocks)."""
    Ux = jnp.einsum("cij,cj->ci", sys.Ud, x)
    xp = jnp.concatenate([x, jnp.zeros((1, 6), x.dtype)])
    xg = xp[tb.cam_tbl]                                   # (P,Tp,6)
    y_p = jnp.einsum("ptij,pti->pj", tb.Wg, xg)           # (P,3)
    Vy = jnp.einsum("pij,pj->pi", sys.Vinv, y_p)          # (P,3)
    z_pt = jnp.einsum("ptij,pj->pti", tb.Wg, Vy)          # (P,Tp,6)
    z_c = rows_sum(z_pt.reshape(-1, 6), tb.cam_rows_flat)  # (C,6)
    return Ux - z_c


class SchurSystem(NamedTuple):
    blocks: NormalBlocks
    Vinv: jax.Array       # (P,3,3) damped-V inverse
    Ud: jax.Array         # (C,6,6) damped U
    b_red: jax.Array      # (C,6) reduced RHS

    @property
    def n_cams(self) -> int:
        return self.Ud.shape[0]

    @property
    def n_pts(self) -> int:
        return self.Vinv.shape[0]


def reduce_system(nb: NormalBlocks, lam: jax.Array) -> SchurSystem:
    """Damp and Schur-eliminate the point blocks (the 'landmark marginalization')."""
    n_cams = nb.U.shape[0]
    n_pts = nb.V.shape[0]
    Ud = _damp(nb.U, lam)
    Vd = _damp(nb.V, lam)
    Vinv = _inv_spd(Vd)
    # b_red = b_c - W V^{-1} b_p   (per-obs gather + segment_sum)
    Vinv_bp = jnp.einsum("pij,pj->pi", Vinv, nb.b_p)      # (P,3)
    contrib = jnp.einsum("oij,oj->oi", nb.Wc, Vinv_bp[nb.pt_id])  # (O,6)
    if nb.cam_rows is not None:
        red = rows_sum(contrib, nb.cam_rows)
    else:
        red = jax.ops.segment_sum(contrib, nb.cam_id, num_segments=n_cams)
    b_red = nb.b_c - red
    return SchurSystem(nb, Vinv, Ud, b_red)


def schur_matvec(sys: SchurSystem, x: jax.Array,
                 pt_sorted: bool = False) -> jax.Array:
    """S @ x with S = Ud - W V^{-1} W^T, matrix-free over the obs table.

    x: (C,6). Two segment passes: y_p = Σ_obs W^T x_cam (per point), then
    z_c = Σ_obs W V^{-1} y_p (per cam).
    """
    nb = sys.blocks
    Ux = jnp.einsum("cij,cj->ci", sys.Ud, x)
    Wtx = jnp.einsum("oji,oj->oi", nb.Wc, x[nb.cam_id])        # (O,3)
    if nb.pt_rows is not None:
        y_p = rows_sum(Wtx, nb.pt_rows)
    else:
        y_p = jax.ops.segment_sum(Wtx, nb.pt_id, num_segments=sys.n_pts,
                                  indices_are_sorted=pt_sorted)  # (P,3)
    Vinv_y = jnp.einsum("pij,pj->pi", sys.Vinv, y_p)
    z_o = jnp.einsum("oij,oj->oi", nb.Wc, Vinv_y[nb.pt_id])    # (O,6)
    if nb.cam_rows is not None:
        z_c = rows_sum(z_o, nb.cam_rows)
    else:
        z_c = jax.ops.segment_sum(z_o, nb.cam_id, num_segments=sys.n_cams)
    return Ux - z_c


def solve_points(sys: SchurSystem, dx_c: jax.Array,
                 pt_sorted: bool = False) -> jax.Array:
    """Back-substitute point updates: dx_p = V^{-1} (b_p - W^T dx_c)."""
    nb = sys.blocks
    Wtx = jnp.einsum("oji,oj->oi", nb.Wc, dx_c[nb.cam_id])
    if nb.pt_rows is not None:
        red = rows_sum(Wtx, nb.pt_rows)
    else:
        red = jax.ops.segment_sum(Wtx, nb.pt_id, num_segments=sys.n_pts,
                                  indices_are_sorted=pt_sorted)
    rhs = nb.b_p - red
    return jnp.einsum("pij,pj->pi", sys.Vinv, rhs)


@partial(jax.jit, static_argnames=("iters", "pt_sorted"))
def pcg(sys: SchurSystem, iters: int = 30, fixed_cam_mask=None,
        pt_sorted: bool = False, track_blocks: TrackBlocks | None = None):
    """Preconditioned CG on the reduced camera system (block-Jacobi precond).

    fixed_cam_mask: (C,) bool — cameras held fixed for gauge (their updates
    are projected to zero every iteration).
    Fixed trip count (jit-static); BA outer loop controls accuracy via iters.
    """
    Minv = _inv_spd(sys.Ud)  # block-Jacobi preconditioner

    def proj(x):
        if fixed_cam_mask is None:
            return x
        return jnp.where(fixed_cam_mask[:, None], 0.0, x)

    b = proj(sys.b_red)
    x0 = jnp.zeros_like(b)
    r0 = b  # since x0 = 0
    z0 = proj(jnp.einsum("cij,cj->ci", Minv, r0))
    p0 = z0

    def body(_, carry):
        x, r, z, p = carry
        if track_blocks is not None:
            Sp = proj(schur_matvec_blocked(sys, track_blocks, p))
        else:
            Sp = proj(schur_matvec(sys, p, pt_sorted=pt_sorted))
        rz = jnp.sum(r * z)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-20)
        x2 = x + alpha * p
        r2 = r - alpha * Sp
        z2 = proj(jnp.einsum("cij,cj->ci", Minv, r2))
        beta = jnp.sum(r2 * z2) / jnp.maximum(rz, 1e-20)
        p2 = z2 + beta * p
        return (x2, r2, z2, p2)

    x, r, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, p0))
    return x, jnp.sqrt(jnp.sum(r * r))


# ---------------------------------------------------------------------------
# Extended system: shared-intrinsics blocks in the reduced camera system
# ---------------------------------------------------------------------------

class NormalBlocksK(NamedTuple):
    """Normal blocks with per-group intrinsics parameters (n_p each).

    Each camera couples to exactly one intrinsics group (k_idx[cam]), so the
    pose<->intrinsics coupling is a per-camera (6,n_p) block and everything
    stays segment-sum shaped.
    """

    base: NormalBlocks
    Ukk: jax.Array      # (I,n_p,n_p)
    Uck: jax.Array      # (C,6,n_p)  pose-intrinsics coupling (summed per cam)
    Wk: jax.Array       # (O,n_p,3)  intrinsics-point coupling per obs
    b_k: jax.Array      # (I,n_p)
    group: jax.Array    # (O,) intrinsics group of each observation
    cam_group: jax.Array  # (C,) intrinsics group of each camera


def assemble_with_intrinsics(Jc, Jp, Jk, r, w, cam_id, pt_id, group, cam_group,
                             n_cams: int, n_pts: int, n_groups: int,
                             pt_sorted: bool = False) -> NormalBlocksK:
    base = assemble(Jc, Jp, r, w, cam_id, pt_id, n_cams, n_pts,
                    pt_sorted=pt_sorted)
    ws = w[:, None, None]
    Jk_w = Jk * ws
    Ukk_o = jnp.einsum("oik,oil->okl", Jk_w, Jk)
    Uck_o = jnp.einsum("oik,oil->okl", Jc * ws, Jk)   # (O,6,n_p)
    Wk_o = jnp.einsum("oik,oil->okl", Jk_w, Jp)        # (O,n_p,3)
    bk_o = -jnp.einsum("oik,oi->ok", Jk_w, r)
    Ukk = jax.ops.segment_sum(Ukk_o, group, num_segments=n_groups)
    Uck = jax.ops.segment_sum(Uck_o, cam_id, num_segments=n_cams)
    b_k = jax.ops.segment_sum(bk_o, group, num_segments=n_groups)
    return NormalBlocksK(base, Ukk, Uck, Wk_o, b_k, group, cam_group)


class SchurSystemK(NamedTuple):
    sys: SchurSystem     # pose/point part (damped, reduced)
    Ukk_d: jax.Array     # (I,n_p,n_p) damped
    Uck: jax.Array       # (C,6,n_p)
    Wk: jax.Array        # (O,n_p,3)
    b_red_k: jax.Array   # (I,n_p)
    group: jax.Array
    cam_group: jax.Array

    @property
    def n_groups(self) -> int:
        return self.Ukk_d.shape[0]


def reduce_system_k(nbk: NormalBlocksK, lam) -> SchurSystemK:
    sys = reduce_system(nbk.base, lam)
    nb = nbk.base
    Ukk_d = _damp(nbk.Ukk, lam)
    # b_red_k = b_k - Wk V^{-1} b_p
    Vinv_bp = jnp.einsum("pij,pj->pi", sys.Vinv, nb.b_p)
    contrib = jnp.einsum("oij,oj->oi", nbk.Wk, Vinv_bp[nb.pt_id])
    b_red_k = nbk.b_k - jax.ops.segment_sum(
        contrib, nbk.group, num_segments=nbk.Ukk.shape[0])
    return SchurSystemK(sys, Ukk_d, nbk.Uck, nbk.Wk, b_red_k, nbk.group,
                        nbk.cam_group)


def schur_matvec_k(sk: SchurSystemK, x_c: jax.Array, x_k: jax.Array,
                   pt_sorted: bool = False):
    """Matvec of the reduced system over (poses, intrinsics groups)."""
    sys = sk.sys
    nb = sys.blocks
    # direct terms
    y_c = jnp.einsum("cij,cj->ci", sys.Ud, x_c)
    y_c += jnp.einsum("cij,cj->ci", sk.Uck, x_k[sk.cam_group])
    y_k = jnp.einsum("gij,gj->gi", sk.Ukk_d, x_k)
    y_k += jax.ops.segment_sum(
        jnp.einsum("cji,cj->ci", sk.Uck, x_c), sk.cam_group,
        num_segments=sk.n_groups)
    # point-mediated terms: z_p = V^{-1} (Wc^T x_c + Wk^T x_k) per point
    Wtx = jnp.einsum("oji,oj->oi", nb.Wc, x_c[nb.cam_id])
    Wtx += jnp.einsum("oji,oj->oi", sk.Wk, x_k[sk.group])
    z_p = jax.ops.segment_sum(Wtx, nb.pt_id, num_segments=sys.n_pts,
                              indices_are_sorted=pt_sorted)
    Vz = jnp.einsum("pij,pj->pi", sys.Vinv, z_p)
    y_c -= jax.ops.segment_sum(
        jnp.einsum("oij,oj->oi", nb.Wc, Vz[nb.pt_id]), nb.cam_id,
        num_segments=sys.n_cams)
    y_k -= jax.ops.segment_sum(
        jnp.einsum("oij,oj->oi", sk.Wk, Vz[nb.pt_id]), sk.group,
        num_segments=sk.n_groups)
    return y_c, y_k


def solve_points_k(sk: SchurSystemK, dx_c: jax.Array, dx_k: jax.Array,
                   pt_sorted: bool = False) -> jax.Array:
    nb = sk.sys.blocks
    Wtx = jnp.einsum("oji,oj->oi", nb.Wc, dx_c[nb.cam_id])
    Wtx += jnp.einsum("oji,oj->oi", sk.Wk, dx_k[sk.group])
    rhs = nb.b_p - jax.ops.segment_sum(Wtx, nb.pt_id, num_segments=sk.sys.n_pts,
                                       indices_are_sorted=pt_sorted)
    return jnp.einsum("pij,pj->pi", sk.sys.Vinv, rhs)


@partial(jax.jit, static_argnames=("iters", "pt_sorted"))
def pcg_k(sk: SchurSystemK, iters: int = 30, fixed_cam_mask=None,
          pt_sorted: bool = False):
    """Block-Jacobi PCG on the (poses + intrinsics) reduced system."""
    Minv_c = _inv_spd(sk.sys.Ud)
    Minv_k = _inv_spd(sk.Ukk_d)

    def proj(xc, xk):
        if fixed_cam_mask is None:
            return xc, xk
        return jnp.where(fixed_cam_mask[:, None], 0.0, xc), xk

    def prec(rc, rk):
        return (jnp.einsum("cij,cj->ci", Minv_c, rc),
                jnp.einsum("gij,gj->gi", Minv_k, rk))

    b_c, b_k = proj(sk.sys.b_red, sk.b_red_k)
    x = (jnp.zeros_like(b_c), jnp.zeros_like(b_k))
    r = (b_c, b_k)
    z = proj(*prec(*r))
    p = z

    def dot(a, b):
        return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

    def body(_, carry):
        x, r, z, p = carry
        Sp = proj(*schur_matvec_k(sk, *p, pt_sorted=pt_sorted))
        rz = dot(r, z)
        alpha = rz / jnp.maximum(dot(p, Sp), 1e-20)
        x2 = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r2 = (r[0] - alpha * Sp[0], r[1] - alpha * Sp[1])
        z2 = proj(*prec(*r2))
        beta = dot(r2, z2) / jnp.maximum(rz, 1e-20)
        p2 = (z2[0] + beta * p[0], z2[1] + beta * p[1])
        return (x2, r2, z2, p2)

    x, r, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, z, p))
    return x[0], x[1]


# ---------------------------------------------------------------------------
# PLANES pipeline: all block algebra over 2D (axis, k) arrays
# ---------------------------------------------------------------------------
# The (O,2,6)/(O,6,3)/(P,3,3) block arrays above have two small minor dims.
# This pipeline keeps every per-observation / per-point quantity as a 2D
# array with the large axis leading and does the 6x6/6x3/3x3 block algebra
# as explicit component FMAs.

class NormalBlocksP(NamedTuple):
    U: jax.Array        # (C,6,6)  (C is small; 3D is fine here)
    V9: jax.Array       # (P,9) row-major 3x3 point blocks — KEPT 2D
    W18: jax.Array      # (O,18) row-major 6x3 coupling blocks — KEPT 2D
    b_c: jax.Array      # (C,6)
    b_p: jax.Array      # (P,3)
    cam_id: jax.Array
    pt_id: jax.Array
    pt_rows: "SegmentRows | None" = None
    cam_rows: "SegmentRows | None" = None


def assemble_planes(Jc, Jp, r, w, cam_id, pt_id, n_cams: int, n_pts: int,
                    pt_sorted: bool = False, pt_rows=None,
                    cam_rows=None) -> NormalBlocksP:
    """Normal blocks from planes-layout Jacobians (lm._jacobians_planes).

    Jc: (O,12) = [du/d(w,t) | dv/d(w,t)]; Jp: (O,6) = [du/dX | dv/dX].
    """
    Ju = [Jc[:, a] for a in range(6)]
    Jv = [Jc[:, 6 + a] for a in range(6)]
    Pu = [Jp[:, a] for a in range(3)]
    Pv = [Jp[:, 3 + a] for a in range(3)]
    ru, rv = r[:, 0], r[:, 1]

    U_o = jnp.stack([w * (Ju[a] * Ju[b] + Jv[a] * Jv[b])
                     for a in range(6) for b in range(6)], axis=-1)   # (O,36)
    V_o = jnp.stack([w * (Pu[a] * Pu[b] + Pv[a] * Pv[b])
                     for a in range(3) for b in range(3)], axis=-1)   # (O,9)
    W_o = jnp.stack([w * (Ju[a] * Pu[b] + Jv[a] * Pv[b])
                     for a in range(6) for b in range(3)], axis=-1)   # (O,18)
    bc_o = jnp.stack([-w * (Ju[a] * ru + Jv[a] * rv) for a in range(6)],
                     axis=-1)                                          # (O,6)
    bp_o = jnp.stack([-w * (Pu[b] * ru + Pv[b] * rv) for b in range(3)],
                     axis=-1)                                          # (O,3)

    if cam_rows is not None:
        U = rows_sum(U_o, cam_rows)
        b_c = rows_sum(bc_o, cam_rows)
    else:
        U = jax.ops.segment_sum(U_o, cam_id, num_segments=n_cams)
        b_c = jax.ops.segment_sum(bc_o, cam_id, num_segments=n_cams)
    if pt_rows is not None:
        V9 = rows_sum(V_o, pt_rows)
        b_p = rows_sum(bp_o, pt_rows)
    else:
        V9 = jax.ops.segment_sum(V_o, pt_id, num_segments=n_pts,
                                 indices_are_sorted=pt_sorted)
        b_p = jax.ops.segment_sum(bp_o, pt_id, num_segments=n_pts,
                                  indices_are_sorted=pt_sorted)
    return NormalBlocksP(U.reshape(n_cams, 6, 6), V9, W_o, b_c, b_p,
                         cam_id, pt_id, pt_rows, cam_rows)


def _damp_inv3_planes(V9: jax.Array, lam, eps: float = 1e-8) -> jax.Array:
    """(P,9) damped 3x3 inverse, fully component-wise: Vinv9 (P,9)."""
    a = V9[:, 0] * (1.0 + lam) + 1e-10 + eps
    b = V9[:, 1]
    c = V9[:, 2]
    d = V9[:, 3]
    e = V9[:, 4] * (1.0 + lam) + 1e-10 + eps
    f = V9[:, 5]
    g = V9[:, 6]
    h = V9[:, 7]
    i = V9[:, 8] * (1.0 + lam) + 1e-10 + eps
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return jnp.stack([A, B, Cc, D, E, F, G, H, I], axis=-1) / det[:, None]


def _mv3_planes(M9: jax.Array, v: jax.Array) -> jax.Array:
    """(N,9) 3x3 blocks @ (N,3) -> (N,3), component-wise."""
    return jnp.stack([
        M9[:, 0] * v[:, 0] + M9[:, 1] * v[:, 1] + M9[:, 2] * v[:, 2],
        M9[:, 3] * v[:, 0] + M9[:, 4] * v[:, 1] + M9[:, 5] * v[:, 2],
        M9[:, 6] * v[:, 0] + M9[:, 7] * v[:, 1] + M9[:, 8] * v[:, 2],
    ], axis=-1)


def _W_t_x(W18: jax.Array, xg: jax.Array) -> jax.Array:
    """(O,18) 6x3 blocks^T @ (O,6) -> (O,3)."""
    return jnp.stack([
        sum(W18[:, a * 3 + j] * xg[:, a] for a in range(6)) for j in range(3)
    ], axis=-1)


def _W_x(W18: jax.Array, v: jax.Array) -> jax.Array:
    """(O,18) 6x3 blocks @ (O,3) -> (O,6)."""
    return jnp.stack([
        sum(W18[:, a * 3 + j] * v[:, j] for j in range(3)) for a in range(6)
    ], axis=-1)


class SchurSystemP(NamedTuple):
    blocks: NormalBlocksP
    Vinv9: jax.Array      # (P,9)
    Ud: jax.Array         # (C,6,6)
    b_red: jax.Array      # (C,6)

    @property
    def n_cams(self) -> int:
        return self.Ud.shape[0]

    @property
    def n_pts(self) -> int:
        return self.Vinv9.shape[0]


def _reduce_pt(nb, x_o, pt_sorted: bool):
    if nb.pt_rows is not None:
        return rows_sum(x_o, nb.pt_rows)
    return jax.ops.segment_sum(x_o, nb.pt_id, num_segments=nb.V9.shape[0],
                               indices_are_sorted=pt_sorted)


def _reduce_cam(nb, x_o):
    if nb.cam_rows is not None:
        return rows_sum(x_o, nb.cam_rows)
    return jax.ops.segment_sum(x_o, nb.cam_id, num_segments=nb.U.shape[0])


def reduce_system_planes(nb: NormalBlocksP, lam,
                         pt_sorted: bool = False) -> SchurSystemP:
    Ud = _damp(nb.U, lam)
    Vinv9 = _damp_inv3_planes(nb.V9, lam)
    Vinv_bp = _mv3_planes(Vinv9, nb.b_p)                 # (P,3)
    contrib = _W_x(nb.W18, Vinv_bp[nb.pt_id])            # (O,6)
    b_red = nb.b_c - _reduce_cam(nb, contrib)
    return SchurSystemP(nb, Vinv9, Ud, b_red)


def schur_matvec_planes(sys: SchurSystemP, x: jax.Array,
                        pt_sorted: bool = False) -> jax.Array:
    nb = sys.blocks
    Ux = jnp.einsum("cij,cj->ci", sys.Ud, x)
    Wtx = _W_t_x(nb.W18, x[nb.cam_id])                   # (O,3)
    y_p = _reduce_pt(nb, Wtx, pt_sorted)                 # (P,3)
    Vy = _mv3_planes(sys.Vinv9, y_p)
    z_o = _W_x(nb.W18, Vy[nb.pt_id])                     # (O,6)
    return Ux - _reduce_cam(nb, z_o)


def solve_points_planes(sys: SchurSystemP, dx_c: jax.Array,
                        pt_sorted: bool = False) -> jax.Array:
    nb = sys.blocks
    Wtx = _W_t_x(nb.W18, dx_c[nb.cam_id])
    rhs = nb.b_p - _reduce_pt(nb, Wtx, pt_sorted)
    return _mv3_planes(sys.Vinv9, rhs)


@partial(jax.jit, static_argnames=("iters", "pt_sorted"))
def pcg_planes(sys: SchurSystemP, iters: int = 30, fixed_cam_mask=None,
               pt_sorted: bool = False):
    """Block-Jacobi PCG on the planes-layout reduced camera system."""
    Minv = _inv_spd(sys.Ud)

    def proj(x):
        if fixed_cam_mask is None:
            return x
        return jnp.where(fixed_cam_mask[:, None], 0.0, x)

    b = proj(sys.b_red)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = proj(jnp.einsum("cij,cj->ci", Minv, r0))

    def body(_, carry):
        x, r, z, p = carry
        Sp = proj(schur_matvec_planes(sys, p, pt_sorted=pt_sorted))
        rz = jnp.sum(r * z)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-20)
        x2 = x + alpha * p
        r2 = r - alpha * Sp
        z2 = proj(jnp.einsum("cij,cj->ci", Minv, r2))
        beta = jnp.sum(r2 * z2) / jnp.maximum(rz, 1e-20)
        return (x2, r2, z2, z2 + beta * p)

    x, r, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, z0))
    return x, jnp.sqrt(jnp.sum(r * r))
