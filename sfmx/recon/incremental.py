"""Incremental SfM engine: two-view init → resection → triangulation → BA.

Capability parity: OpenMVG's ``SequentialSfM_ReconstructionEngine``
(SURVEY.md C4, §3.1 hot loop 3): initial-pair selection, E-matrix two-view
initialization, sequential PnP resection, track triangulation, periodic
bundle adjustment, outlier pruning.

Design (not a translation):
  * Landmark id == track id.  The observation table is FIXED at track-build
    time; "growing the map" = flipping alive masks.  Every device step —
    resection RANSAC, triangulate-everything, BA — therefore runs at one
    static shape and compiles exactly once per map build.
  * Triangulation is not per-track: each round re-triangulates ALL
    unreconstructed tracks against the current registered set in one vmapped
    N-view DLT call and gates the results (cheirality, parallax, reprojection).
  * The outer loop (which camera next) is host orchestration — it is
    O(#cams) decision logic, not compute.
"""
from __future__ import annotations

import dataclasses
import time as _time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import cameras
from ..mapstore.scene import Scene, new_scene
from ..solvers import epipolar, lm, pnp, ransac, triangulate
from .tracks import TrackTable


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    max_track_views: int = 8          # V cap for n-view triangulation
    ransac_hypotheses: int = 512
    resection_solver: str = "dlt6"    # dlt6 | p3p (3-pt, 4 candidates)
    px_thresh: float = 4.0            # inlier threshold (pixels)
    min_parallax_deg: float = 1.5
    min_init_inliers: int = 30
    min_resection_inliers: int = 10
    ba_every: int = 3
    ba_iters: int = 10
    final_ba_iters: int = 25
    cg_iters: int = 30
    huber_px: float = 4.0
    min_track_views: int = 2
    batch_resection: bool = True   # resect ALL eligible cams per round (scalable)
    # Multi-component reconstruction (VERDICT r4 item 1 / BASELINE r4):
    # single-seed incremental growth is seed-sensitive on long loop-free
    # walks — a bad seed strands a frontier (measured 783-997/1024 corridor
    # frames from identical match data).  When coverage stalls below
    # coverage_target, a SECONDARY component is seeded among the
    # unregistered cameras (plus a bridge of covisible registered ones),
    # grown with the same machinery, and fused into the primary via the
    # VERIFIED shared-track/shared-camera sim3 (recon/register.py) — loud
    # failure, never a blind stitch.
    max_components: int = 3
    coverage_target: float = 0.96
    bridge_cams: int = 48
    refine_intrinsics: tuple | None = None  # e.g. ("f","k1"): joint final BA
    # final-BA fault recovery (SURVEY §5.3): when set, the final global BA
    # runs in checkpointed chunks and resumes from ckpt after a crash
    final_ba_ckpt: str | None = None
    final_ba_ckpt_every: int = 10
    seed: int = 0


# ---------------------------------------------------------------------------
# Device steps (jit once per map build; all static shapes)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k_hyp",))
def _init_pair_step(key, xn_a, xn_b, valid, thresh, k_hyp: int):
    """E-RANSAC + relative pose for a candidate init pair."""

    def solver(x1s, x2s):
        return epipolar.eight_point(x1s, x2s, jnp.ones(x1s.shape[0], bool), essential=True)

    def residual_fn(E, x1d, x2d):
        return epipolar.sampson_error(E, x1d, x2d)

    E, inliers, cnt = ransac.ransac(
        key, solver, residual_fn, (xn_a, xn_b), valid,
        k_hypotheses=k_hyp, sample_size=8, inlier_threshold=thresh,
    )
    R, t, n_front, X = epipolar.relative_pose_from_essential(E, xn_a, xn_b, inliers)
    # median triangulation angle of inliers
    c1 = jnp.zeros(3, xn_a.dtype)
    c2 = -R.T @ t
    par = triangulate.parallax_deg(c1, c2, X)
    par_med = jnp.nanmedian(jnp.where(inliers, par, jnp.nan))
    return R, t, inliers, cnt, par_med


@partial(jax.jit, static_argnames=("k_hyp",))
def _init_pair_batch(keys, xn_a, xn_b, valid, thresh, k_hyp: int):
    """All init-pair candidates scored in ONE vmapped device call."""
    return jax.vmap(
        lambda k, a, b, v: _init_pair_step(k, a, b, v, thresh, k_hyp)
    )(keys, xn_a, xn_b, valid)


@partial(jax.jit, static_argnames=("k_hyp", "solver"))
def _resect_batch(keys, xn_b, X_b, valid_b, thresh_n, k_hyp: int,
                  solver: str = "dlt6"):
    """vmapped resection: all eligible cameras in one device call."""

    def one(key, xn, X, valid):
        return _resect_step_impl(key, xn, X, valid, thresh_n, k_hyp, solver)

    return jax.vmap(one)(keys, xn_b, X_b, valid_b)


def _resect_step_impl(key, xn, X, valid, thresh_n, k_hyp: int,
                      solver: str = "dlt6"):
    """PnP-RANSAC + GN refine for one camera against its 2D-3D set."""

    def residual_fn(model, xn_d, X_d):
        R, t = model
        r = pnp.pnp_residual(R, t, xn_d, X_d)
        return jnp.sum(r * r, axis=-1)

    if solver == "p3p":
        from ..solvers import p3p

        min_solver, n_samp, n_cand = p3p.p3p_minimal, p3p.MIN_SAMPLE, p3p.N_CANDIDATES
    else:
        min_solver, n_samp, n_cand = pnp.dlt_pnp_minimal, pnp.MIN_SAMPLE, 1
    (R, t), inliers, cnt = ransac.ransac(
        key, min_solver, residual_fn, (xn, X), valid,
        k_hypotheses=k_hyp, sample_size=n_samp, inlier_threshold=thresh_n,
        n_candidates=n_cand,
    )
    R, t = pnp.refine_pnp_gn(R, t, xn, X, inliers)
    r = residual_fn((R, t), xn, X)
    inliers = (r < thresh_n) & valid
    return R, t, inliers, jnp.sum(inliers.astype(jnp.int32))


_resect_step = jax.jit(_resect_step_impl, static_argnames=("k_hyp", "solver"))


@jax.jit
def _triangulate_all(cam_R, cam_t, registered, xn_feat, tr_obs_cam, tr_obs_xn_idx,
                     tr_obs_mask, thresh_n, min_parallax_deg):
    """Re-triangulate every track from its registered observations.

    Args:
      xn_feat: (C,K,2) normalized coords of all features.
      tr_obs_cam:    (T,V) camera id of each track observation slot.
      tr_obs_xn_idx: (T,V) feature index of that observation.
      tr_obs_mask:   (T,V) slot validity (track may have <V observations).

    Returns (X (T,3), ok (T,)) gated on cheirality in all registered views,
    reprojection below thresh_n in all of them, and max pairwise parallax.
    """
    use = tr_obs_mask & registered[tr_obs_cam]  # (T,V)
    P_all = jnp.concatenate([cam_R, cam_t[:, :, None]], axis=2)  # (C,3,4)
    Ps = P_all[tr_obs_cam]  # (T,V,3,4)
    xns = xn_feat[tr_obs_cam, tr_obs_xn_idx]  # (T,V,2)
    X, ok2 = triangulate.triangulate_nview_b(Ps, xns, use)

    # Gates, all masked over V slots.
    Xc = jnp.einsum("tvij,tj->tvi", Ps[:, :, :, :3], X) + Ps[:, :, :, 3]
    z = Xc[..., 2]
    cheir = jnp.where(use, z > 1e-3, True).all(axis=1)
    reproj = Xc[..., :2] / jnp.where(jnp.abs(z[..., None]) < 1e-9, 1e-9, z[..., None]) - xns
    err = jnp.sum(reproj * reproj, axis=-1)
    reproj_ok = jnp.where(use, err < thresh_n, True).all(axis=1)
    centers = -jnp.einsum("cji,cj->ci", cam_R, cam_t)[tr_obs_cam]  # (T,V,3)
    d = centers - X[:, None, :]
    dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("tvi,twi->tvw", dn, dn)
    pair_ok = use[:, :, None] & use[:, None, :]
    min_cos = jnp.min(jnp.where(pair_ok, cosang, 1.0), axis=(1, 2))
    par_ok = min_cos < jnp.cos(jnp.deg2rad(min_parallax_deg))
    return X, ok2 & cheir & reproj_ok & par_ok


@jax.jit
def _reproj_err2_norm(cam_R, cam_t, X, obs_cam, obs_pt, xn_obs):
    """Squared reprojection error in normalized coords for every observation."""
    Xc = jnp.einsum("oij,oj->oi", cam_R[obs_cam], X[obs_pt]) + cam_t[obs_cam]
    z = Xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    r = Xc[:, :2] / zs[:, None] - xn_obs
    behind = z <= 1e-4
    return jnp.sum(r * r, axis=-1) + jnp.where(behind, 1e6, 0.0)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

class ReconError(RuntimeError):
    pass


def reconstruct(
    kp_uv: np.ndarray,      # (C,K,2) keypoint pixel coords
    kp_mask: np.ndarray,    # (C,K)
    tt: TrackTable,
    intr: np.ndarray,       # (I,7)
    cam_k: np.ndarray,      # (C,) intrinsics index
    cfg: ReconConfig = ReconConfig(),
    callbacks=None,
    pair_counts: tuple | None = None,   # (pairs (Np,2), per-pair match counts)
) -> tuple[Scene, dict]:
    C, K, _ = kp_uv.shape
    T = tt.n_tracks
    if T == 0:
        raise ReconError("no tracks")
    O = len(tt.obs_cam)
    V = cfg.max_track_views
    key = jax.random.PRNGKey(cfg.seed)
    f_mean = float(np.mean(intr[:, :2]))
    # Self-calibrating builds start from a guessed focal: correct geometry
    # then reprojects with errors ~ focal-error * radial-distance (tens of
    # px at the image edge), so the inlier gates must be proportionally lax
    # until the final joint intrinsics BA tightens the model.
    gate_scale = 4.0 if cfg.refine_intrinsics else 1.0
    thresh_n = (gate_scale * cfg.px_thresh / f_mean) ** 2

    # Normalized coords for every feature (device, batched).
    intr_j = jnp.asarray(intr, jnp.float32)
    xn_feat = jax.vmap(lambda k_v, uv: cameras.pixel_to_normalized(k_v, uv))(
        intr_j[np.asarray(cam_k)], jnp.asarray(kp_uv, jnp.float32)
    )  # (C,K,2)
    xn_feat_np = np.asarray(xn_feat)

    # Per-track observation slots: (T,V) static SHAPE, dynamic CONTENTS.
    # Filling them with the first V observations once would strand long
    # tracks — a track spanning cams 20..70 whose first 8 observations sit
    # in an unregistered region can never triangulate even though dozens of
    # registered cameras observe it, and incremental growth stalls at the
    # first such frontier.  Instead ``refresh_slots`` re-points each
    # not-yet-alive track's slots at (an even spread of) its REGISTERED
    # observations before every triangulation round — the classical
    # "triangulate from registered views" semantics at one compiled shape.
    starts, ends = tt.track_slices()
    tr_obs_cam = np.zeros((T, V), np.int32)
    tr_obs_feat = np.zeros((T, V), np.int32)
    tr_obs_mask = np.zeros((T, V), bool)

    # Scene obs table == track table (landmark id = track id).
    obs_cam = tt.obs_cam
    obs_pt = tt.obs_track
    obs_uv = kp_uv[obs_cam, tt.obs_feat]
    xn_obs = xn_feat_np[obs_cam, tt.obs_feat]

    # Host-side mutable state.
    registered = np.zeros(C, bool)
    failed = np.zeros(C, bool)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    X = np.zeros((T, 3), np.float32)
    X_alive = np.zeros(T, bool)
    obs_pruned = np.zeros(O, bool)

    # Per-cam track lists (host, static).
    cam_tracks = [tt.obs_track[obs_cam == c] for c in range(C)]
    cam_feats = [tt.obs_feat[obs_cam == c] for c in range(C)]

    def obs_alive_mask():
        return registered[obs_cam] & X_alive[obs_pt] & ~obs_pruned

    # ---- initial-pair candidates ------------------------------------------
    # Candidates come from DIRECT per-pair match counts when the pipeline
    # provides them (pair_counts): chained track covisibility is poisoned by
    # drift on long chains — a pair that never directly matched can share
    # dozens of tracks of which few are E-consistent.  Without pair_counts
    # (direct reconstruct() calls), fall back to chained covisibility, mixing
    # the LEAST-covisible pairs above a quality floor (covisibility
    # anti-correlates with baseline, and near-zero-baseline neighbors fail
    # the parallax gate) with the strongest pairs.
    if pair_counts is not None:
        prs_all, pcnt_all = pair_counts
        prs_all, pcnt_all = np.asarray(prs_all), np.asarray(pcnt_all)
    else:
        cov = np.zeros((C, C), np.int32)
        for s, e in zip(starts, ends):
            cams_in = tt.obs_cam[s:e]
            for i in range(len(cams_in)):
                for j in range(i + 1, len(cams_in)):
                    a, b = cams_in[i], cams_in[j]
                    cov[a, b] += 1
                    cov[b, a] += 1
        au, bu = np.triu_indices(C, k=1)
        prs_all = np.stack([au, bu], axis=1)
        pcnt_all = cov[au, bu]

    def make_pair_order(allowed, focus=None):
        """Seed-candidate pairs restricted to ``allowed`` cameras (and, if
        given, touching at least one ``focus`` camera — used to aim a
        secondary component's seed into the uncovered region)."""
        keep = allowed[prs_all[:, 0]] & allowed[prs_all[:, 1]]
        if focus is not None:
            keep &= focus[prs_all[:, 0]] | focus[prs_all[:, 1]]
        prs, pcnt = prs_all[keep], pcnt_all[keep]
        selp = np.flatnonzero(pcnt >= cfg.min_init_inliers)
        selp = selp[np.argsort(-pcnt[selp])]
        if len(selp) > 48:
            # quantile-sample the whole count range: count anti-correlates
            # with baseline, and taking only the top-k would yield 48
            # near-zero-baseline neighbors that all fail the parallax gate
            selp = selp[np.round(np.linspace(0, len(selp) - 1, 48)).astype(int)]
        return [(int(a), int(b)) for a, b in prs[selp]]

    def refresh_slots():
        """Re-point dead tracks' V slots at a spread of their registered
        observations (alive tracks keep their slots for stability)."""
        reg_obs = registered[obs_cam] & ~obs_pruned
        nreg = np.bincount(obs_pt[reg_obs], minlength=T)
        for t_i in np.flatnonzero(~X_alive & (nreg >= 2)):
            s, e = starts[t_i], ends[t_i]
            ridx = s + np.flatnonzero(reg_obs[s:e])
            if len(ridx) > V:  # even spread across the (camera-ordered) track
                ridx = ridx[np.round(np.linspace(0, len(ridx) - 1, V)).astype(int)]
            n = len(ridx)
            tr_obs_cam[t_i, :n] = tt.obs_cam[ridx]
            tr_obs_feat[t_i, :n] = tt.obs_feat[ridx]
            tr_obs_mask[t_i, :n] = True
            tr_obs_mask[t_i, n:] = False

    # per-phase wall-time breakdown of the round loop (VERDICT r4: the
    # reconstruct stage was 66% of the 512-frame build and unprofiled)
    phase_s = {"slots": 0.0, "triangulate": 0.0, "resect_gather": 0.0,
               "resect": 0.0, "ba": 0.0, "eligibility": 0.0}

    def run_triangulation():
        t0 = _time.time()
        refresh_slots()
        phase_s["slots"] += _time.time() - t0
        t0 = _time.time()
        Xn, ok = _triangulate_all(
            jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(registered),
            xn_feat, jnp.asarray(tr_obs_cam), jnp.asarray(tr_obs_feat),
            jnp.asarray(tr_obs_mask), thresh_n, cfg.min_parallax_deg,
        )
        ok = np.asarray(ok)
        Xn = np.asarray(Xn)
        newly = ok & ~X_alive
        X[newly] = Xn[newly]
        X_alive[newly] = True
        phase_s["triangulate"] += _time.time() - t0

    def run_ba(iters, ckpt_path=None, huber_scale=1.0, prune=True):
        nonlocal cam_R, cam_t, X
        t_ba = _time.time()
        alive = obs_alive_mask()
        n_alive = int(alive.sum())
        if n_alive == 0:
            return
        # BA sees only the ALIVE observations, pow2-bucketed (padding rows
        # are real dead obs at weight 0) so a growing map re-jits O(log)
        # times; the full table is ~3x the alive set on corridor builds.
        bucket = 1 << max(0, (n_alive - 1).bit_length())
        if bucket < O:
            ai = np.flatnonzero(alive)
            di = np.flatnonzero(~alive)[: bucket - n_alive]
            sel = np.concatenate([ai, di])
        else:
            sel = np.arange(O)
        w = alive[sel].astype(np.float32)
        obs_cam_s, obs_pt_s = obs_cam[sel], obs_pt[sel]
        fixed = np.zeros(C, bool)
        fixed[~registered] = True
        fixed[np.flatnonzero(registered)[0]] = True
        ba_args = (
            intr_j, jnp.asarray(cam_k, jnp.int32),
            jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(X),
            jnp.asarray(obs_cam_s), jnp.asarray(obs_pt_s),
            jnp.asarray(obs_uv[sel], jnp.float32),
            jnp.asarray(w), jnp.asarray(fixed))
        if ckpt_path is not None:
            # checkpointed final solve: chunks + resume (SURVEY §5.3)
            from ..solvers import ba_ckpt

            R2, t2, X2, costs = ba_ckpt.ba_solve_checkpointed(
                *ba_args, total_iters=iters,
                ckpt_every=cfg.final_ba_ckpt_every, ckpt_path=ckpt_path,
                cg_iters=cfg.cg_iters,
                huber_px=cfg.huber_px * huber_scale)[:4]
        else:
            R2, t2, X2, costs = lm.ba_solve(
                *ba_args, iters=iters, cg_iters=cfg.cg_iters,
                huber_px=cfg.huber_px * huber_scale)
        # np.array (copy): jax->numpy views are read-only, host state is mutable
        cam_R = np.array(R2)
        cam_t = np.array(t2)
        X = np.array(X2)
        stats["ba_costs"].append([float(costs[0]), float(costs[-1])])
        # cumulative real-build BA throughput (proves which path carried it)
        wall = _time.time() - t_ba
        phase_s["ba"] += wall
        if len(stats.setdefault("ba_call_s", [])) < 64:
            stats["ba_call_s"].append(
                [len(obs_pt_s), iters, round(wall, 2)])
        stats["ba_total_s"] = round(stats.get("ba_total_s", 0.0) + wall, 2)
        stats["ba_total_iters"] = stats.get("ba_total_iters", 0) + iters
        stats["ba_iters_per_s"] = round(
            stats["ba_total_iters"] / max(stats["ba_total_s"], 1e-9), 2)
        # prune observations with large error; kill starved points.
        # prune=False exists for the fusion-BA anneal: right after a sim3
        # fuse, the CROSS-component observations are exactly the
        # large-residual ones, and pruning them here would cut the hinge
        # that constrains the fused geometry (seed-2 corridor: hinge obs
        # pruned -> final BA bent the map to 8.8 m ATE at 0.29 px median
        # reprojection).
        if prune:
            err2 = np.asarray(_reproj_err2_norm(
                jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(X),
                jnp.asarray(obs_cam), jnp.asarray(obs_pt), jnp.asarray(xn_obs, jnp.float32),
            ))
            obs_pruned[:] |= (err2 > thresh_n * 4.0) & obs_alive_mask()
            alive = obs_alive_mask()
            obs_count = np.bincount(obs_pt[alive], minlength=T)
            X_alive[obs_count < cfg.min_track_views] = False

    stats = {"ransac_inliers": [], "ba_costs": [], "components": [],
             "phase_s": phase_s, "n_rounds": 0}

    def try_seed(pair_order):
        """Score all candidate pairs, trial-BA the best few, keep the best-
        fitting seed.  Returns (ok, diag); on ok the state holds the seeded
        two-view reconstruction."""
        nonlocal cam_R, cam_t, X, key
        best = None  # (med_px, (a, b), state snapshot)
        cntc = parc = None
        if not pair_order:
            return False, "no candidates proposed"
        # score ALL candidates in one vmapped device call, then seed from the
        # best: gate = enough E-inliers + median triangulation angle in a sane
        # band; rank passing candidates by inlier count
        nc = len(pair_order)
        nc_pad = 1 << max(0, (nc - 1).bit_length())  # one program per bucket
        xa_b = np.zeros((nc_pad, K, 2), np.float32)
        xb_b = np.zeros((nc_pad, K, 2), np.float32)
        valid_b = np.zeros((nc_pad, K), bool)
        for ci, (a, b) in enumerate(pair_order):
            shared, ia, ib = np.intersect1d(cam_tracks[a], cam_tracks[b],
                                            return_indices=True)
            n = min(len(shared), K)
            xa_b[ci, :n] = xn_feat_np[a, cam_feats[a][ia[:n]]]
            xb_b[ci, :n] = xn_feat_np[b, cam_feats[b][ib[:n]]]
            valid_b[ci, :n] = True
        key, sk = jax.random.split(key)
        keys = jax.random.split(sk, nc_pad)
        Rc, tc, _inlc, cntc, parc = _init_pair_batch(
            keys, jnp.asarray(xa_b), jnp.asarray(xb_b), jnp.asarray(valid_b),
            thresh_n, cfg.ransac_hypotheses)
        Rc, tc = np.asarray(Rc)[:nc], np.asarray(tc)[:nc]
        cntc, parc = np.asarray(cntc)[:nc], np.asarray(parc)[:nc]
        passing = ((cntc >= cfg.min_init_inliers)
                   & (parc > cfg.min_parallax_deg) & (parc < 60.0))
        # Seed-quality selection: a geometrically passing but degenerate
        # seed (e.g. an oblique view of one plane) drags the whole
        # reconstruction into a bad optimum later global BAs cannot leave.
        # So BA each candidate's two-view seed and keep the best-FITTING of
        # the first few that triangulate (median reprojection in px).
        # Trial order weights inliers by (capped) parallax and mild frame
        # centrality: raw inlier count always surfaces ADJACENT frames
        # (max covisibility, near-zero baseline) on dense walkthroughs —
        # a narrow seed registers far fewer cameras downstream — and on a
        # sequential walk an END seed doubles the frontier distance the
        # incremental loop must cover (measured on a 1024-frame corridor:
        # central seed 997 registered, z=75% seed 783, from the same
        # match data).
        mid = np.array([(a + b) for (a, b) in pair_order], np.float64) / 2.0
        central = 1.0 - 0.6 * np.abs(mid - C / 2.0) / max(C / 2.0, 1)
        trial_score = np.where(
            passing, cntc * np.minimum(parc, 15.0) * central, -1.0)
        trials = 0
        for ci in np.argsort(-trial_score):
            if not passing[ci] or trials >= 3:
                break
            a, b = pair_order[ci]
            cam_R[a], cam_t[a] = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            cam_R[b], cam_t[b] = Rc[ci], tc[ci]
            registered[a] = registered[b] = True
            pruned_snap = obs_pruned.copy()
            run_triangulation()
            if X_alive.sum() >= max(8, cfg.min_init_inliers // 2):
                trials += 1
                run_ba(cfg.ba_iters)
                alive = obs_alive_mask()
                err2 = np.asarray(_reproj_err2_norm(
                    jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(X),
                    jnp.asarray(obs_cam), jnp.asarray(obs_pt),
                    jnp.asarray(xn_obs, jnp.float32)))
                med_px = float(np.sqrt(np.median(err2[alive]))) * f_mean \
                    if alive.any() else np.inf
                n_pts = int(X_alive.sum())
                if (n_pts >= max(8, cfg.min_init_inliers // 2)
                        and med_px < cfg.px_thresh
                        and (best is None or med_px < best[0])):
                    best = (med_px, (int(a), int(b)),
                            (cam_R.copy(), cam_t.copy(), X.copy(),
                             X_alive.copy(), obs_pruned.copy()))
            # reset to the pre-init state for the next trial
            registered[a] = registered[b] = False
            X_alive[:] = False
            obs_pruned[:] = pruned_snap
        if best is None:
            diag = (f"{len(pair_order)} candidates: "
                    f"{int((cntc >= cfg.min_init_inliers).sum())} passed the "
                    f"inlier gate (>= {cfg.min_init_inliers}; max {int(cntc.max())}), "
                    f"{int(passing.sum())} also passed the parallax band "
                    f"({cfg.min_parallax_deg}-60 deg; median "
                    f"{float(np.median(parc)):.2f} deg, max {float(parc.max()):.2f})")
            return False, diag
        med_px, (a, b), (cam_R, cam_t, X, X_alive[:], obs_pruned[:]) = best
        registered[a] = registered[b] = True
        stats.setdefault("init_pairs", []).append((a, b, round(med_px, 4)))
        return True, None

    # ---- incremental loop --------------------------------------------------
    # Round-based: every round resects either the single best camera (the
    # classical sequential engine) or ALL eligible cameras at once in one
    # vmapped device call (batch_resection — the scalable default; OpenMVG
    # registers one view per loop, which serializes thousands of device
    # round-trips at config-4/5 scale).
    failed = np.zeros(C, bool)
    points_at_failure = np.full(C, -1.0)

    def incremental_loop(allowed):
        nonlocal key
        n_since_ba = 0
        while True:
            t0 = _time.time()
            stats["n_rounds"] += 1
            counts = np.array([
                0 if (registered[c] or not allowed[c])
                else int(X_alive[cam_tracks[c]].sum())
                for c in range(C)
            ])
            # Failed cameras become eligible again once the structure THEY
            # see has grown 25% (or by 15 points) since their failure.  The
            # retry condition must be per-camera: a frontier expanding into
            # a new region (e.g. the first room of a corridor when the seed
            # landed mid-corridor) adds points slowly relative to the whole
            # map, so a global-growth trigger never fires and the frontier's
            # failed cameras stay dead forever (measured: 278 of 1024
            # corridor frames permanently unregistered at the ends).
            retry = failed & (points_at_failure >= 0) & (
                (counts > 1.25 * points_at_failure)
                | (counts > points_at_failure + 15))
            failed[retry] = False
            counts[failed] = 0
            eligible = np.where(counts >= cfg.min_resection_inliers)[0]
            if len(eligible) == 0:
                break
            if cfg.batch_resection:
                # take only well-supported cameras each round: weakly-covered
                # views wait for BA-consolidated structure (keeps batch mode at
                # sequential-mode accuracy)
                gate = max(cfg.min_resection_inliers, 0.5 * counts.max())
                eligible = eligible[counts[eligible] >= gate]
            else:
                eligible = eligible[np.argsort(counts[eligible])[::-1][:1]]
            phase_s["eligibility"] += _time.time() - t0
            t0 = _time.time()

            # pow2-bucketed batch: nb varies every round, and an unpadded
            # batch is a fresh XLA program per distinct size (25+ rounds =
            # 25 compiles of the most expensive step in the build)
            nb = len(eligible)
            nb_pad = 1 << max(0, (nb - 1).bit_length())
            xs = np.zeros((nb_pad, K, 2), np.float32)
            Xs = np.zeros((nb_pad, K, 3), np.float32)
            valid = np.zeros((nb_pad, K), bool)
            sels = []
            for bi, c in enumerate(eligible):
                sel = X_alive[cam_tracks[c]]
                n = min(int(sel.sum()), K)
                feats_sel = cam_feats[c][sel][:n]
                tracks_sel = cam_tracks[c][sel][:n]
                xs[bi, :n] = xn_feat_np[c, feats_sel]
                Xs[bi, :n] = X[tracks_sel]
                valid[bi, :n] = True
                sels.append(tracks_sel)
            phase_s["resect_gather"] += _time.time() - t0
            t0 = _time.time()
            key, sk = jax.random.split(key)
            keys = jax.random.split(sk, nb_pad)
            Rb, tb, inlb, cntb = _resect_batch(
                keys, jnp.asarray(xs), jnp.asarray(Xs), jnp.asarray(valid),
                thresh_n, cfg.ransac_hypotheses, cfg.resection_solver,
            )
            Rb, tb = np.asarray(Rb), np.asarray(tb)
            inlb, cntb = np.asarray(inlb), np.asarray(cntb)
            phase_s["resect"] += _time.time() - t0
            for bi, c in enumerate(eligible):
                if int(cntb[bi]) < cfg.min_resection_inliers:
                    failed[c] = True
                    # per-camera: the alive-structure count THIS camera saw at
                    # failure (retry fires when its own coverage grows)
                    points_at_failure[c] = counts[c]
                    continue
                cam_R[c] = Rb[bi]
                cam_t[c] = tb[bi]
                registered[c] = True
                stats["ransac_inliers"].append(int(cntb[bi]))
                tracks_sel = sels[bi]
                bad_tracks = tracks_sel[~inlb[bi][: len(tracks_sel)]]
                if len(bad_tracks):
                    bad = (obs_cam == c) & np.isin(obs_pt, bad_tracks)
                    obs_pruned[bad] = True
    
            run_triangulation()
            n_since_ba += 1
            if n_since_ba >= cfg.ba_every or cfg.batch_resection:
                run_ba(cfg.ba_iters)
                n_since_ba = 0
            if callbacks:
                callbacks(registered.copy(), X_alive.copy())

    def _med_reproj_px():
        alive_m = obs_alive_mask()
        if not alive_m.any():
            return float("inf")
        err2 = np.asarray(_reproj_err2_norm(
            jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(X),
            jnp.asarray(obs_cam), jnp.asarray(obs_pt),
            jnp.asarray(xn_obs, jnp.float32)))
        return float(np.sqrt(np.median(err2[alive_m]))) * f_mean

    # ---- primary component -------------------------------------------------
    all_cams = np.ones(C, bool)
    ok, seed_diag = try_seed(make_pair_order(all_cams))
    if not ok:
        raise ReconError(
            f"no valid initial pair (all candidates failed to seed): {seed_diag}")
    stats["init_pair"] = stats["init_pairs"][0][:2]
    stats["init_med_px"] = stats["init_pairs"][0][2]
    incremental_loop(all_cams)
    stats["components"].append(
        {"component": 0, "registered": int(registered.sum())})

    # ---- secondary components: multi-seed coverage recovery ----------------
    # A stalled frontier (seed-sensitive coverage, BASELINE r4) is recovered
    # by seeding a NEW component among the unregistered cameras + a bridge
    # of covisible registered ones, growing it with the same machinery, and
    # fusing it into the primary through the VERIFIED shared-track /
    # shared-camera similarity.  Registration failure = component dropped
    # (diagnostics recorded), never a blind stitch.
    from .register import (RegistrationError, register_points_verified,
                           register_rigid_anchored)

    has_tracks = np.array([len(cam_tracks[c]) > 0 for c in range(C)])
    n_possible = max(int(has_tracks.sum()), 1)
    comp = 1
    # a rolled-back fusion retries ONCE with a doubled bridge: the failure
    # mode is a too-thin hinge (few shared cams/tracks at a doorway), and
    # more bridge cameras give the secondary more shared structure to
    # anchor and more cross-observations to constrain the fused BA
    fuse_attempts = 0
    bridge_n = cfg.bridge_cams
    while (comp < cfg.max_components
           and registered.sum() < cfg.coverage_target * n_possible):
        U = has_tracks & ~registered
        if U.sum() < max(4, cfg.min_init_inliers // 4):
            break
        snap = (registered.copy(), failed.copy(), points_at_failure.copy(),
                cam_R.copy(), cam_t.copy(), X.copy(), X_alive.copy(),
                obs_pruned.copy())
        # bridge: the registered cameras with the strongest direct matches
        # into the uncovered set (they give the fused component shared
        # structure to register against)
        bscore = np.zeros(C, np.int64)
        in_u_a = U[prs_all[:, 0]]
        in_u_b = U[prs_all[:, 1]]
        reg_a = registered[prs_all[:, 0]]
        reg_b = registered[prs_all[:, 1]]
        np.add.at(bscore, prs_all[in_u_a & reg_b, 1],
                  pcnt_all[in_u_a & reg_b])
        np.add.at(bscore, prs_all[in_u_b & reg_a, 0],
                  pcnt_all[in_u_b & reg_a])
        bridge = np.zeros(C, bool)
        top_b = np.argsort(-bscore)[:bridge_n]
        bridge[top_b] = bscore[top_b] > 0
        allowed2 = U | bridge
        # fresh state for the secondary component
        registered[:] = False
        failed[:] = False
        points_at_failure[:] = -1.0
        X_alive[:] = False
        obs_pruned[:] = False
        ok2, diag2 = try_seed(make_pair_order(allowed2, focus=U))
        if ok2:
            incremental_loop(allowed2)
        sec = (registered.copy(), cam_R.copy(), cam_t.copy(), X.copy(),
               X_alive.copy())
        (registered[:], failed[:], points_at_failure[:], cam_R[:], cam_t[:],
         X[:], X_alive[:], obs_pruned[:]) = snap  # restore primary
        reg_sec, camR_sec, camt_sec, X_sec, Xalive_sec = sec
        new_cams = reg_sec & ~registered
        if not ok2 or int(new_cams.sum()) == 0:
            stats["components"].append(
                {"component": comp,
                 "fail": diag2 or "secondary registered no new cameras"})
            fuse_attempts += 1
            bridge_n *= 2
            if fuse_attempts >= 2:
                break
            continue
        shared_t = X_alive & Xalive_sec
        shared_c = registered & reg_sec
        Pa_l = [X[shared_t]]
        Pb_l = [X_sec[shared_t]]
        if shared_c.any():
            Pa_l.append(-np.einsum("cji,cj->ci", cam_R[shared_c],
                                   cam_t[shared_c]))
            Pb_l.append(-np.einsum("cji,cj->ci", camR_sec[shared_c],
                                   camt_sec[shared_c]))
        try:
            if int(shared_c.sum()) >= 3:
                # rotation anchored on shared camera orientations: the
                # shared structure concentrates at the frontier boundary,
                # where point-only Umeyama is rotation/scale-degenerate
                # (measured: 92% inlier frac, halves 15-33 deg apart).
                # Scale/translation gates are LOOSE here (0.25/0.10): on a
                # drift-prone loop-free walk the two components' scales
                # genuinely disagree by percents, and the post-fusion BA
                # verification below is the authoritative accept/rollback.
                reg = register_rigid_anchored(
                    cam_R[shared_c], camR_sec[shared_c],
                    np.concatenate(Pa_l), np.concatenate(Pb_l),
                    min_point_inliers=max(8, cfg.min_init_inliers // 3),
                    agree_scale=None, agree_trans_frac=None)
            else:
                key, sk = jax.random.split(key)
                reg = register_points_verified(
                    np.concatenate(Pa_l), np.concatenate(Pb_l), key=sk,
                    min_inliers=max(8, cfg.min_init_inliers // 3))
        except RegistrationError as e:
            stats["components"].append(
                {"component": comp, "new_cams": int(new_cams.sum()),
                 "fail": f"sim3 verification: {e}"})
            fuse_attempts += 1
            bridge_n *= 2
            if fuse_attempts >= 2:
                break
            continue

        pre_med_px = _med_reproj_px()
        pre_snap = (registered.copy(), failed.copy(),
                    points_at_failure.copy(), cam_R.copy(), cam_t.copy(),
                    X.copy(), X_alive.copy(), obs_pruned.copy())
        # fuse: secondary poses/points into the primary frame (B->A world
        # similarity: R' = Rc R^T, t' = s tc - R' t, X' = s R X + t)
        X2 = reg.s * (X_sec @ reg.R.T) + reg.t
        R2 = np.einsum("cij,kj->cik", camR_sec, reg.R)
        t2 = reg.s * camt_sec - np.einsum("cij,j->ci", R2, reg.t)
        cam_R[new_cams] = R2[new_cams]
        cam_t[new_cams] = t2[new_cams]
        registered[new_cams] = True
        new_pts = Xalive_sec & ~X_alive
        X[new_pts] = X2[new_pts]
        X_alive[new_pts] = True
        failed[:] = False
        points_at_failure[:] = -1.0
        run_triangulation()
        # Annealed-Huber fusion BA, pruning deferred: a slightly-off sim3
        # puts ALL cross-component residuals past huber_px, where Huber's
        # linear tail barely pulls — BA then converges bent-but-consistent
        # (and the pruning pass would delete the hinge outright).  Widening
        # Huber first makes the hinge quadratic again so the long-wavelength
        # correction actually happens; pruning waits for the gate.
        # 25 iterations per anneal stage: the correction is long-wavelength
        # (a degree of hinge error bends the far end by meters) and 10-iter
        # stages measured stuck at ~1.7 px post-fusion where more LM
        # iterations keep converging; warm calls cost ~0.12 s / iter here
        fuse_iters = max(cfg.ba_iters, 25)
        run_ba(fuse_iters, huber_scale=8.0, prune=False)
        run_ba(fuse_iters, huber_scale=2.0, prune=False)
        run_ba(fuse_iters, prune=False)
        # the authoritative fusion verification: the similarity gates above
        # pass plausible-but-drifted registrations through; joint BA either
        # absorbs the disagreement (reprojection returns to the pre-fusion
        # level) or cannot (the fused frontier is wrong) — rollback then.
        # The old absolute escape hatch (cfg.px_thresh = 4 px) accepted the
        # seed-2 corridor's bent fusions at 1.35-2.40 px; the floor is now
        # 0.25 * px_thresh = 1 px.
        post_med_px = _med_reproj_px()
        if post_med_px > max(1.5 * pre_med_px, 0.25 * cfg.px_thresh):
            (registered[:], failed[:], points_at_failure[:], cam_R[:],
             cam_t[:], X[:], X_alive[:], obs_pruned[:]) = pre_snap
            stats["components"].append(
                {"component": comp, "new_cams": int(new_cams.sum()),
                 "fail": ("post-fusion BA verification: median reprojection "
                          f"{pre_med_px:.2f} -> {post_med_px:.2f} px; "
                          "rolled back")})
            fuse_attempts += 1
            bridge_n *= 2
            if fuse_attempts >= 2:
                break
            continue
        stats["components"].append(
            {"component": comp, "new_cams": int(new_cams.sum()),
             "new_points": int(new_pts.sum()),
             "reg_inliers": int(reg.inliers.sum()),
             "shared_tracks": int(shared_t.sum()),
             "shared_cams": int(shared_c.sum()),
             "med_px": [round(pre_med_px, 3), round(post_med_px, 3)]})
        # fused structure may unlock previously stalled cameras everywhere
        incremental_loop(all_cams)
        comp += 1
        fuse_attempts = 0
        bridge_n = cfg.bridge_cams

    run_ba(cfg.final_ba_iters, ckpt_path=cfg.final_ba_ckpt)

    if cfg.refine_intrinsics:
        # final joint pose+point+intrinsics LM (self-calibration; the
        # reference's ADJUST_ALL default) — focal/distortion errors trade off
        # against depth and are invisible to alternating refinement
        alive_w = obs_alive_mask().astype(np.float32)
        fixedm = np.zeros(C, bool)
        fixedm[~registered] = True
        fixedm[np.flatnonzero(registered)[0]] = True
        R2, t2, X2, intr2, _ = lm.ba_solve_intrinsics(
            intr_j, jnp.asarray(cam_k, jnp.int32),
            jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(X),
            jnp.asarray(obs_cam), jnp.asarray(obs_pt),
            jnp.asarray(obs_uv, jnp.float32), jnp.asarray(alive_w),
            jnp.asarray(fixedm), params=tuple(cfg.refine_intrinsics),
            iters=cfg.final_ba_iters, cg_iters=cfg.cg_iters,
            huber_px=cfg.huber_px,
        )
        cam_R, cam_t, X = np.array(R2), np.array(t2), np.array(X2)
        intr = np.array(intr2)
        stats["refined_intrinsics"] = np.asarray(intr2).tolist()

    scene = new_scene(C, T, O, intr, cam_k=jnp.asarray(cam_k, jnp.int32))
    scene = dataclasses.replace(
        scene,
        cam_R=jnp.asarray(cam_R), cam_t=jnp.asarray(cam_t),
        cam_alive=jnp.asarray(registered),
        X=jnp.asarray(X), X_alive=jnp.asarray(X_alive),
        obs_cam=jnp.asarray(obs_cam, jnp.int32), obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_uv=jnp.asarray(obs_uv, jnp.float32), obs_alive=jnp.asarray(obs_alive_mask()),
    )
    stats["n_registered"] = int(registered.sum())
    stats["n_points"] = int(X_alive.sum())
    stats["final_med_px"] = round(_med_reproj_px(), 4)
    stats["phase_s"] = {k: round(v, 2) for k, v in phase_s.items()}
    return scene, stats
