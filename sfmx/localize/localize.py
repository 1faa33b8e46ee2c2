"""Visual localization: retrieval → 2D-3D matching → PnP-RANSAC.

Capability parity: the reference's C++ localizer (SURVEY.md §3.2): query
features → candidate keyframe retrieval (BoW/beacon prefilter) → 2D-3D
matching against landmark descriptors → solvePnPRansac → pose + inlier
confidence.

Design: the whole query path is ONE jitted function over static
capacities — global-descriptor GEMM retrieval, candidate-landmark gather,
(K x M) descriptor GEMM with mutual-best + absolute threshold, batched
PnP-RANSAC, GN refine.  It vmaps over a query batch, which is what the
serving layer (C14) feeds it.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import cameras
from ..core.masking import NEG_INF
from ..mapstore.scene import Scene
from ..solvers import pnp, ransac


class LocalizationMap(NamedTuple):
    """Device-resident map for serving. P landmarks, C keyframes, D desc dim."""

    X: jax.Array          # (P,3) landmark positions
    lm_desc: jax.Array    # (P,D) mean landmark descriptor (unit norm)
    lm_alive: jax.Array   # (P,)
    kf_gdesc: jax.Array   # (C,G) keyframe global descriptor (VLAD or mean)
    kf_alive: jax.Array   # (C,)
    kf_centers: jax.Array  # (C,3) keyframe camera centers (for beacon gating)
    kf_lm: jax.Array      # (C,Kc) landmark ids observed per keyframe (-1 pad -> 0)
    kf_lm_mask: jax.Array  # (C,Kc)
    vocab: jax.Array | None = None  # (V,D) VLAD vocabulary; None = mean pooling
    lm_bits: jax.Array | None = None  # (P,W) uint32 majority-vote M-LDB bits


class LocalizeResult(NamedTuple):
    R: jax.Array          # (3,3) world->cam
    t: jax.Array          # (3,)
    n_inliers: jax.Array  # () int32
    confidence: jax.Array  # () float in [0,1]
    center: jax.Array     # (3,) camera center in world frame


def _majority_bits(feat_bits: np.ndarray, obs_cam, obs_feat, obs_pt,
                   alive, P: int) -> np.ndarray:
    """Per-landmark majority vote over packed binary observation descriptors.

    The binary analog of mean-pooling float descriptors: landmark bit b is set
    iff more than half of its observations have it set (ties -> 0).
    """
    W = feat_bits.shape[-1]
    d = feat_bits[obs_cam[alive], obs_feat[alive]]         # (O,W) uint32
    shifts = np.arange(32, dtype=np.uint32)
    unpacked = ((d[:, :, None] >> shifts) & 1).astype(np.int32).reshape(len(d), -1)
    cnt1 = np.zeros((P, W * 32), np.int32)
    np.add.at(cnt1, obs_pt[alive], unpacked)
    n = np.zeros(P, np.int32)
    np.add.at(n, obs_pt[alive], 1)
    maj = (2 * cnt1 > n[:, None]).reshape(P, W, 32).astype(np.uint32)
    return np.sum(maj << shifts, axis=-1, dtype=np.uint32)


def build_localization_map(scene: Scene, feat_desc: np.ndarray,
                           obs_feat: np.ndarray, kf_lm_cap: int = 512,
                           kp_mask: np.ndarray | None = None,
                           use_vlad: bool = True, n_words: int = 64,  # 64: strict recall@8
                           # 0.875->1.0 on the 1024-frame corridor
                           # (bench_scripts/recall_vocab.py; 128 over-
                           # fragments and drops back to 0.938)
                           seed: int = 0,
                           feat_bits: np.ndarray | None = None) -> LocalizationMap:
    """Aggregate per-feature descriptors into the serving map (host-side, once).

    Args:
      feat_desc: (C,K,D) float descriptors of every keyframe feature.
      obs_feat: (O,) feature index of each scene observation (from TrackTable).
      kp_mask: (C,K) validity of feature slots (defaults to nonzero rows).
      use_vlad: build a visual vocabulary + VLAD keyframe descriptors (C8);
        mean pooling otherwise.
    """
    obs_cam = np.asarray(scene.obs_cam)
    obs_pt = np.asarray(scene.obs_pt)
    obs_alive = np.asarray(scene.obs_alive)
    P = scene.X.shape[0]
    C, K, D = feat_desc.shape

    lm_desc = np.zeros((P, D), np.float32)
    cnt = np.zeros(P, np.float32)
    d = feat_desc[obs_cam[obs_alive], obs_feat[obs_alive]]
    np.add.at(lm_desc, obs_pt[obs_alive], d)
    np.add.at(cnt, obs_pt[obs_alive], 1.0)
    lm_desc /= np.maximum(cnt[:, None], 1.0)
    lm_desc /= np.maximum(np.linalg.norm(lm_desc, axis=1, keepdims=True), 1e-8)

    if kp_mask is None:
        kp_mask = np.linalg.norm(feat_desc, axis=-1) > 1e-6
    vocab = None
    if use_vlad:
        from . import retrieve

        valid = lm_desc[cnt > 0]
        if len(valid) >= n_words:
            import jax.random as jrandom

            vocab = retrieve.build_vocabulary(
                jnp.asarray(valid), jnp.ones(len(valid), bool),
                jrandom.PRNGKey(seed), n_words=n_words,
            )
            kf_gdesc = np.asarray(retrieve.vlad_encode_b(
                jnp.asarray(feat_desc), jnp.asarray(kp_mask), vocab))
        else:
            use_vlad = False
    if not use_vlad:
        kf_gdesc = feat_desc.mean(axis=1)
        kf_gdesc /= np.maximum(np.linalg.norm(kf_gdesc, axis=1, keepdims=True), 1e-8)

    kf_lm = np.zeros((C, kf_lm_cap), np.int32)
    kf_lm_mask = np.zeros((C, kf_lm_cap), bool)
    for c in range(C):
        ids = np.unique(obs_pt[(obs_cam == c) & obs_alive])
        if len(ids) > kf_lm_cap:
            # keep the MOST-OBSERVED landmarks (strongest tracks), not the
            # lowest track ids np.unique happens to sort first
            ids = ids[np.argsort(-cnt[ids], kind="stable")[:kf_lm_cap]]
        n = len(ids)
        kf_lm[c, :n] = ids[:n]
        kf_lm_mask[c, :n] = True

    lm_bits = None
    if feat_bits is not None:
        # binary M-LDB serving path (reference's primary AKAZE descriptors):
        # per-landmark majority vote over packed observation bits
        lm_bits = jnp.asarray(_majority_bits(
            np.asarray(feat_bits), obs_cam, obs_feat, obs_pt, obs_alive, P))

    return LocalizationMap(
        X=scene.X,
        lm_desc=jnp.asarray(lm_desc),
        lm_alive=scene.X_alive,
        kf_gdesc=jnp.asarray(kf_gdesc),
        kf_alive=scene.cam_alive,
        kf_centers=scene.centers,
        kf_lm=jnp.asarray(kf_lm),
        kf_lm_mask=jnp.asarray(kf_lm_mask),
        vocab=vocab,
        lm_bits=lm_bits,
    )


@partial(jax.jit, static_argnames=("top_k_kf", "m_cap", "k_hypotheses",
                                   "pnp_solver"))
def localize_query(
    lmap: LocalizationMap,
    q_desc: jax.Array,      # (K,D) query descriptors (unit norm)
    q_uv: jax.Array,        # (K,2) pixel coords
    q_mask: jax.Array,      # (K,)
    intr: jax.Array,        # (7,) query camera intrinsics
    key: jax.Array,
    *,
    top_k_kf: int = 8,
    m_cap: int = 2048,
    k_hypotheses: int = 1024,
    px_thresh: float = 4.0,
    sim_thresh: float = 0.75,
    min_inliers: int = 12,
    prior_center: jax.Array | None = None,
    prior_radius: float = 0.0,
    q_bits: jax.Array | None = None,
    ham_thresh: float = 120.0,
    pnp_solver: str = "dlt6",
) -> LocalizeResult:
    """Localize one query image against the map. Fully jitted; vmap for batches.

    prior_center/prior_radius: optional beacon-fused position prior — keyframes
    outside the radius are excluded from retrieval (C10 fusion hook).

    q_bits: (K,W) packed M-LDB query bits — when both this and lmap.lm_bits
    are present, 2D-3D matching runs on Hamming distance (the reference's
    primary binary AKAZE path); retrieval stays on float VLAD either way.
    ham_thresh: absolute Hamming acceptance threshold in bits (~0.25 * 486).
    """
    # --- retrieval (C8): VLAD (or mean) global scores, optional beacon gate
    if lmap.vocab is not None:
        from . import retrieve

        qg = retrieve.vlad_encode(q_desc, q_mask, lmap.vocab)
    else:
        qg = jnp.sum(jnp.where(q_mask[:, None], q_desc, 0.0), axis=0)
        qg = qg / jnp.maximum(jnp.linalg.norm(qg), 1e-8)
    scores = lmap.kf_gdesc @ qg  # (C,)
    gate = lmap.kf_alive
    if prior_center is not None:
        d2 = jnp.sum((lmap.kf_centers - prior_center) ** 2, axis=-1)
        gate = gate & (d2 <= prior_radius * prior_radius)
    scores = jnp.where(gate, scores, NEG_INF)
    # clamp: small maps may hold fewer keyframes than the retrieval fan-out
    _, kf_idx = jax.lax.top_k(scores, min(top_k_kf, scores.shape[0]))
    kf_ok = jnp.take(scores, kf_idx) > NEG_INF / 2

    # --- candidate landmark set (gather; duplicates tolerated) -------------
    cand = lmap.kf_lm[kf_idx].reshape(-1)[:m_cap]
    cand_mask = (lmap.kf_lm_mask[kf_idx] & kf_ok[:, None]).reshape(-1)[:m_cap]
    cand_mask &= lmap.lm_alive[cand]
    cdesc = lmap.lm_desc[cand]          # (M,D)
    cX = lmap.X[cand]                   # (M,3)

    # --- 2D-3D matching: absolute-threshold + mutual best ------------------
    binary = lmap.lm_bits is not None and q_bits is not None
    if binary:
        from ..kernels import matching

        cbits = lmap.lm_bits[cand]                       # (M,W)
        sim = -matching.hamming_distance(q_bits, cbits).astype(jnp.float32)
        accept = -ham_thresh
    else:
        sim = jnp.dot(q_desc, cdesc.T, preferred_element_type=jnp.float32)
        accept = sim_thresh
    sim = jnp.where(q_mask[:, None] & cand_mask[None, :], sim, NEG_INF)
    best_m = jnp.argmax(sim, axis=1)                     # (K,)
    best_s = jnp.max(sim, axis=1)
    mutual = jnp.argmax(sim, axis=0)[best_m] == jnp.arange(q_desc.shape[0])
    corr_ok = (best_s > accept) & mutual & q_mask

    xn = cameras.pixel_to_normalized(intr, q_uv)         # (K,2)
    X3 = cX[best_m]                                      # (K,3)

    # --- PnP-RANSAC + refine ----------------------------------------------
    return _pnp_from_matches(xn, X3, corr_ok, intr, key,
                             k_hypotheses=k_hypotheses, px_thresh=px_thresh,
                             min_inliers=min_inliers, pnp_solver=pnp_solver)


def localize_batch(lmap: LocalizationMap, q_desc, q_uv, q_mask, intr, key,
                   q_bits=None, **kw):
    """vmapped batch localization: leading axis B on q_*; shared intrinsics."""
    keys = jax.random.split(key, q_desc.shape[0])
    if q_bits is not None and lmap.lm_bits is not None:
        fn = lambda d, u, m, k_, b: localize_query(
            lmap, d, u, m, intr, k_, q_bits=b, **kw)
        return jax.vmap(fn)(q_desc, q_uv, q_mask, keys, q_bits)
    fn = lambda d, u, m, k_: localize_query(lmap, d, u, m, intr, k_, **kw)
    return jax.vmap(fn)(q_desc, q_uv, q_mask, keys)


# ---------------------------------------------------------------------------
# Map-scale streaming path: match against the WHOLE landmark pool.
#
# The gather path above caps candidates at m_cap and depends on retrieval
# picking the right keyframes; at map scale (10^5-10^6 landmarks) the dense
# (K, P) similarity matrix would also fill device memory.  Here the top-2
# kernel (kernels/top2.py) keeps each similarity tile on chip — traffic is
# O(K*D + P*D), the (K, P) matrix never exists — so one kernel call matches a
# whole query batch against every alive landmark.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k_hypotheses", "pnp_solver"))
def _pnp_from_matches(xn, X3, corr_ok, intr, key, *, k_hypotheses,
                      px_thresh, min_inliers, pnp_solver: str = "dlt6"):
    """Shared PnP-RANSAC + GN tail of both matching paths (one query).

    pnp_solver: "dlt6" (6-pt DLT, the high-inlier default) or "p3p"
    (Grunert 3-pt minimal, 4 candidates/sample — survives low inlier
    ratios; see solvers/p3p.py).
    """
    f_mean = 0.5 * (intr[0] + intr[1])
    thresh_n = (px_thresh / f_mean) ** 2

    def residual_fn(model, xn_d, X_d):
        R, t = model
        r = pnp.pnp_residual(R, t, xn_d, X_d)
        return jnp.sum(r * r, axis=-1)

    if pnp_solver == "p3p":
        from ..solvers import p3p

        solver, sample_size, n_cand = p3p.p3p_minimal, p3p.MIN_SAMPLE, p3p.N_CANDIDATES
    else:
        solver, sample_size, n_cand = pnp.dlt_pnp_minimal, pnp.MIN_SAMPLE, 1
    (R, t), inliers, _ = ransac.ransac(
        key, solver, residual_fn, (xn, X3), corr_ok,
        k_hypotheses=k_hypotheses, sample_size=sample_size,
        inlier_threshold=thresh_n, n_candidates=n_cand,
    )
    R, t = pnp.refine_pnp_gn(R, t, xn, X3, inliers)
    r = residual_fn((R, t), xn, X3)
    inliers = (r < thresh_n) & corr_ok
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    n_corr = jnp.maximum(jnp.sum(corr_ok.astype(jnp.int32)), 1)
    conf = jnp.where(
        n_inl >= min_inliers,
        jnp.clip(n_inl.astype(jnp.float32) / n_corr.astype(jnp.float32), 0.0, 1.0),
        0.0,
    )
    return LocalizeResult(R=R, t=t, n_inliers=n_inl, confidence=conf,
                          center=-R.T @ t)


def localize_batch_streaming(
    lmap: LocalizationMap,
    q_desc: jax.Array,      # (B,K,D)
    q_uv: jax.Array,        # (B,K,2)
    q_mask: jax.Array,      # (B,K)
    intr: jax.Array,        # (7,) shared or (B,7) per-query intrinsics
    key: jax.Array,
    *,
    k_hypotheses: int = 1024,
    px_thresh: float = 4.0,
    ratio: float = 0.85,
    sim_thresh: float = 0.75,
    min_inliers: int = 12,
    prior_center: jax.Array | None = None,
    prior_radius: float = 0.0,
    pnp_solver: str = "dlt6",
) -> LocalizeResult:
    """Batch localization against the full landmark pool (no m_cap, no
    retrieval gather).  The whole (B*K) query set streams against every
    alive landmark in ONE kernel call, then PnP-RANSAC vmaps per query.

    Acceptance = Lowe ratio test + absolute similarity floor (no mutual
    check: the second pass over P it would need costs more than RANSAC
    absorbs in wrong matches).  prior_center/prior_radius gate landmarks by
    position (the beacon-fusion hook, here applied to points directly
    rather than to retrieved keyframes).
    """
    from ..kernels.top2 import match_float_streaming

    B, K, D = q_desc.shape
    lm_mask = lmap.lm_alive
    if prior_center is not None:
        d2 = jnp.sum((lmap.X - prior_center) ** 2, axis=-1)
        lm_mask = lm_mask & (d2 <= prior_radius * prior_radius)
    m = match_float_streaming(
        q_desc.reshape(B * K, D), lmap.lm_desc,
        q_mask.reshape(B * K), lm_mask, ratio=ratio)
    idx = m.idx.reshape(B, K)
    corr_ok = (m.valid & (m.score > sim_thresh)).reshape(B, K)
    X3 = lmap.X[idx]                                     # (B,K,3)

    intr_b = jnp.broadcast_to(jnp.atleast_2d(intr), (B, 7))
    xn = jax.vmap(cameras.pixel_to_normalized)(intr_b, q_uv)
    keys = jax.random.split(key, B)
    fn = partial(_pnp_from_matches, k_hypotheses=k_hypotheses,
                 px_thresh=px_thresh, min_inliers=min_inliers,
                 pnp_solver=pnp_solver)
    return jax.vmap(fn)(xn, X3, corr_ok, intr_b, keys)


def localize_query_streaming(lmap: LocalizationMap, q_desc, q_uv, q_mask,
                             intr, key, **kw) -> LocalizeResult:
    """Single-query convenience wrapper over the streaming batch path."""
    res = localize_batch_streaming(
        lmap, q_desc[None], q_uv[None], q_mask[None], intr, key, **kw)
    return jax.tree_util.tree_map(lambda x: x[0], res)


def use_streaming(lc, lmap: LocalizationMap, binary: bool) -> bool:
    """Policy for LocalizeConfig.streaming: off | on | auto (map-size gated).

    Binary maps keep the gather path — the streaming matcher is float only.
    """
    if binary or lc.streaming == "off":
        return False
    if lc.streaming == "on":
        return True
    return lc.streaming == "auto" and lmap.X.shape[0] >= lc.streaming_min_landmarks
