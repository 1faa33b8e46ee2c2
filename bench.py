"""Headline benchmark: full query-localization path, frames/s per chip.

Measures the serving-path hot loop (BASELINE.json north-star "query frames/s
per chip"): feature extraction (nonlinear scale space + NMS + descriptors)
plus the jitted localize path (retrieval GEMM -> 2D-3D matching GEMM ->
batched PnP-RANSAC -> GN refine) for a batch of VGA frames against a
device-resident map.

vs_baseline: the same per-frame workload through the reference's CPU stack
stand-in (OpenCV AKAZE detectAndCompute + BFMatcher ratio test +
solvePnPRansac — the exact components hulop/SfMLocalization uses), measured
on this host.  The real reference pipeline was not obtainable (SURVEY.md §0).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus the
other BASELINE.json north stars as extra keys — BA LM-iters/s at config-3
scale, pairwise matching pairs/s, and MFU / roofline fractions computed
against the device's MEASURED peak bf16 matmul FLOP/s and memory bandwidth.
Every sub-bench must succeed: a failure stops the run with a non-zero exit.
"""
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

B = 16          # query batch
H, W = 480, 640
K_FEAT = 512
P_MAP = 8192    # landmarks
C_KF = 256      # keyframes


def measure_peaks():
    """Measured chip ceilings the roofline fractions divide by.

    Peak bf16 matmul FLOP/s: 4096^3 GEMM (tensor-core bound).  Memory
    bandwidth: elementwise add over 256 MiB (reads + writes counted).
    """
    import jax
    import jax.numpy as jnp

    # chain the GEMMs inside one program so per-call dispatch does not
    # swamp the timing
    n, chain = 4096, 32
    a = jnp.ones((n, n), jnp.bfloat16)

    @jax.jit
    def gemm_chain(a):
        def body(x, _):
            y = jnp.dot(x, a, preferred_element_type=jnp.float32)
            return y.astype(jnp.bfloat16) * (1.0 / n), None
        out, _ = jax.lax.scan(body, a, None, length=chain)
        return out

    jax.block_until_ready(gemm_chain(a))
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = gemm_chain(a)
    jax.block_until_ready(out)
    tflops = 2.0 * n ** 3 * chain * reps / (time.time() - t0) / 1e12

    m = 64 * 1024 * 1024  # 256 MiB of f32

    @jax.jit
    def add_chain(x):
        def body(x, _):
            return x + 1.0, None
        out, _ = jax.lax.scan(body, x, None, length=chain)
        return out

    x = jnp.ones((m,), jnp.float32)
    jax.block_until_ready(add_chain(x))
    t0 = time.time()
    for _ in range(reps):
        out = add_chain(x)
    jax.block_until_ready(out)
    gbps = 2.0 * 4.0 * m * chain * reps / (time.time() - t0) / 1e9
    return tflops, gbps


def matching_throughput(peak_tflops):
    """Pairwise brute-force matching (SURVEY C3 hot loop) through the
    PRODUCTION entry ``match_pairs_float_auto`` — the top-2 kernel
    (kernels/top2.py) on the GPU, the chunked plain matcher on the CPU.

    FLOPs model: one (K,D)x(D,K) bf16 GEMM per pair = 2*K*K*D (the
    cross-check's second kernel call is not counted)."""
    import jax
    import jax.numpy as jnp

    from sfmx.kernels import features, matching

    C, K, D = 64, K_FEAT, features.N_FLOAT_DIM
    rng = np.random.default_rng(0)
    descs = rng.standard_normal((C, K, D)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    masks = np.ones((C, K), bool)
    npairs = 512
    pairs = rng.integers(0, C, (npairs, 2)).astype(np.int32)
    descs, masks, pairs = map(jnp.asarray, (descs, masks, pairs))

    fn = jax.jit(lambda d, m, p: matching.match_pairs_float_auto(d, m, p))
    out = fn(descs, masks, pairs)
    jax.block_until_ready(out.score)
    # reps sized to keep the async-dispatch queue full: map-build matching
    # issues tens of thousands of pairs back-to-back, so SUSTAINED
    # throughput is the relevant number
    reps = 40
    t0 = time.time()
    for _ in range(reps):
        out = fn(descs, masks, pairs)
    jax.block_until_ready(out.score)
    dt = (time.time() - t0) / reps
    pairs_per_s = npairs / dt
    mfu = pairs_per_s * 2.0 * K * K * D / (peak_tflops * 1e12)
    return pairs_per_s, mfu


def matching_throughput_band(peak_tflops):
    """Matching throughput on the pair DISTRIBUTION map building actually
    produces: a temporal band (window pairs) + retrieval extras over a
    256-image set (cli/pipeline.py:build_pairs_retrieval), through the same
    production entry as ``matching_throughput``."""
    import jax
    import jax.numpy as jnp

    from sfmx.kernels import features, matching

    C, K, D = 256, K_FEAT, features.N_FLOAT_DIM
    rng = np.random.default_rng(0)
    descs = rng.standard_normal((C, K, D)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    masks = jnp.asarray(np.ones((C, K), bool))
    pairs = {(a, b) for a in range(C) for b in range(a + 1, min(a + 27, C))}
    pairs |= {(int(rng.integers(0, C // 2)), int(rng.integers(C // 2, C)))
              for _ in range(C * 6)}
    pairs = np.array(sorted(pairs), np.int32)
    descs = jnp.asarray(descs)

    def fn():
        return matching.match_pairs_float_auto(descs, masks, pairs)

    out = fn()
    jax.block_until_ready(out.score)
    reps = 10
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out.score)
    dt = (time.time() - t0) / reps
    pairs_per_s = len(pairs) / dt
    mfu = pairs_per_s * 2.0 * K * K * D / (peak_tflops * 1e12)
    return pairs_per_s, mfu


def ba_throughput(hbm_gbps):
    """Global BA at config-3 scale (512 cams / 20k pts / 200k obs,
    Schur-complement LM + 30-iter PCG) through the planes formulation
    (``ba_solve(tp_cap=, tc_cap=)``: scatter-free padded segment tables).
    Visibility is camera-local (sliding window) like real incremental-SfM
    obs tables.

    Traffic model (lower bound, per observation per CG iteration): read W
    twice (2*18 f32), Vinv (9 f32), gather x[cam_id] (6 f32), the per-point
    intermediate (2*3 f32) and z_c (6 f32) = 252 B."""
    import jax
    import jax.numpy as jnp

    from sfmx.solvers import lm

    C, P, O = 512, 20000, 200000
    iters, cg_iters = 10, 30
    rng = np.random.default_rng(0)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-5, 5, (C, 2)),
                        np.full((C, 1), 20.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    pt_id = np.sort(rng.integers(0, P, O).astype(np.int32))
    span = 24
    base = (pt_id.astype(np.float64) / P * (C - span)).astype(np.int32)
    cam_id = (base + rng.integers(0, span, O)).astype(np.int32)
    tp = 1 << max(3, (int(np.bincount(pt_id).max()) - 1).bit_length())
    tc = 1 << max(3, (int(np.bincount(cam_id).max()) - 1).bit_length())
    Xc = X[pt_id] + t[cam_id]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.asarray([320.0, 240.0])
          + 0.5 * rng.standard_normal((O, 2))).astype(np.float32)
    intr = np.asarray([[500.0, 500.0, 320.0, 240.0, 0, 0, 0]], np.float32)
    fixed = jnp.zeros(C, bool).at[0].set(True)
    argsba = (jnp.asarray(intr), jnp.zeros(C, jnp.int32), jnp.asarray(R),
              jnp.asarray(t), jnp.asarray(X), jnp.asarray(cam_id),
              jnp.asarray(pt_id), jnp.asarray(uv), jnp.ones(O, jnp.float32),
              fixed)
    kw = dict(iters=iters, cg_iters=cg_iters, tp_cap=tp, tc_cap=tc)
    jax.block_until_ready(lm.ba_solve(*argsba, **kw))
    t0 = time.time()
    jax.block_until_ready(lm.ba_solve(*argsba, **kw))
    lm_iters_per_s = iters / (time.time() - t0)
    bytes_per_lm_iter = cg_iters * O * 252.0
    frac = lm_iters_per_s * bytes_per_lm_iter / (hbm_gbps * 1e9)
    return lm_iters_per_s, frac


def streaming_localize_fps():
    """Map-scale serving path: a 16-query batch matched against EVERY
    landmark of a 10^5-landmark map in one top-2 kernel call
    (localize_batch_streaming — no retrieval gather, no m_cap truncation),
    then batched PnP-RANSAC."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _example_map
    from sfmx.localize.localize import localize_batch_streaming

    B, K, P = 16, K_FEAT, 100_352
    lmap = jax.device_put(_example_map(P=P, C=512, D=128, Kc=256))
    rng = np.random.default_rng(1)
    q_desc = rng.standard_normal((B, K, 128)).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    q_uv = rng.uniform(0, W, (B, K, 2)).astype(np.float32)
    q_mask = np.ones((B, K), bool)
    intr = jnp.asarray([560.0, 560.0, W / 2, H / 2, 0, 0, 0], jnp.float32)
    fn = jax.jit(lambda d, u, m, k: localize_batch_streaming(
        lmap, d, u, m, intr, k, k_hypotheses=512))
    args = (jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask))
    out = fn(*args, jax.random.PRNGKey(0))
    jax.block_until_ready(out.confidence)
    reps = 5
    t0 = time.time()
    for i in range(reps):
        out = fn(*args, jax.random.PRNGKey(i + 1))
    jax.block_until_ready(out.confidence)
    return B * reps / (time.time() - t0)


def tracking_fps():
    """Sequential tracking steady state (localize/tracking.py): the whole
    frame sequence runs as ONE lax.scan device program — no per-frame
    dispatch or host sync.  min_conf=0 keeps the tracker in the prior-gated
    branch after frame 0, so this measures the TRACKED steady state (the
    prior-gated program is the same compute as global localization plus the
    prior mask).  Frames/s for a strictly sequential single-camera stream —
    the reference's NavCog deployment pattern (SURVEY §3.2)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _example_map
    from sfmx.localize.tracking import TrackingConfig

    N, K = 64, K_FEAT
    lmap = jax.device_put(_example_map(P=P_MAP, C=C_KF, D=128, Kc=256))
    rng = np.random.default_rng(2)
    q_desc = rng.standard_normal((N, K, 128)).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    q_uv = rng.uniform(0, W, (N, K, 2)).astype(np.float32)
    q_mask = np.ones((N, K), bool)
    intr = jnp.asarray([560.0, 560.0, W / 2, H / 2, 0, 0, 0], jnp.float32)
    from sfmx.localize.tracking import _sequence_scan

    cfg = TrackingConfig(radius=1e6, min_conf=0.0, min_inliers=0,
                         k_hypotheses=512, m_cap=2048)
    fn = jax.jit(lambda d, u, m, k: _sequence_scan(lmap, d, u, m, intr, k,
                                                   cfg))
    args = (jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    out = fn(*args, keys)
    jax.block_until_ready(out[0].confidence)
    t0 = time.time()
    out = fn(*args, jax.random.split(jax.random.PRNGKey(1), N))
    jax.block_until_ready(out[0].confidence)
    return N / (time.time() - t0)


def query_frames_per_s():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _example_map
    from sfmx.kernels import features
    from sfmx.localize.localize import localize_query

    lmap = _example_map(P=P_MAP, C=C_KF, D=features.N_FLOAT_DIM, Kc=256)
    lmap = jax.device_put(lmap)
    intr = jnp.asarray([560.0, 560.0, W / 2, H / 2, 0, 0, 0], jnp.float32)

    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.random((B, H, W)), jnp.float32)

    # Two jits dispatched back-to-back (device-side handoff, async dispatch
    # overlaps them).
    extract = jax.jit(lambda im: features.detect_and_describe(
        im, max_keypoints=K_FEAT, threshold=1e-7))

    @jax.jit
    def loc_path(desc, uv, mask, key):
        keys = jax.random.split(key, desc.shape[0])

        def one(d, u, m, k):
            return localize_query(lmap, d, u, m, intr, k,
                                  top_k_kf=8, m_cap=2048, k_hypotheses=512)

        return jax.vmap(one)(desc, uv, mask, keys)

    def query_path(imgs, key):
        feats = extract(imgs)
        return loc_path(feats.desc, feats.kp.uv, feats.kp.mask, key)

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    out = query_path(imgs, key)
    jax.block_until_ready(out.confidence)
    compile_s = time.time() - t0

    reps = 5
    t0 = time.time()
    for i in range(reps):
        out = query_path(imgs, jax.random.PRNGKey(i + 1))
    jax.block_until_ready(out.confidence)
    dt = (time.time() - t0) / reps
    return B / dt, compile_s


def accuracy_tripwire():
    """Correctness gate run BEFORE any timing loop: a geometrically
    consistent map — query descriptors ARE landmark descriptors, q_uv ARE
    their projections at a known pose — must localize
    with high inlier count and near-zero pose error through BOTH production
    paths (gather localize_query and streaming).  A regression that returns
    garbage poses at full speed now fails the bench instead of passing it.
    """
    import jax
    import jax.numpy as jnp

    from sfmx.localize.localize import (LocalizationMap, localize_query,
                                        localize_batch_streaming)

    P, C, Kc, D, K = 8192, 64, 128, 128, K_FEAT
    rng = np.random.default_rng(42)
    X = rng.uniform(-3.0, 3.0, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3.0, 8.0, P)          # in front of the camera
    lm_desc = rng.standard_normal((P, D)).astype(np.float32)
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    kf_lm = rng.permutation(P)[: C * Kc].reshape(C, Kc).astype(np.int32)
    kf_g = lm_desc[kf_lm].mean(1)
    kf_g /= np.maximum(np.linalg.norm(kf_g, axis=1, keepdims=True), 1e-8)
    lmap = jax.device_put(LocalizationMap(
        X=jnp.asarray(X), lm_desc=jnp.asarray(lm_desc),
        lm_alive=jnp.ones(P, bool), kf_gdesc=jnp.asarray(kf_g),
        kf_alive=jnp.ones(C, bool),
        kf_centers=jnp.zeros((C, 3), jnp.float32),
        kf_lm=jnp.asarray(kf_lm), kf_lm_mask=jnp.ones((C, Kc), bool)))
    # ground-truth camera: R=I, t=0; query sees keyframes 0-3's landmarks
    sel = kf_lm[:4].reshape(-1)[:K]
    fx = fy = 560.0
    q_desc = jnp.asarray(lm_desc[sel])
    q_uv = jnp.asarray(np.stack([
        fx * X[sel, 0] / X[sel, 2] + W / 2,
        fy * X[sel, 1] / X[sel, 2] + H / 2], 1).astype(np.float32))
    q_mask = jnp.ones(K, bool)
    intr = jnp.asarray([fx, fy, W / 2, H / 2, 0, 0, 0], jnp.float32)
    key = jax.random.PRNGKey(7)

    res = localize_query(lmap, q_desc, q_uv, q_mask, intr, key,
                         top_k_kf=8, m_cap=2048, k_hypotheses=512)
    n_inl = int(res.n_inliers)
    conf = float(res.confidence)
    terr = float(jnp.linalg.norm(res.t))
    rerr = float(jnp.linalg.norm(res.R - jnp.eye(3)))
    assert n_inl >= K // 2, f"tripwire: gather path inliers {n_inl} < {K//2}"
    assert conf > 0.5, f"tripwire: gather path confidence {conf}"
    assert terr < 0.05, f"tripwire: gather path |t| {terr}"
    assert rerr < 0.02, f"tripwire: gather path |R-I| {rerr}"

    sres = localize_batch_streaming(lmap, q_desc[None], q_uv[None],
                                    q_mask[None], intr, key,
                                    k_hypotheses=512)
    assert int(sres.n_inliers[0]) >= K // 2, \
        f"tripwire: streaming inliers {int(sres.n_inliers[0])}"
    assert float(jnp.linalg.norm(sres.t[0])) < 0.05, \
        f"tripwire: streaming |t| {float(jnp.linalg.norm(sres.t[0]))}"


def cpu_baseline_frames_per_s():
    """Reference-stack stand-in: SIFT + BF ratio match + solvePnPRansac."""
    try:
        import cv2
    except ImportError:
        return None
    rng = np.random.default_rng(0)
    img = (rng.random((H, W)) * 255).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)  # give AKAZE real structure
    # this cv2 build ships SIFT but not AKAZE; the reference supports both
    # extractors (BASELINE.json: "SIFT/AKAZE feature extraction")
    sift = cv2.SIFT_create(nfeatures=K_FEAT)
    map_desc = rng.random((2048, 128)).astype(np.float32)
    bf = cv2.BFMatcher(cv2.NORM_L2)
    obj = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    imgp = rng.uniform(0, 640, (512, 2)).astype(np.float32)
    Kmat = np.array([[560, 0, W / 2], [0, 560, H / 2], [0, 0, 1]], np.float32)

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        kp, desc = sift.detectAndCompute(img, None)
        if desc is not None and len(desc) >= 2:
            bf.knnMatch(desc[:K_FEAT], map_desc, k=2)
        cv2.solvePnPRansac(obj, imgp, Kmat, None, iterationsCount=512,
                           reprojectionError=4.0)
    dt = (time.time() - t0) / reps
    return 1.0 / dt


def geometric_verify_pairs_per_s():
    """Batched SVD-free E-RANSAC verification: Np pairs x K matches x H
    hypotheses through the production entry
    `matching.geometric_verify_pairs`."""
    import jax
    import jax.numpy as jnp

    from sfmx.kernels import matching
    from sfmx.kernels.matching import MatchResult

    Np, K, H = 256, K_FEAT, 256
    rng = np.random.default_rng(3)
    xn = jnp.asarray(rng.uniform(-0.5, 0.5, (8, K, 2)).astype(np.float32))
    kp_mask = jnp.ones((8, K), bool)
    pairs = jnp.asarray(rng.integers(0, 8, (Np, 2)).astype(np.int32))
    matches = MatchResult(
        idx=jnp.asarray(rng.integers(0, K, (Np, K)).astype(np.int32)),
        valid=jnp.ones((Np, K), bool),
        score=jnp.ones((Np, K), jnp.float32))
    fn = jax.jit(lambda k: matching.geometric_verify_pairs(
        k, xn, kp_mask, pairs, matches, threshold=1e-5, k_hypotheses=H))
    key = jax.random.PRNGKey(0)
    jax.block_until_ready(fn(key)[1])
    reps = 5
    t0 = time.time()
    for i in range(reps):
        out = fn(jax.random.PRNGKey(i))
    jax.block_until_ready(out[1])
    return Np * reps / (time.time() - t0)


def extract_stream_fps():
    """Warm steady-state extraction throughput (C2), 16-frame QVGA batches
    through the production `_extract_raw` program."""
    import jax

    from sfmx.cli.config import FeatureConfig, PipelineConfig
    from sfmx.cli.pipeline import _extract_raw

    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=K_FEAT))
    rng = np.random.default_rng(0)
    imgs = rng.random((16, 240, 320)).astype(np.float32)
    out = _extract_raw(imgs, cfg)
    jax.block_until_ready(out.kp.response)
    reps = 8
    t0 = time.time()
    for _ in range(reps):
        out = _extract_raw(imgs, cfg)
    jax.block_until_ready(out.kp.response)
    return 16 * reps / (time.time() - t0)


def serving_p95_ms():
    """Steady-state serving latency (C14): bursts of 16 concurrent
    feature-level requests through the micro-batching service after all
    batch buckets are warm — p95 measures serving, not compiles."""
    import asyncio

    import jax.numpy as jnp

    from __graft_entry__ import _example_map
    from sfmx.cli.config import PipelineConfig
    from sfmx.serve import LocalizationService
    from sfmx.serve.server import ServiceStats

    lmap = _example_map(P=20000, C=128, D=128, Kc=256)
    svc = LocalizationService(batch_window_ms=5.0, max_batch=16)
    svc.load_map("m", lmap, jnp.asarray([560.0, 560.0, W / 2, H / 2, 0, 0, 0],
                                        jnp.float32), cfg=PipelineConfig())
    rng = np.random.default_rng(5)
    B, K = 16, K_FEAT
    q_desc = rng.standard_normal((B, K, 128)).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    q_uv = rng.uniform(0, W, (B, K, 2)).astype(np.float32)
    q_mask = np.ones((B, K), bool)

    async def run():
        await svc.start()
        try:
            for r in range(6):
                if r == 3:
                    svc.stats = ServiceStats()  # drop warm-burst latencies
                await asyncio.gather(*[
                    svc.localize("m", q_desc[i], q_uv[i], q_mask[i])
                    for i in range(B)])
            return svc.stats.snapshot()
        finally:
            await svc.stop()

    st = asyncio.run(run())
    return st["p95_latency_ms"]


def map_build_fps():
    """END-TO-END map-build throughput (frames/s) at a fixed 96-frame
    rendered-room config through the real build_map pipeline (extract +
    match + geometric verify + tracks + incremental SfM + BA)."""
    sys.path.insert(0, REPO)
    from examples.room import RoomTexture, render_room, walk_poses
    from sfmx.cli.config import FeatureConfig, MatchConfig, PipelineConfig
    from sfmx.cli.pipeline import build_map

    frames = 96
    tex = RoomTexture(seed=7)
    poses = walk_poses(frames)
    imgs = np.stack([render_room(tex, R, eye, 320, 240, 280.0)
                     for (R, t, eye) in poses])
    intr = np.array([[280.0, 280.0, 160.0, 120.0, 0, 0, 0]], np.float32)
    cfg = PipelineConfig(
        features=FeatureConfig(max_keypoints=512),
        match=MatchConfig(pair_mode="window", window=max(6, frames // 8)),
        resize_to=(320, 240), focal_factor=0.875)
    t0 = time.time()
    scene, feats, tt, stats = build_map(imgs, intr,
                                        np.zeros(frames, np.int32), cfg)
    wall = time.time() - t0
    if stats["n_registered"] < 0.9 * frames:
        raise RuntimeError(
            f"map build degraded: {stats['n_registered']}/{frames}")
    return frames / wall, stats


def main():
    import jax

    from sfmx.utils.cache import enable_compile_cache

    enable_compile_cache()
    # correctness gate first: garbage poses must fail the bench, not pass it
    accuracy_tripwire()
    value, compile_s = query_frames_per_s()
    base = cpu_baseline_frames_per_s()
    vs = value / base if base else None

    extras = {}
    tflops, gbps = measure_peaks()
    extras["peak_bf16_tflops"] = round(tflops, 1)
    extras["hbm_gbps"] = round(gbps, 1)
    pps, mfu = matching_throughput(tflops)
    extras["matching_pairs_per_s"] = round(pps, 1)
    extras["matching_mfu"] = round(mfu, 3)
    bpps, bmfu = matching_throughput_band(tflops)
    extras["matching_band_pairs_per_s"] = round(bpps, 1)
    extras["matching_band_mfu"] = round(bmfu, 3)
    ips, frac = ba_throughput(gbps)
    extras["ba_lm_iters_per_s"] = round(ips, 2)
    extras["ba_hbm_roofline_frac"] = round(frac, 3)
    extras["streaming_localize_fps"] = round(streaming_localize_fps(), 1)
    extras["tracking_fps"] = round(tracking_fps(), 1)
    extras["geometric_verify_pairs_per_s"] = round(
        geometric_verify_pairs_per_s(), 1)
    extras["extract_fps"] = round(extract_stream_fps(), 1)
    extras["serving_p95_ms"] = round(serving_p95_ms(), 1)
    build_fps, _ = map_build_fps()
    extras["map_build_fps"] = round(build_fps, 2)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "query_localization_throughput",
        "value": round(value, 2),
        "unit": "frames/s/device",
        "vs_baseline": round(vs, 2) if vs else None,
        "compile_s": round(compile_s, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **extras,
    }))
    print(f"# compile {compile_s:.1f}s; cpu baseline {base and round(base,2)} frames/s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
