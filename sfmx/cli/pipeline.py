"""Batch pipeline driver (C13): ingest → extract → match → reconstruct → map.

Capability parity: the reference's end-to-end map-building scripts
(SURVEY §3.1) with content-addressed stage caching for idempotent re-runs
(§5.3 failure recovery: any stage can be killed and re-run; finished stages
are skipped via input-hash keys).
"""
from __future__ import annotations

import hashlib
import json
import pickle
from pathlib import Path

import numpy as np

from ..utils.logging import LOGGER
from .config import PipelineConfig


def _stage_key(name: str, *parts) -> str:
    h = hashlib.sha256()
    h.update(name.encode())
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:24]


class StageCache:
    """Content-addressed stage outputs on disk (idempotent pipeline re-runs)."""

    def __init__(self, workdir: str | Path | None):
        self.dir = Path(workdir) / "stages" if workdir else None
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)

    def get_or_run(self, name: str, key: str, fn):
        if self.dir:
            p = self.dir / f"{name}-{key}.pkl"
            if p.exists():
                LOGGER.log(name, cached=True, key=key)
                with open(p, "rb") as f:
                    return _cache_decode(pickle.load(f))
        out = fn()
        if self.dir:
            with open(p, "wb") as f:
                pickle.dump(_cache_encode(out), f)
        return out


def _cache_encode(out):
    """Sparse-pack MatchResult stage outputs before pickling: the dense
    (Np, K) idx/valid/score arrays are ~1-3% valid after the ratio test
    and cross-check, and the dense pickle measured 3.0 GB per stage at a
    5,000-frame build (config-4) — ~45 GB at config-5's 20k images.  Only
    the accepted entries survive a (row, col, idx, score) COO encoding."""
    from ..kernels.matching import MatchResult

    if isinstance(out, MatchResult):
        valid = np.asarray(out.valid)
        r, c = np.nonzero(valid)
        return {"__match_coo__": True, "shape": valid.shape,
                "row": r.astype(np.int32), "col": c.astype(np.int32),
                "idx": np.asarray(out.idx)[r, c],
                "score": np.asarray(out.score)[r, c]}
    # PLAIN tuples only: other NamedTuple stage outputs (Features, ...)
    # must survive as their own types
    if type(out) is tuple and any(isinstance(o, MatchResult) for o in out):
        return tuple(_cache_encode(o) for o in out)
    return out


def _cache_decode(out):
    from ..kernels.matching import MatchResult

    if isinstance(out, dict) and out.get("__match_coo__"):
        import jax.numpy as jnp

        idx = np.zeros(out["shape"], np.int32)
        valid = np.zeros(out["shape"], bool)
        score = np.full(out["shape"], -1e30, np.float32)
        idx[out["row"], out["col"]] = out["idx"]
        valid[out["row"], out["col"]] = True
        score[out["row"], out["col"]] = out["score"]
        return MatchResult(idx=jnp.asarray(idx), valid=jnp.asarray(valid),
                           score=jnp.asarray(score))
    if type(out) is tuple:
        return tuple(_cache_decode(o) for o in out)
    return out


def build_pairs(n_images: int, mode: str, window: int) -> np.ndarray:
    if mode == "exhaustive":
        return np.array([(a, b) for a in range(n_images) for b in range(a + 1, n_images)],
                        np.int32).reshape(-1, 2)
    if mode == "window":
        return np.array([(a, b) for a in range(n_images)
                         for b in range(a + 1, min(a + 1 + window, n_images))],
                        np.int32).reshape(-1, 2)
    raise ValueError(f"unknown pair mode {mode}")


def build_pairs_retrieval(feats, n_images: int, *, k: int = 8, window: int = 8,
                          seed: int = 0, n_words: int = 64) -> np.ndarray:
    """Retrieval-limited pair selection (SURVEY C3): VLAD global descriptors
    propose the top-k most-similar frames per image, unioned with a temporal
    window.  O(N·k) pairs instead of O(N²), and — unlike a pure window —
    loop-closure pairs between revisits of the same place are proposed.
    """
    import jax
    import jax.numpy as jnp

    from ..localize import retrieve

    desc, mask = feats.desc, feats.kp.mask               # (C,K,D), (C,K)
    flat = jnp.reshape(desc, (-1, desc.shape[-1]))
    fmask = jnp.reshape(mask, (-1,))
    stride = max(1, flat.shape[0] // 32768)              # bound vocab build cost
    vocab = retrieve.build_vocabulary(
        flat[::stride], fmask[::stride], jax.random.PRNGKey(seed),
        n_words=n_words)
    g = retrieve.vlad_encode_b(desc, mask, vocab)        # (C, V*D)
    S = np.array(g @ g.T)  # copy: jax buffers are read-only
    np.fill_diagonal(S, -np.inf)
    pairs = set()
    kk = min(k, n_images - 1)
    for a in range(n_images):
        for b in range(a + 1, min(a + 1 + window, n_images)):
            pairs.add((a, b))
        for b in np.argpartition(-S[a], kk - 1)[:kk] if kk > 0 else ():
            b = int(b)
            pairs.add((min(a, b), max(a, b)))
    return np.array(sorted(pairs), np.int32).reshape(-1, 2)


def verify_matches(feats, pairs: np.ndarray, res, intrinsics, cam_k,
                   cfg: PipelineConfig, *, seed: int = 0, chunk: int = 256):
    """E-RANSAC geometric filter over all matched pairs (SURVEY C3, §3.1
    hot loop 2 — the reference always filters matches before track building).

    Batched over pair chunks of static size (one compiled executable); returns
    a MatchResult whose ``valid`` keeps only geometric inliers of pairs with
    at least ``gv_min_inliers`` of them.
    """
    import jax
    import jax.numpy as jnp

    from ..core import cameras
    from ..kernels import matching

    intr = np.asarray(intrinsics, np.float32)[np.asarray(cam_k)]  # (C,7)
    xn = jax.vmap(cameras.pixel_to_normalized)(jnp.asarray(intr), feats.kp.uv)
    f_mean = float(np.mean(intr[:, :2]))
    thr = (cfg.match.gv_px_thresh / f_mean) ** 2

    # xn/kp_mask ride as ARGUMENTS, not closure captures: a captured jnp
    # array embeds as an HLO constant — megabytes of constants at
    # thousand-frame scale, ballooning every cold compile
    @jax.jit
    def verify(key, xn_a, kmask_a, p, m):
        return matching.geometric_verify_pairs(
            key, xn_a, kmask_a, p, m,
            threshold=thr, k_hypotheses=cfg.match.gv_hypotheses)

    kp_mask = feats.kp.mask
    idx = np.asarray(res.idx)
    valid = np.asarray(res.valid)
    n_pairs = len(pairs)
    inl_parts, cnt_parts = [], []
    for s in range(0, n_pairs, chunk):
        e = min(s + chunk, n_pairs)
        pad = chunk - (e - s)
        p = jnp.asarray(np.pad(pairs[s:e], ((0, pad), (0, 0))))
        m = matching.MatchResult(
            idx=jnp.asarray(np.pad(idx[s:e], ((0, pad), (0, 0)))),
            valid=jnp.asarray(np.pad(valid[s:e], ((0, pad), (0, 0)))),
            score=None,
        )
        inl, cnt = verify(jax.random.PRNGKey(seed + s), xn, kp_mask, p, m)
        inl_parts.append(np.asarray(inl)[:e - s])
        cnt_parts.append(np.asarray(cnt)[:e - s])
    inliers = np.concatenate(inl_parts)
    cnt = np.concatenate(cnt_parts)
    new_valid = valid & inliers & (cnt >= cfg.match.gv_min_inliers)[:, None]
    return matching.MatchResult(
        idx=res.idx, valid=jnp.asarray(new_valid), score=res.score), cnt


def _extract_raw(images: np.ndarray, cfg: PipelineConfig):
    """Extractor dispatch without any host sync (safe inside async pipelines)."""
    import jax.numpy as jnp

    from ..kernels import features

    if cfg.features.extractor == "sift":
        from ..kernels import sift

        thr = cfg.features.threshold
        return sift.detect_and_describe_sift(
            jnp.asarray(images, jnp.float32),
            max_keypoints=cfg.features.max_keypoints,
            # the AKAZE det-Hessian default is meaningless for |DoG|
            threshold=(0.015 if thr < 1e-4 else thr),
            oriented=cfg.features.oriented,
            n_octaves=cfg.features.n_octaves,
        )
    sscfg = features.ScaleSpaceConfig(
        sigma_levels=tuple(cfg.features.sigma_levels))
    return features.detect_and_describe(
        jnp.asarray(images, jnp.float32), sscfg,
        max_keypoints=cfg.features.max_keypoints,
        threshold=cfg.features.threshold,
        oriented=cfg.features.oriented,
        n_octaves=cfg.features.n_octaves,
    )


def extract_features(images: np.ndarray, cfg: PipelineConfig):
    """Extractor-selectable (C2 parity: reference offers SIFT or AKAZE)."""
    with LOGGER.scope("extract", n_images=len(images),
                      extractor=cfg.features.extractor) as out:
        feats = _extract_raw(images, cfg)
        out["keypoints"] = int(np.asarray(feats.kp.mask).sum())
    return feats


_CONCAT2 = None


def _concat2(a, b):
    """Jitted two-operand pytree concat (lazy singleton: jax import cost)."""
    global _CONCAT2
    if _CONCAT2 is None:
        import jax
        import jax.numpy as jnp

        _CONCAT2 = jax.jit(lambda a, b: jax.tree.map(
            lambda x, y: jnp.concatenate([x, y]), a, b))
    return _CONCAT2(a, b)


def extract_features_streaming(paths, cfg: PipelineConfig, *,
                               chunk: int = 16, workers: int = 8,
                               resize_to=(640, 480)):
    """Pipelined C1→C2: host threads decode chunk i+1 while the device
    extracts chunk i (SURVEY §7.4 host↔device overlap).

    One jitted executable serves every chunk (the last chunk is zero-padded
    to ``chunk``), and nothing blocks until the final concatenation, so JAX
    async dispatch overlaps decode, H2D transfer, and extraction.  Memory on
    host stays O(chunk); per-chunk features accumulate on device.
    Returns ``(feats, orig_sizes)`` identical (minus padding) to decoding
    everything up front and calling :func:`extract_features`.
    """
    import jax
    import jax.numpy as jnp

    from . import ingest

    import time as _time

    outs, sizes, total = [], [], 0
    with LOGGER.scope("extract_stream", chunk=chunk,
                      extractor=cfg.features.extractor) as log:
        t_loop = _time.time()
        for imgs, orig in ingest.iter_decoded_chunks(
                paths, resize_to=resize_to, chunk=chunk, workers=workers):
            b = imgs.shape[0]
            if b < chunk:  # pad the tail chunk to reuse the compiled executable
                imgs = np.concatenate(
                    [imgs, np.zeros((chunk - b, *imgs.shape[1:]), imgs.dtype)])
            # _extract_raw, not extract_features: the latter's keypoint-count
            # log forces a per-chunk host sync, serializing decode vs device
            outs.append(_extract_raw(imgs, cfg))
            sizes.append(orig)
            total += b
        log["loop_s"] = round(_time.time() - t_loop, 2)
        if not outs:
            raise ValueError(
                "extract_features_streaming: no images decoded (empty or "
                "unreadable path list)")
        t_cat = _time.time()
        # Assemble device-side via a BINARY tree of 2-operand jitted
        # concats: a flat N-ary eager concatenate is a fresh XLA program
        # per chunk count and is never disk-cached (eager-op executables
        # are in-process only).  The tree needs log2(N) distinct
        # two-operand programs, shared by every dataset size (chunk count
        # pow2-padded) and persistent-cacheable like any jit.
        n_pad = (1 << max(0, (len(outs) - 1).bit_length())) - len(outs)
        if n_pad:
            zero = jax.tree.map(jnp.zeros_like, outs[0])
            outs.extend([zero] * n_pad)
        while len(outs) > 1:
            outs = [_concat2(outs[i], outs[i + 1])
                    for i in range(0, len(outs), 2)]
        feats = jax.tree.map(lambda x: x[:total], outs[0])
        log["n_images"] = total
        log["keypoints"] = int(np.asarray(feats.kp.mask).sum())
        # loop_s ~ decode + async dispatch; concat_s ~ drain + tree concat
        log["concat_s"] = round(_time.time() - t_cat, 2)
    return feats, np.concatenate(sizes)


def match_images(feats, pairs: np.ndarray, cfg: PipelineConfig):
    import jax.numpy as jnp

    from ..kernels import matching

    with LOGGER.scope("match", n_pairs=len(pairs),
                      binary=cfg.match.binary) as out:
        if cfg.match.binary:
            # the reference's primary AKAZE path: Hamming on M-LDB bits
            res = matching.match_pairs_hamming(
                feats.desc_bits, feats.kp.mask, jnp.asarray(pairs),
                ratio=cfg.match.ratio, cross_check=cfg.match.cross_check,
            )
        else:
            res = matching.match_pairs_float_auto(
                feats.desc, feats.kp.mask, jnp.asarray(pairs),
                ratio=cfg.match.ratio, cross_check=cfg.match.cross_check,
            )
        out["matches"] = int(np.asarray(res.valid).sum())
    return res


def build_map(images: np.ndarray | None, intrinsics: np.ndarray, cam_k: np.ndarray,
              cfg: PipelineConfig, workdir=None, *, feats=None, stage_seed=""):
    """Full map build; returns (scene, feats, track_table, stats).

    ``images=None`` with precomputed ``feats`` (from
    :func:`extract_features_streaming`) runs the build without ever holding
    the full image set in host memory; ``stage_seed`` then keys the stage
    cache (e.g. a hash of the image paths).
    """
    from ..recon import tracks as tracks_mod
    from ..recon.incremental import reconstruct

    n_images = len(cam_k)
    cache = StageCache(workdir)
    if feats is None:
        feats = cache.get_or_run(
            "extract", _stage_key("extract", images, cfg.features),
            lambda: extract_features(images, cfg),
        )
    key_basis = images if images is not None else stage_seed
    if cfg.match.pair_mode == "retrieval":
        pairs = cache.get_or_run(
            "pairs", _stage_key("pairs", key_basis, cfg.features, cfg.match),
            lambda: build_pairs_retrieval(
                feats, n_images, k=cfg.match.retrieval_k, window=cfg.match.window),
        )
    else:
        pairs = build_pairs(n_images, cfg.match.pair_mode, cfg.match.window)
    res = cache.get_or_run(
        "match", _stage_key("match", key_basis, cfg.features, cfg.match),
        lambda: match_images(feats, pairs, cfg),
    )
    if cfg.match.geometric_verify:
        def _gv():
            with LOGGER.scope("geometric_verify", n_pairs=len(pairs)) as out:
                vres, cnt = verify_matches(feats, pairs, res, intrinsics, cam_k, cfg)
                out["inliers"] = int(np.asarray(vres.valid).sum())
                out["pairs_kept"] = int((cnt >= cfg.match.gv_min_inliers).sum())
            return vres
        res = cache.get_or_run(
            "verify", _stage_key("verify", key_basis, cfg.features, cfg.match), _gv)
    with LOGGER.scope("tracks") as out:
        tt = tracks_mod.build_tracks(
            pairs, np.asarray(res.idx), np.asarray(res.valid),
            n_images, cfg.features.max_keypoints,
        )
        out["tracks"] = tt.n_tracks
    with LOGGER.scope("reconstruct") as out:
        scene, stats = reconstruct(
            np.asarray(feats.kp.uv), np.asarray(feats.kp.mask), tt,
            np.asarray(intrinsics, np.float32), np.asarray(cam_k, np.int32), cfg.recon,
            # direct (geometry-verified) per-pair match counts drive
            # initial-pair selection — chained covisibility drifts
            pair_counts=(pairs, np.asarray(res.valid).sum(axis=1)),
        )
        out.update({k: v for k, v in stats.items() if isinstance(v, (int, float))})
        out["components"] = stats.get("components")
        out["phase_s"] = stats.get("phase_s")
        out["ba_call_s"] = stats.get("ba_call_s")
    return scene, feats, tt, stats
