"""sfmx CLI: build-map | localize | merge | serve | evaluate | bench (L7/C13).

Capability parity: the reference's batch tool scripts + Node server entry
(SURVEY §2.1 C13/C14).  `python -m sfmx.cli.main <cmd> ...`.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def cmd_build_map(args):
    from ..mapstore import save_scene
    from .config import load_config
    from .ingest import load_directory, load_video
    from .pipeline import build_map

    cfg = load_config(args.config, args.override or [])
    if args.stream and args.video:
        raise SystemExit("--stream is directory-only; it cannot be combined "
                         "with --video (frame extraction already streams)")
    if args.chunk != 16 and not args.stream:
        print("warning: --chunk has no effect without --stream", file=sys.stderr)
    if args.stream:
        # pipelined decode‖extract; never holds the full image set in host RAM
        import os

        from .ingest import default_intrinsics, exif_focal_px, list_images
        from .pipeline import extract_features_streaming

        paths = [str(p) for p in list_images(args.images)]
        feats, _ = extract_features_streaming(
            paths, cfg, chunk=args.chunk, resize_to=cfg.resize_to)
        W, H = cfg.resize_to
        intr = default_intrinsics(W, H, cfg.focal_factor)[None]
        f = exif_focal_px(paths[0], W)  # same focal prior as the eager path
        if f is not None:
            intr[0, 0] = intr[0, 1] = f
        cam_k = np.zeros(len(paths), np.int32)
        # cache key must reflect content, not just paths: same paths with
        # modified files would otherwise pair stale matches with fresh features
        evidence = ";".join(
            f"{p}:{(st := os.stat(p)).st_size}:{st.st_mtime_ns}" for p in paths)
        scene, feats, tt, stats = build_map(
            None, intr, cam_k, cfg, workdir=args.workdir, feats=feats,
            stage_seed=evidence)
        image_paths = paths
    else:
        if args.video:
            ws = load_video(args.images, every_n=args.every_n, resize_to=cfg.resize_to,
                            focal_factor=cfg.focal_factor)
        else:
            ws = load_directory(args.images, resize_to=cfg.resize_to,
                                focal_factor=cfg.focal_factor)
        scene, feats, tt, stats = build_map(ws.images, ws.intrinsics, ws.cam_k, cfg,
                                            workdir=args.workdir)
        image_paths = ws.image_paths
    extra = {"image_paths": image_paths, "stats": {k: v for k, v in stats.items()
                                                   if isinstance(v, (int, float, list))}}
    save_scene(args.output, scene, extra=extra)
    # persist per-feature descriptors + obs_feat for model merging (C12)
    np.savez_compressed(
        args.output + ".feats.npz",
        desc=np.asarray(feats.desc), kp_uv=np.asarray(feats.kp.uv),
        kp_mask=np.asarray(feats.kp.mask), obs_feat=tt.obs_feat,
        desc_bits=np.asarray(feats.desc_bits),
    )
    # aggregate + persist the SERVING map once (landmark descriptors, VLAD
    # vocabulary, keyframe global descriptors, majority-vote bits) so
    # localize/serve start by mmap-loading it — never re-running k-means
    from ..localize import build_localization_map
    from ..mapstore import save_localization_map

    bits = np.asarray(feats.desc_bits)
    lmap = build_localization_map(
        scene, np.asarray(feats.desc), tt.obs_feat,
        kp_mask=np.asarray(feats.kp.mask),
        feat_bits=bits if bits.size else None)
    save_localization_map(args.output + ".lmap", lmap)
    print(json.dumps({"registered": stats["n_registered"], "points": stats["n_points"],
                      "output": args.output}))


def _load_lmap(map_path: str, *, binary: bool = False):
    from ..mapstore import (has_localization_map, load_localization_map,
                            load_scene)

    scene = load_scene(map_path)
    lmap_path = map_path + ".lmap"
    if has_localization_map(lmap_path):
        lmap = load_localization_map(lmap_path)
        if not binary or lmap.lm_bits is not None:
            return scene, lmap
        # binary serving requested but the store predates bits: fall through
    # legacy path: derive the serving map from raw per-feature descriptors
    from ..localize import build_localization_map

    z = np.load(map_path + ".feats.npz")
    bits = z["desc_bits"] if (binary and "desc_bits" in z.files) else None
    lmap = build_localization_map(scene, z["desc"], z["obs_feat"],
                                  kp_mask=z["kp_mask"], feat_bits=bits)
    return scene, lmap


def cmd_localize(args):
    import jax
    import jax.numpy as jnp

    from ..localize import localize_query
    from .config import load_config
    from .ingest import load_directory

    cfg = load_config(args.config, args.override or [])
    scene, lmap = _load_lmap(args.map, binary=cfg.localize.binary)
    if getattr(args, "video", False):
        from .ingest import load_video

        ws = load_video(args.images, every_n=args.every_n,
                        resize_to=cfg.resize_to, focal_factor=cfg.focal_factor)
    else:
        ws = load_directory(args.images, resize_to=cfg.resize_to,
                            focal_factor=cfg.focal_factor)
    from .pipeline import extract_features

    # queries MUST use the same extractor family the map was built with
    feats = extract_features(np.asarray(ws.images, np.float32), cfg)
    binary = cfg.localize.binary and lmap.lm_bits is not None

    if getattr(args, "sequential", False):
        # continuous tracking: each pose's center gates the next frame's
        # retrieval; lost tracks relocalize globally (localize/tracking.py)
        from ..localize.tracking import TrackingConfig, localize_sequence

        lc = cfg.localize
        tcfg = TrackingConfig(
            radius=args.radius, min_inliers=lc.min_inliers,
            top_k_kf=lc.top_k_kf, m_cap=lc.m_cap,
            k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
            sim_thresh=lc.sim_thresh, pnp_solver=lc.pnp_solver)
        seq_res, flags, stats = localize_sequence(
            lmap, feats.desc, feats.kp.uv, feats.kp.mask,
            jnp.asarray(ws.intrinsics[0]), jax.random.PRNGKey(0), tcfg)
        out = [{
            "image": ws.image_paths[i],
            "R": np.asarray(r.R).tolist(), "t": np.asarray(r.t).tolist(),
            "center": np.asarray(r.center).tolist(),
            "n_inliers": int(r.n_inliers), "confidence": float(r.confidence),
            "tracked": bool(flags[i]),
        } for i, r in enumerate(seq_res)]
        print(json.dumps({"stats": stats, "frames": out}, indent=2))
        return

    from ..localize.localize import (localize_batch, localize_batch_streaming,
                                     use_streaming)

    streaming = use_streaming(cfg.localize, lmap, binary)
    # Batched device dispatch (VERDICT r2): fixed-size chunks (pad the last
    # one) so the CLI compiles ONE vmapped program and amortizes dispatch,
    # instead of a per-image loop that syncs every frame.
    n = len(ws.images)
    chunk = min(16, max(1, n))
    intr0 = jnp.asarray(ws.intrinsics[0])
    res_all = []
    for s in range(0, n, chunk):
        idx = np.arange(s, min(s + chunk, n))
        pad = np.concatenate([idx, np.full(chunk - len(idx), idx[-1])])
        d = feats.desc[pad]
        u = feats.kp.uv[pad]
        m = feats.kp.mask[pad]
        key = jax.random.PRNGKey(s)
        if streaming:
            res_b = localize_batch_streaming(
                lmap, d, u, m, intr0, key,
                k_hypotheses=cfg.localize.k_hypotheses,
                px_thresh=cfg.localize.px_thresh, ratio=cfg.match.ratio,
                sim_thresh=cfg.localize.sim_thresh,
                min_inliers=cfg.localize.min_inliers,
                pnp_solver=cfg.localize.pnp_solver,
            )
        else:
            res_b = localize_batch(
                lmap, d, u, m, intr0, key,
                q_bits=feats.desc_bits[pad] if binary else None,
                top_k_kf=cfg.localize.top_k_kf, m_cap=cfg.localize.m_cap,
                k_hypotheses=cfg.localize.k_hypotheses,
                px_thresh=cfg.localize.px_thresh,
                sim_thresh=cfg.localize.sim_thresh,
                min_inliers=cfg.localize.min_inliers,
                ham_thresh=cfg.localize.ham_thresh,
                pnp_solver=cfg.localize.pnp_solver,
            )
        res_all.extend(jax.tree_util.tree_map(lambda x, i=i: x[i], res_b)
                       for i in range(len(idx)))
    results = [{
        "image": ws.image_paths[i],
        "R": np.asarray(res.R).tolist(), "t": np.asarray(res.t).tolist(),
        "center": np.asarray(res.center).tolist(),
        "n_inliers": int(res.n_inliers), "confidence": float(res.confidence),
    } for i, res in enumerate(res_all)]
    print(json.dumps(results, indent=2))


def cmd_merge(args):
    from ..mapstore import load_scene, save_scene
    from ..recon.merge import merge_scenes

    scenes = []
    for p in args.maps:
        scene = load_scene(p)
        z = np.load(p + ".feats.npz")
        scenes.append((scene, z["desc"], z["kp_uv"], z["kp_mask"], z["obs_feat"]))
    merged, stats = merge_scenes(scenes)
    save_scene(args.output, merged, extra={"merge_stats": stats})
    print(json.dumps({"output": args.output, **stats}))


def cmd_serve(args):
    from aiohttp import web

    from ..serve import LocalizationService, make_app
    from .config import load_config

    cfg = load_config(args.config, args.override or [])
    service = LocalizationService(batch_window_ms=args.batch_window_ms,
                                  max_batch=args.max_batch)
    import jax.numpy as jnp
    for spec in args.map:
        map_id, path = spec.split("=", 1) if "=" in spec else (spec, spec)
        scene, lmap = _load_lmap(path, binary=cfg.localize.binary)
        service.load_map(map_id, lmap, jnp.asarray(np.asarray(scene.intr)[0]),
                         cfg=cfg, shards=args.shards)
        if not args.no_warmup:
            # compile every batch bucket BEFORE traffic (persistent-cached)
            service.warmup(map_id)
    app = make_app(service)
    web.run_app(app, port=args.port)


def cmd_georeference(args):
    """Align a map to world coordinates via control points (C11).

    Control file: JSON [[cam_index, wx, wy, wz], ...] — known world positions
    of selected cameras (the reference's floor-plan control points).
    """
    import dataclasses
    import jax.numpy as jnp

    from ..mapstore import load_scene, save_scene
    from ..solvers import umeyama

    scene = load_scene(args.map)
    ctrl = np.asarray(json.loads(open(args.control).read()), np.float64)
    idx = ctrl[:, 0].astype(int)
    world = jnp.asarray(ctrl[:, 1:4], jnp.float32)
    est = scene.centers[idx]
    s_, R_, t_ = umeyama.umeyama(est, world)
    # apply similarity to the whole scene (same transform as merge)
    from ..recon.merge import transform_scene_inplace

    R2, t2, X2 = transform_scene_inplace(
        np.array(scene.cam_R), np.array(scene.cam_t), np.array(scene.X),
        float(s_), np.asarray(R_), np.asarray(t_))
    scene = dataclasses.replace(
        scene, cam_R=jnp.asarray(R2), cam_t=jnp.asarray(t2), X=jnp.asarray(X2))
    out = args.output or args.map
    save_scene(out, scene, extra={"georeferenced": True, "scale": float(s_)})
    resid = np.linalg.norm(np.asarray(scene.centers)[idx] - np.asarray(world), axis=1)
    print(json.dumps({"output": out, "scale": float(s_),
                      "control_rmse": float(np.sqrt((resid ** 2).mean()))}))


def cmd_evaluate(args):
    from ..mapstore import load_scene
    from .evaluate import evaluate_trajectory, print_report, scene_stats

    scene = load_scene(args.map)
    report = {"scene": scene_stats(scene)}
    if args.reference:
        ref = np.loadtxt(args.reference)  # (C,3) centers
        report["trajectory"] = evaluate_trajectory(
            np.asarray(scene.centers), ref, np.asarray(scene.cam_alive))
    print_report(report)


def cmd_export(args):
    from ..mapstore import load_scene
    from .export import export_scene_ply

    scene = load_scene(args.map)
    out = args.output or (str(args.map).rstrip("/") + ".ply")
    print(json.dumps(export_scene_ply(scene, out,
                                      frustum_scale=args.frustum_scale)))


def cmd_bench(args):
    import subprocess

    # bench.py runs in a child process; this parent never touches the
    # device (it imports no JAX backend), so the child owns the card
    sys.exit(subprocess.call([sys.executable, "bench.py"]))


def cmd_bundle(args):
    """Package a deployable artifact: map + serving map + the warm XLA
    compile cache.

    The persistent compile cache is location-independent, so shipping it
    with the map turns a first deploy's compiles into cache hits: extract
    with ``sfmx unbundle`` and set ``JAX_COMPILATION_CACHE_DIR`` to the
    extracted ``jax_cache/``.
    """
    import os
    import tarfile

    from ..utils.cache import cache_dir

    cache = args.cache or cache_dir()
    base = os.path.basename(args.map.rstrip("/"))
    n_map = 0
    with tarfile.open(args.output, "w:gz") as tar:
        for suffix in ("", ".lmap", ".feats.npz"):
            pth = args.map.rstrip("/") + suffix
            if os.path.exists(pth):
                tar.add(pth, arcname="map/" + base + suffix)
                n_map += 1
        if n_map == 0:
            raise SystemExit(f"no map artifacts found at {args.map}")
        n_cache = 0
        if os.path.isdir(cache):
            tar.add(cache, arcname="jax_cache")
            n_cache = len(os.listdir(cache))
        elif not args.no_cache:
            print(f"warning: compile cache {cache} not found; bundle ships "
                  "without it (cold deploys will pay full compiles)",
                  file=sys.stderr)
    print(json.dumps({
        "output": args.output, "map": base, "map_artifacts": n_map,
        "cached_programs": n_cache,
        "size_mb": round(os.path.getsize(args.output) / 1e6, 1)}))


def cmd_unbundle(args):
    import os
    import tarfile

    os.makedirs(args.dest, exist_ok=True)
    with tarfile.open(args.bundle, "r:gz") as tar:
        tar.extractall(args.dest, filter="data")
    maps = sorted(
        p for p in os.listdir(os.path.join(args.dest, "map"))
        if not (p.endswith(".lmap") or p.endswith(".npz")))
    cache = os.path.join(args.dest, "jax_cache")
    print(json.dumps({
        "maps": [os.path.join(args.dest, "map", m) for m in maps],
        "cache": cache if os.path.isdir(cache) else None,
        "env": f"JAX_COMPILATION_CACHE_DIR={cache}"}))


def main(argv=None):
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="sfmx")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-map", help="reconstruct a map from images/video")
    b.add_argument("images")
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--video", action="store_true")
    b.add_argument("--every-n", type=int, default=10)
    b.add_argument("--workdir", default=None, help="stage-cache directory")
    b.add_argument("--stream", action="store_true",
                   help="pipelined decode‖extract (bounded host memory)")
    b.add_argument("--chunk", type=int, default=16, help="streaming chunk size")
    b.add_argument("--config", default=None)
    b.add_argument("--override", "-D", action="append", help="key=value")
    b.set_defaults(fn=cmd_build_map)

    l = sub.add_parser("localize", help="localize query images against a map")
    l.add_argument("map")
    l.add_argument("images", help="image directory, or video file with --video")
    l.add_argument("--video", action="store_true")
    l.add_argument("--every-n", type=int, default=10, help="video frame stride")
    l.add_argument("--sequential", action="store_true",
                   help="continuous tracking: prior-gated retrieval + reloc")
    l.add_argument("--radius", type=float, default=3.0,
                   help="tracking prior radius (map units)")
    l.add_argument("--config", default=None)
    l.add_argument("--override", "-D", action="append")
    l.set_defaults(fn=cmd_localize)

    m = sub.add_parser("merge", help="merge multiple session maps")
    m.add_argument("maps", nargs="+")
    m.add_argument("-o", "--output", required=True)
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("serve", help="HTTP localization server")
    s.add_argument("--map", action="append", required=True, help="id=path")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--batch-window-ms", type=float, default=5.0)
    s.add_argument("--max-batch", type=int, default=32)
    s.add_argument("--shards", type=int, default=1,
                   help="split each map across N devices, route by retrieval")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip compiling batch buckets at startup")
    s.add_argument("--config", default=None)
    s.add_argument("--override", "-D", action="append")
    s.set_defaults(fn=cmd_serve)

    g = sub.add_parser("georeference", help="align map to world control points")
    g.add_argument("map")
    g.add_argument("control", help="JSON [[cam_idx,wx,wy,wz],...]")
    g.add_argument("-o", "--output", default=None)
    g.set_defaults(fn=cmd_georeference)

    e = sub.add_parser("evaluate", help="map stats + trajectory ATE")
    e.add_argument("map")
    e.add_argument("--reference", default=None, help="txt file of (C,3) GT centers")
    e.set_defaults(fn=cmd_evaluate)

    x = sub.add_parser("export", help="export map to PLY (cloud + frusta)")
    x.add_argument("map")
    x.add_argument("-o", "--output", default=None)
    x.add_argument("--frustum-scale", type=float, default=0.15)
    x.set_defaults(fn=cmd_export)

    bn = sub.add_parser("bench", help="run the headline benchmark")
    bn.set_defaults(fn=cmd_bench)

    bd = sub.add_parser("bundle",
                        help="package map + compile cache for cold deploy")
    bd.add_argument("map", help="map path (as given to build-map -o)")
    bd.add_argument("-o", "--output", required=True, help="bundle .tar.gz")
    bd.add_argument("--cache", default=None,
                    help="compile-cache dir (default: JAX_COMPILATION_CACHE_DIR"
                         " or <checkout>/.jax_cache)")
    bd.add_argument("--no-cache", action="store_true",
                    help="silence the missing-cache warning")
    bd.set_defaults(fn=cmd_bundle)

    ub = sub.add_parser("unbundle", help="extract a deploy bundle")
    ub.add_argument("bundle")
    ub.add_argument("-d", "--dest", required=True)
    ub.set_defaults(fn=cmd_unbundle)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
