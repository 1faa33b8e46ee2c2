"""Proof that sfmx runs on the GPU: map build, serving, full-pool
localization and global BA, each checked against a plain reference.

    python chip_smoke.py              # one GPU, four phases
    python chip_smoke.py --chips 4    # the multi-device paths on four GPUs

Default phases (one card), at the config-2 harness settings of
``bench/run_configs.py``:

1. build — 256 rendered frames of the room walk (320x240, f=280, K=512,
   retrieval pairs) through ``sfmx.cli.pipeline.build_map``; gates on the
   registered share and the ATE, and compares the production pair matcher
   with the plain ``match_pairs_float`` on the build's real pairs;
2. serve_gather — 16 concurrent image requests at held-out poses through
   ``LocalizationService`` (server-side extraction, gather localization);
3. serve_streaming — the same map padded with distractor landmarks to
   100,352, so ``load_map`` selects full-pool streaming; the same 16
   queries; the top-2 kernel against the dense reference on that batch;
4. ba — config-3 global BA (512 cameras, 20k points, 200k observations),
   10 LM iterations of the planes formulation against the einsum one.

``--chips 4`` runs only the multi-device paths, each against its one-device
answer: ``serve --shards 4`` (``MapShardRouter``), ``localize_batch_sharded``
on a four-GPU mesh, and block BA (``dist.block_ba``).

One process drives every card.  Prints the card (``nvidia-smi``), one JSON
line per phase, and last the device line.  Exits non-zero, without the
device line, when JAX finds no GPU or any gate fails.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TRITON_CALL = "__gpu$xla.gpu.triton"
POOL_SIZE = 100_352          # full-pool streaming map size (bench.py)
N_QUERIES = 16


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def memory_of(jitted, *args) -> dict:
    """``compiled.memory_analysis()`` of one program, in bytes."""
    ma = jitted.lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, f"{k}_size_in_bytes"))
            for k in ("temp", "argument", "output", "generated_code")}


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(name: str, gates: dict, t0: float, **extra) -> bool:
    """Print one phase line; a phase passes when every boolean gate holds."""
    ok = all(v for v in gates.values() if isinstance(v, bool))
    print(json.dumps({"phase": name, "ok": ok, "gates": gates,
                      "wall_s": round(time.time() - t0, 2),
                      "peak_bytes_in_use": peak_bytes(), **extra},
                     default=float), flush=True)
    return ok


# ---------------------------------------------------------------------------
# Scene: the config-2 harness build
# ---------------------------------------------------------------------------

def render_walk(frames: int, seed: int = 7, width: int = 320,
                height: int = 240, focal: float = 280.0):
    from examples.room import RoomTexture, render_room, walk_poses

    tex = RoomTexture(seed=seed)
    poses = walk_poses(frames)
    imgs = np.stack([render_room(tex, R, eye, width, height, focal)
                     for (R, _, eye) in poses])
    return tex, poses, imgs


def harness_config(frames: int, width: int = 320, height: int = 240,
                   focal: float = 280.0, max_keypoints: int = 512):
    from sfmx.cli.config import (FeatureConfig, MatchConfig, PipelineConfig)
    from sfmx.recon.incremental import ReconConfig

    return PipelineConfig(
        features=FeatureConfig(max_keypoints=max_keypoints),
        match=MatchConfig(pair_mode="retrieval", retrieval_k=6,
                          window=max(6, frames // 8)),
        recon=ReconConfig(final_ba_iters=25),
        resize_to=(width, height), focal_factor=focal / width)


def phase_build(frames: int = 256, *, width: int = 320, height: int = 240,
                focal: float = 280.0, max_keypoints: int = 512,
                pair_chunk: int = 1024):
    """Phase 1.  Returns (ok, scene context for the serving phases)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sfmx.cli.pipeline import build_map, build_pairs_retrieval
    from sfmx.kernels import matching
    from sfmx.localize import build_localization_map
    from sfmx.solvers import umeyama

    t0 = time.time()
    tex, poses, imgs = render_walk(frames, width=width, height=height,
                                   focal=focal)
    cfg = harness_config(frames, width, height, focal, max_keypoints)
    intr = np.array([[focal, focal, width / 2, height / 2, 0, 0, 0]],
                    np.float32)
    t_build = time.time()
    scene, feats, tt, stats = build_map(imgs, intr,
                                        np.zeros(frames, np.int32), cfg)
    build_s = time.time() - t_build
    gt = np.stack([eye for (_, _, eye) in poses]).astype(np.float32)
    ate, sim3 = umeyama.ate_rmse(scene.centers, jnp.asarray(gt),
                                 scene.cam_alive)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    n_reg = int(np.asarray(scene.cam_alive).sum())

    # the production pair matcher against the plain one, on the real pairs
    pairs = jnp.asarray(build_pairs_retrieval(
        feats, frames, k=cfg.match.retrieval_k, window=cfg.match.window))
    mkw = dict(ratio=cfg.match.ratio, cross_check=cfg.match.cross_check)
    auto = jax.jit(partial(matching.match_pairs_float_auto, **mkw))
    got = auto(feats.desc, feats.kp.mask, pairs)
    ref_valid, ref_idx = [], []
    for s in range(0, pairs.shape[0], pair_chunk):
        r = matching.match_pairs_float(feats.desc, feats.kp.mask,
                                       pairs[s:s + pair_chunk], **mkw)
        ref_valid.append(np.asarray(r.valid))
        ref_idx.append(np.asarray(r.idx))
    rv, ri = np.concatenate(ref_valid), np.concatenate(ref_idx)
    gv, gi = np.asarray(got.valid), np.asarray(got.idx)
    both = rv & gv
    quarter = pairs[: max(1, pairs.shape[0] // 4)]
    gates = {
        "registered": n_reg, "frames": frames,
        "registered_ge_95pct": n_reg >= int(0.95 * frames),
        "ate_m": float(ate), "ate_gate_m": max(0.1, 0.015 * path_len),
        "ate_ok": float(ate) < max(0.1, 0.015 * path_len),
        "pairs": int(pairs.shape[0]),
        "match_valid_agree": float((rv == gv).mean()),
        "match_valid_agree_ge_99_5pct": float((rv == gv).mean()) >= 0.995,
        "match_idx_equal_where_both_valid": bool(np.array_equal(gi[both],
                                                                 ri[both])),
    }
    ok = report("build", gates, t0, build_map_s=round(build_s, 2),
                stage_s={k: stats.get(k) for k in ("phase_s",)},
                memory_analysis={
                    "pair_matcher_all_pairs": memory_of(
                        auto, feats.desc, feats.kp.mask, pairs),
                    "pair_matcher_quarter_pairs": memory_of(
                        auto, feats.desc, feats.kp.mask, quarter),
                    "dense_similarity_bytes_all_pairs":
                        int(pairs.shape[0]) * max_keypoints ** 2 * 4})
    lmap = build_localization_map(scene, np.asarray(feats.desc), tt.obs_feat,
                                  kp_mask=np.asarray(feats.kp.mask))
    ctx = dict(tex=tex, poses=poses, cfg=cfg, intr=intr, lmap=lmap,
               sim3=sim3, width=width, height=height, focal=focal)
    return ok, ctx


def held_out_queries(ctx, n: int = N_QUERIES, seed: int = 11):
    """Held-out poses near the walk (the config-2 harness rule)."""
    from examples.room import look_at, render_room

    poses = ctx["poses"]
    rng = np.random.default_rng(seed)
    imgs, eyes = [], []
    for qi in np.linspace(2, len(poses) - 3, n).astype(int):
        Rq, _, eye = poses[qi]
        eye2 = eye + rng.uniform(-0.05, 0.05, 3)
        Rq2, _ = look_at(eye2, eye2 + 5.0 * Rq[2])
        imgs.append(render_room(ctx["tex"], Rq2, eye2, ctx["width"],
                                ctx["height"], ctx["focal"]))
        eyes.append(eye2)
    return np.stack(imgs).astype(np.float32), np.stack(eyes)


def serve_queries(svc, map_id: str, imgs) -> list[dict]:
    async def run():
        await svc.start()
        try:
            return await asyncio.gather(*[svc.localize(map_id, image=im)
                                          for im in imgs])
        finally:
            await svc.stop()

    return asyncio.run(run())


def score_answers(ctx, outs, eyes) -> dict:
    """Centre error in world units (via the build's ATE alignment)."""
    import jax.numpy as jnp

    from sfmx.solvers import umeyama

    s, R, t = ctx["sim3"]
    cen = np.stack([o["center"] for o in outs]).astype(np.float32)
    world = np.asarray(umeyama.apply_sim3(s, R, t, jnp.asarray(cen)))
    err = np.linalg.norm(world - eyes, axis=1)
    inl = np.asarray([o["n_inliers"] for o in outs])
    good = (err < 0.2) & (inl >= 12)
    return {"centers": cen, "err_m": err, "good": good}


def padded_map(lmap, pool_size: int, seed: int = 3):
    """The built map plus random-descriptor distractor landmarks."""
    import jax.numpy as jnp

    n = pool_size - lmap.X.shape[0]
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, lmap.lm_desc.shape[1])).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    X = rng.uniform([-5, -2.5, -5], [5, 2.5, 5], (n, 3)).astype(np.float32)
    return lmap._replace(
        X=jnp.concatenate([lmap.X, jnp.asarray(X)]),
        lm_desc=jnp.concatenate([lmap.lm_desc, jnp.asarray(d)]),
        lm_alive=jnp.concatenate([lmap.lm_alive, jnp.ones(n, bool)]))


def phase_serve(ctx, name: str, lmap, *, min_good: int, streaming: bool,
                shards: int = 1, warmup: bool = True):
    """Phases 2 and 3: ``min_good`` of the held-out image queries must land
    within 0.2 m with at least 12 inliers."""
    import jax.numpy as jnp

    from sfmx.localize.localize import use_streaming
    from sfmx.serve import LocalizationService

    t0 = time.time()
    if "queries" not in ctx:
        ctx["queries"] = held_out_queries(ctx, ctx.get("n_queries", N_QUERIES))
    imgs, eyes = ctx["queries"]
    svc = LocalizationService(max_batch=ctx.get("max_batch", 16))
    svc.load_map(name, lmap, jnp.asarray(ctx["intr"][0]), cfg=ctx["cfg"],
                 shards=shards)
    if warmup:
        svc.warmup(name)
    t_q = time.time()
    outs = serve_queries(svc, name, imgs)
    sc = score_answers(ctx, outs, eyes)
    gates = {
        "queries": len(imgs), "good": int(sc["good"].sum()),
        "min_good": min_good, "good_ok": int(sc["good"].sum()) >= min_good,
        "err_m": [round(float(e), 4) for e in sc["err_m"]],
    }
    if shards == 1:
        # load_map's own choice: the padded map must select streaming
        gates["streaming_as_expected"] = (
            use_streaming(ctx["cfg"].localize, lmap, False) == streaming)
    return gates, sc, t0, round(time.time() - t_q, 3)


def phase_serve_gather(ctx, min_good: int = 14):
    gates, sc, t0, q_s = phase_serve(ctx, "room", ctx["lmap"],
                                     min_good=min_good, streaming=False)
    return report("serve_gather", gates, t0, burst_s=q_s), sc


def streaming_check(ctx, lmap, *, require_kernel: bool):
    """The kept top-2 against the dense reference on this batch's queries,
    and the Triton call in the lowered serving program."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sfmx.cli.pipeline import extract_features
    from sfmx.kernels import top2
    from sfmx.localize.localize import localize_batch_streaming

    imgs, _ = ctx["queries"]
    f = extract_features(imgs, ctx["cfg"])
    q = f.desc.reshape(-1, f.desc.shape[-1])
    k1, ki, k2 = top2.top2(q, lmap.lm_desc, lmap.lm_alive)
    r1, ri, r2 = top2.top2_reference(q, lmap.lm_desc, lmap.lm_alive)
    k1, ki, k2, r1, ri, r2 = map(np.asarray, (k1, ki, k2, r1, ri, r2))
    clear = (r1 - r2) > 4e-3
    lc = ctx["cfg"].localize
    serve = jax.jit(partial(localize_batch_streaming,
                            k_hypotheses=lc.k_hypotheses,
                            px_thresh=lc.px_thresh,
                            sim_thresh=lc.sim_thresh,
                            min_inliers=lc.min_inliers))
    B = imgs.shape[0]
    args = (lmap, f.desc, f.kp.uv, f.kp.mask,
            jnp.broadcast_to(jnp.asarray(ctx["intr"][0]), (B, 7)),
            jax.random.PRNGKey(0))
    text = serve.lower(*args).as_text()
    gates = {
        "rows": int(q.shape[0]), "pool": int(lmap.X.shape[0]),
        "max_abs_ds1": float(np.abs(k1 - r1).max()),
        "max_abs_ds2": float(np.abs(k2 - r2).max()),
        "scores_within_2e-3": bool(np.abs(k1 - r1).max() <= 2e-3
                                   and np.abs(k2 - r2).max() <= 2e-3),
        "clear_rows": int(clear.sum()),
        "i1_equal_where_margin_gt_4e-3": bool(np.array_equal(ki[clear],
                                                             ri[clear])),
        "triton_call_in_serving_program": TRITON_CALL in text,
    }
    if not require_kernel:
        gates["triton_call_in_serving_program"] = int(TRITON_CALL in text)
    mem = {"serving_program": memory_of(serve, *args),
           "dense_similarity_bytes": int(q.shape[0]) * int(lmap.X.shape[0]) * 4}
    return gates, mem


def phase_serve_streaming(ctx, min_good: int = 14, pool_size: int = POOL_SIZE,
                          *, require_kernel: bool = True):
    lmap = padded_map(ctx["lmap"], pool_size)
    ctx["padded"] = lmap
    gates, sc, t0, q_s = phase_serve(ctx, "room_full", lmap,
                                     min_good=min_good, streaming=True)
    kgates, mem = streaming_check(ctx, lmap, require_kernel=require_kernel)
    gates.update(kgates)
    return report("serve_streaming", gates, t0, burst_s=q_s,
                  memory_analysis=mem), sc


# ---------------------------------------------------------------------------
# Global BA at config-3 scale (bench.py's problem)
# ---------------------------------------------------------------------------

def ba_problem(C: int = 512, P: int = 20_000, O: int = 200_000, seed: int = 0):
    """Camera-local (sliding-window) visibility, exact start, 0.5 px noise."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-5, 5, (C, 2)),
                        np.full((C, 1), 20.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    pt_id = np.sort(rng.integers(0, P, O).astype(np.int32))
    span = min(24, C)
    base = (pt_id.astype(np.float64) / P * (C - span)).astype(np.int32)
    cam_id = (base + rng.integers(0, span, O)).astype(np.int32)
    Xc = X[pt_id] + t[cam_id]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.asarray([320.0, 240.0])
          + 0.5 * rng.standard_normal((O, 2))).astype(np.float32)
    intr = np.asarray([[500.0, 500.0, 320.0, 240.0, 0, 0, 0]], np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    args = (jnp.asarray(intr), jnp.zeros(C, jnp.int32), jnp.asarray(R),
            jnp.asarray(t), jnp.asarray(X), jnp.asarray(cam_id),
            jnp.asarray(pt_id), jnp.asarray(uv), jnp.ones(O, jnp.float32),
            jnp.asarray(fixed))
    caps = dict(
        tp_cap=1 << max(3, (int(np.bincount(pt_id).max()) - 1).bit_length()),
        tc_cap=1 << max(3, (int(np.bincount(cam_id).max()) - 1).bit_length()))
    return args, caps


def phase_ba(C: int = 512, P: int = 20_000, O: int = 200_000,
             iters: int = 10):
    """Phase 4: planes formulation against the einsum one, same inputs."""
    import jax
    from functools import partial

    from sfmx.solvers import lm

    t0 = time.time()
    args, caps = ba_problem(C, P, O)
    planes = jax.jit(partial(lm.ba_solve, iters=iters, cg_iters=30, **caps))
    einsum = jax.jit(partial(lm.ba_solve, iters=iters, cg_iters=30))
    cp = np.asarray(jax.block_until_ready(planes(*args))[3])
    ce = np.asarray(jax.block_until_ready(einsum(*args))[3])
    rel = abs(float(cp[-1]) - float(ce[-1])) / max(abs(float(ce[-1])), 1e-30)
    gates = {
        "cams": C, "points": P, "obs": O, "iters": iters,
        "cost0": float(cp[0]), "cost_planes": float(cp[-1]),
        "cost_einsum": float(ce[-1]), "rel_diff": rel,
        "rel_diff_le_1e-3": rel <= 1e-3,
        "cost_falls": bool(cp[-1] < cp[0] and ce[-1] < ce[0]),
        "finite": bool(np.isfinite(cp).all() and np.isfinite(ce).all()),
    }
    return report("ba", gates, t0, memory_analysis={
        "planes": memory_of(planes, *args), "einsum": memory_of(einsum, *args)})


# ---------------------------------------------------------------------------
# Four devices
# ---------------------------------------------------------------------------

def phase_router(ctx, single, min_good: int = 14):
    """``serve --shards 4`` (MapShardRouter) on the padded map against the
    one-device streaming answers ``single``."""
    # no warmup: the router compiles per shard and bucket, and only the
    # buckets this burst uses are worth compiling here
    gates, sc, t0, q_s = phase_serve(ctx, "room_shards", ctx["padded"],
                                     min_good=min_good, streaming=False,
                                     shards=4, warmup=False)
    both = sc["good"] & single["good"]
    d = np.linalg.norm(sc["centers"] - single["centers"], axis=1)
    gates.update({
        "both_good": int(both.sum()),
        "max_center_diff_vs_single_m": float(d[both].max()) if both.any()
        else None,
        "centers_agree_within_0.1m": bool((d[both] < 0.1).all()),
    })
    return report("serve_shards4", gates, t0, burst_s=q_s)


def phase_sharded_localize(ctx):
    """``localize_batch_sharded`` on a four-device mesh against one-device
    streaming top-2: the same winners except at ties."""
    import jax
    import jax.numpy as jnp

    from sfmx.cli.pipeline import extract_features
    from sfmx.dist import mesh as meshlib
    from sfmx.kernels import top2
    from sfmx.localize import localize_batch_streaming, shard_localization_map
    from sfmx.localize.sharded import AXIS, _localize_sharded_jit

    t0 = time.time()
    lmap = ctx["padded"]
    mesh = meshlib.make_mesh(AXIS)
    slmap = shard_localization_map(lmap, mesh)
    imgs, _ = ctx["queries"]
    f = extract_features(imgs, ctx["cfg"])
    B, K, D = f.desc.shape
    intr_b = jnp.broadcast_to(jnp.asarray(ctx["intr"][0]), (B, 7))
    key = jax.random.PRNGKey(0)
    kw = dict(k_hypotheses=1024, px_thresh=4.0, ratio=0.85, sim_thresh=0.75,
              min_inliers=12)
    res_s, idx_s = _localize_sharded_jit(slmap, f.desc, f.kp.uv, f.kp.mask,
                                         intr_b, key, mesh=mesh, **kw)
    s1, i1, s2 = map(np.asarray, top2.top2(f.desc.reshape(B * K, D),
                                           lmap.lm_desc, lmap.lm_alive))
    res_1 = localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask,
                                     intr_b, key, **kw)
    untied = s1 > s2
    idx_s = np.asarray(idx_s).reshape(-1)
    dc = np.abs(np.asarray(res_s.center) - np.asarray(res_1.center)).max()
    gates = {
        "devices": int(mesh.devices.size), "rows": int(B * K),
        "untied_rows": int(untied.sum()),
        "idx_equal_except_ties": bool(np.array_equal(idx_s[untied],
                                                     i1[untied])),
        "max_center_diff_vs_single": float(dc),
    }
    return report("localize_sharded4", gates, t0)


def phase_block_ba(C: int = 512, P: int = 20_000, O: int = 200_000,
                   iters: int = 10):
    """Block BA over every device against one-device ``ba_solve`` on the
    config-3 problem, at ``tests/test_block_ba.py``'s tolerance."""
    import jax

    from sfmx.dist import block_ba, mesh as meshlib
    from sfmx.solvers import lm

    t0 = time.time()
    args, _ = ba_problem(C, P, O)
    np_args = [np.asarray(a) for a in args]
    mesh = meshlib.make_mesh(block_ba.AXIS)
    _, _, _, cb, stats = block_ba.ba_solve_blocked(
        *np_args, mesh, iters=iters, cg_iters=30)
    cr = np.asarray(jax.block_until_ready(
        lm.ba_solve(*args, iters=iters, cg_iters=30))[3])
    cb = np.asarray(cb)
    rel = abs(float(cb[-1]) - float(cr[-1])) / max(abs(float(cr[-1])), 1e-30)
    gates = {
        "devices": int(mesh.devices.size), "cost0": float(cb[0]),
        "cost_blocked": float(cb[-1]), "cost_single": float(cr[-1]),
        "rel_diff": rel, "rel_diff_le_0.05": rel <= 0.05,
        "cost_falls": bool(cb[-1] < cb[0]),
        "halo_fraction": stats.get("halo_fraction"),
    }
    return report("block_ba4", gates, t0)


# ---------------------------------------------------------------------------

def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sfmx.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(card(), flush=True)

    oks = []
    ok, ctx = phase_build()
    oks.append(ok)
    if args.chips == 1:
        oks.append(phase_serve_gather(ctx)[0])
        oks.append(phase_serve_streaming(ctx)[0])
        oks.append(phase_ba())
    else:
        ok, single = phase_serve_streaming(ctx)
        oks.append(ok)
        oks.append(phase_router(ctx, single))
        oks.append(phase_sharded_localize(ctx))
        oks.append(phase_block_ba())
    if not all(oks):
        print("chip_smoke: a phase failed its gates", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
