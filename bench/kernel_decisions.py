"""Time the top-2 kernel against its plain versions on the GPU.

Each decision of PERF.md's "Kernel decisions on the H100" table comes from
this script: for every shape it compiles the kernel and the plain versions,
checks the kernel against the dense reference, and prints one JSON line per
(shape, implementation) with the median wall time of a jitted call, ended
by ``block_until_ready``, and the compiled program's temp memory.

    python bench/kernel_decisions.py [--reps 10] [--e2e]

Needs a GPU; exits non-zero elsewhere.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def timed(fn, args, reps):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3


def temp_mb(fn, args):
    ma = fn.lower(*args).compile().memory_analysis()
    return round(ma.temp_size_in_bytes / 2**20, 1) if ma else None


def unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def streaming(rows, P, reps, variants):
    from sfmx.kernels import top2

    rng = np.random.default_rng(0)
    pool = unit(rng, P, 128)
    q = pool[rng.integers(0, P, rows)] + 0.05 * unit(rng, rows, 128)
    q = jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True))
    pool = jnp.asarray(pool)
    mask = jnp.asarray(rng.random(P) > 0.02)
    args = (q, pool, mask)
    ref = jax.jit(top2.top2_reference)
    (r1, ri, r2), t_ref = timed(ref, args, reps)
    rows_out = [dict(impl="dense_gemm_top_k", ms=t_ref, temp_mb=temp_mb(ref, args))]
    scan = jax.jit(top2.top2_scan)
    _, t_scan = timed(scan, args, reps)
    rows_out.append(dict(impl="scan_chunks", ms=t_scan, temp_mb=temp_mb(scan, args)))
    margin = np.asarray(r1 - r2) > 4e-3
    for bq, bp, nw, ns in variants:
        fn = jax.jit(lambda q, p, m, bq=bq, bp=bp, nw=nw, ns=ns: [
            x[0] for x in top2.top2_kernel(
                q[None], p[None], m[None], jnp.zeros((1, 2), jnp.int32),
                block_q=bq, block_p=bp, num_warps=nw, num_stages=ns)])
        (k1, ki, k2), t = timed(fn, args, reps)
        rows_out.append(dict(
            impl=f"kernel_bq{bq}_bp{bp}_w{nw}_s{ns}", ms=t,
            temp_mb=temp_mb(fn, args),
            max_ds1=float(jnp.max(jnp.abs(k1 - r1))),
            max_ds2=float(jnp.max(jnp.abs(k2 - r2))),
            idx_mismatch_beyond_margin=int(np.sum(
                (np.asarray(ki) != np.asarray(ri)) & margin))))
    for r in rows_out:
        print(json.dumps(dict(shape=f"top2 {rows}x{P}", **r)), flush=True)


def pairs(C, K, n_pairs, reps):
    from sfmx.kernels import matching

    rng = np.random.default_rng(1)
    d = unit(rng, C, K, 128)
    # neighbouring images share most descriptors, like a walkthrough
    for c in range(1, C):
        keep = rng.random(K) < 0.6
        d[c, keep] = d[c - 1, keep] + 0.05 * unit(rng, int(keep.sum()), 128)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    masks = jnp.asarray(rng.random((C, K)) > 0.1)
    a = rng.integers(0, C - 1, n_pairs)
    prs = jnp.asarray(np.stack([a, np.minimum(a + rng.integers(1, 8, n_pairs),
                                              C - 1)], 1).astype(np.int32))
    args = (jnp.asarray(d), masks, prs)
    out = []
    res = {}
    for name, f in (("chunked_plain", matching.match_pairs_float_chunked),
                    ("kernel", matching.match_pairs_float_kernel)):
        fn = jax.jit(f)
        res[name], t = timed(fn, args, reps)
        out.append(dict(impl=name, ms=t, temp_mb=temp_mb(fn, args)))
    va, vb = (np.asarray(res[n].valid) for n in ("chunked_plain", "kernel"))
    both = va & vb
    agree = float((va == vb).mean())
    same_idx = bool(np.array_equal(np.asarray(res["kernel"].idx)[both],
                                   np.asarray(res["chunked_plain"].idx)[both]))
    for r in out:
        print(json.dumps(dict(shape=f"pairs K={K} Np={n_pairs}", **r,
                              valid_agree=agree, idx_equal=same_idx)),
              flush=True)


def streaming_end_to_end(B, K, P, reps):
    """``localize_batch_streaming`` (top-2 + RANSAC + refine) with each
    top-2 implementation swapped in, at the serving shape."""
    from functools import partial

    from sfmx.kernels import top2
    from sfmx.localize.localize import LocalizationMap, localize_batch_streaming

    rng = np.random.default_rng(2)
    desc = unit(rng, P, 128)
    lmap = LocalizationMap(
        X=jnp.asarray(rng.uniform(-3, 3, (P, 3)).astype(np.float32)),
        lm_desc=jnp.asarray(desc), lm_alive=jnp.ones(P, bool),
        kf_gdesc=jnp.zeros((4, 128)), kf_alive=jnp.ones(4, bool),
        kf_centers=jnp.zeros((4, 3)), kf_lm=jnp.zeros((4, 8), jnp.int32),
        kf_lm_mask=jnp.ones((4, 8), bool))
    q = desc[rng.integers(0, P, (B, K))] + 0.05 * unit(rng, B, K, 128)
    args = (lmap, jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True)),
            jnp.asarray(rng.uniform(0, 640, (B, K, 2)).astype(np.float32)),
            jnp.ones((B, K), bool),
            jnp.asarray([560.0, 560, 320, 240, 0, 0, 0]),
            jax.random.PRNGKey(0))
    kernel_top2 = top2.top2
    impls = {"kernel": kernel_top2,
             "scan_chunks": lambda q, p, m: top2.top2_scan(q, p, m),
             "dense_gemm_top_k": lambda q, p, m: top2.top2_reference(q, p, m)}
    try:
        for name, impl in impls.items():
            top2.top2 = impl
            fn = jax.jit(partial(localize_batch_streaming, k_hypotheses=1024))
            _, t = timed(fn, args, reps)
            print(json.dumps(dict(shape=f"localize_batch_streaming {B}x{K} "
                                  f"vs {P}", impl=name, ms=t)), flush=True)
    finally:
        top2.top2 = kernel_top2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--e2e", action="store_true",
                    help="only the end-to-end streaming localization times")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit("kernel_decisions.py measures the GPU; no GPU found")
    from sfmx.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(card(), flush=True)
    if args.e2e:
        streaming_end_to_end(16, 512, 100_352, args.reps)
        streaming_end_to_end(32, 1024, 100_352, args.reps)
        return
    variants = [(64, 64, 4, 2), (64, 128, 8, 2), (128, 64, 8, 2), (32, 64, 4, 3)]
    streaming(16 * 512, 100_352, args.reps, variants)
    streaming(32 * 1024, 100_352, args.reps, variants)
    pairs(256, 512, 9728, args.reps)
    pairs(128, 1024, 2048, args.reps)


if __name__ == "__main__":
    main()
