"""Localization serving: batched device queue + HTTP API.

Capability parity: the reference's Node.js ``VisionLocalizeServer`` (C14,
SURVEY.md §3.3): HTTP endpoint accepting an IMAGE (+ optional beacon
readings, + map id), returning a 6-DOF pose JSON; maps are loaded once and
kept resident.  Feature extraction happens server-side, like the
reference's native localizer — clients send pixels, not descriptors
(pre-extracted features remain accepted for feature-level clients).

Design: instead of the reference's one-query-at-a-time native-addon
call, concurrent requests are micro-batched onto the device — a background
loop drains the queue every ``batch_window_ms``, and the whole batch
(extraction for image requests, then vmapped ``localize_query``) runs in a
worker thread so the event loop keeps accepting requests during device
dispatch.  Batch sizes are bucketed to powers of two and feature counts
padded to the per-map capacity, so the set of compiled executables is
bounded (no unbounded re-jit).  Maps are device-resident
``LocalizationMap`` pytrees keyed by map id.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import io
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..localize import (LocalizationMap, localize_batch_streaming,
                        localize_query)
from ..localize.localize import use_streaming
from ..localize.fusion import BeaconPrior, fuse


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    image_requests: int = 0
    batches: int = 0
    total_latency_ms: float = 0.0
    total_batch_size: int = 0
    # ring buffer of recent latencies for percentile export (§5.5)
    recent_latencies: list = dataclasses.field(default_factory=list)
    _recent_cap: int = 1024

    def record_latency(self, ms: float):
        self.requests += 1
        self.total_latency_ms += ms
        if len(self.recent_latencies) >= self._recent_cap:
            self.recent_latencies.pop(0)
        self.recent_latencies.append(ms)

    def snapshot(self):
        lat = sorted(self.recent_latencies)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "requests": self.requests,
            "image_requests": self.image_requests,
            "batches": self.batches,
            "mean_latency_ms": self.total_latency_ms / max(self.requests, 1),
            "p50_latency_ms": pct(0.50),
            "p95_latency_ms": pct(0.95),
            "p99_latency_ms": pct(0.99),
            "mean_batch_size": self.total_batch_size / max(self.batches, 1),
        }


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n (capped): bounds the set of compiled shapes."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class _Request:
    map_id: str
    prior: BeaconPrior | None
    fut: asyncio.Future
    # feature payload (filled directly, or by server-side extraction)
    q_desc: np.ndarray | None = None
    q_uv: np.ndarray | None = None
    q_mask: np.ndarray | None = None
    q_bits: np.ndarray | None = None
    # image payload ((H,W) float32 grayscale in [0,1])
    image: np.ndarray | None = None
    intr: np.ndarray | None = None   # per-request intrinsics override


class LocalizationService:
    """Micro-batching front of the jitted extraction + localization path."""

    def __init__(self, *, batch_window_ms: float = 5.0, max_batch: int = 32):
        self.maps: dict[str, tuple] = {}   # id -> (lmap, intr, cfg)
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self.stats = ServiceStats()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task = None
        self._key = jax.random.PRNGKey(0)

    def load_map(self, map_id: str, lmap: LocalizationMap, intr: jnp.ndarray,
                 cfg=None, *, shards: int = 1):
        """cfg: PipelineConfig the map was built with — required for image
        requests (queries must use the same extractor family).

        shards > 1 splits the map across that many devices and routes each
        query by retrieval (router.py — the multi-floor/building scale path;
        float descriptors only)."""
        if cfg is None:
            from ..cli.config import PipelineConfig

            cfg = PipelineConfig()
        if shards > 1:
            from .router import MapShardRouter, split_localization_map

            obj = MapShardRouter.build(split_localization_map(lmap, shards))
        else:
            obj = jax.device_put(lmap)
        self.maps[map_id] = (obj, jnp.asarray(intr, jnp.float32), cfg)

    def warmup(self, map_id: str, *, max_bucket: int | None = None):
        """Compile every pow2 batch bucket for this map's extraction and
        localization programs: serving must never pay a mid-traffic
        compile.

        With the persistent compile cache this is a one-time cost per
        deployment; `sfmx bundle` ships the resulting cache.
        """
        lmap, _intr0, cfg = self.maps[map_id]
        W, H = cfg.resize_to
        cap = max_bucket or self.max_batch
        b = 1
        buckets = []
        while b <= cap:
            buckets.append(b)
            b *= 2
        for n in buckets:
            reqs = [_Request(map_id, None, None,
                             image=np.zeros((H, W), np.float32))
                    for _ in range(n)]
            self._extract(reqs)
            binary = (reqs[0].q_bits is not None and
                      getattr(lmap, "lm_bits", None) is not None)
            self._localize_group(map_id, reqs, binary)

    async def start(self):
        self._task = asyncio.create_task(self._batch_loop())

    async def stop(self):
        if self._task:
            self._task.cancel()

    async def localize(self, map_id: str, q_desc=None, q_uv=None, q_mask=None,
                       prior: BeaconPrior | None = None, *,
                       image: np.ndarray | None = None,
                       q_bits=None, intr=None) -> dict:
        """Enqueue one query: either pre-extracted features (q_desc/q_uv/
        q_mask[, q_bits]) or a decoded grayscale image (extraction runs
        server-side in the device batch)."""
        t0 = time.perf_counter()
        fut = asyncio.get_event_loop().create_future()
        req = _Request(map_id, prior, fut, q_desc=q_desc, q_uv=q_uv,
                       q_mask=q_mask, q_bits=q_bits, image=image, intr=intr)
        if image is not None:
            self.stats.image_requests += 1
        await self._queue.put(req)
        out = await fut
        dt = (time.perf_counter() - t0) * 1e3
        self.stats.record_latency(dt)
        out["latency_ms"] = dt
        return out

    async def _batch_loop(self):
        loop = asyncio.get_event_loop()
        while True:
            req = await self._queue.get()
            batch = [req]
            deadline = time.perf_counter() + self.batch_window_ms / 1e3
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            self.stats.batches += 1
            self.stats.total_batch_size += len(batch)
            # run device work in a worker thread: the event loop keeps
            # accepting (and batching) requests during device dispatch
            results = await loop.run_in_executor(None, self._run_batch, batch)
            for req, res in results:
                if req.fut.done():
                    continue
                if isinstance(res, Exception):
                    req.fut.set_exception(res)
                else:
                    req.fut.set_result(res)

    # ---- synchronous device work (worker thread) ---------------------------

    def _extract(self, reqs: list[_Request]):
        """Server-side extraction for image requests, grouped by (map, shape).

        One ``extract_features`` device call per group, batch padded to a
        power-of-two bucket so compiled shapes stay bounded."""
        from ..cli.pipeline import extract_features

        groups: dict[tuple, list[_Request]] = {}
        for r in reqs:
            groups.setdefault((r.map_id, r.image.shape), []).append(r)
        for (map_id, _shape), g in groups.items():
            _lmap, _intr, cfg = self.maps[map_id]
            b = _bucket(len(g), self.max_batch)
            imgs = np.stack([r.image for r in g] + [g[0].image] * (b - len(g)))
            feats = extract_features(imgs, cfg)
            desc = np.asarray(feats.desc)
            uv = np.asarray(feats.kp.uv)
            mask = np.asarray(feats.kp.mask)
            bits = np.asarray(feats.desc_bits)
            for i, r in enumerate(g):
                r.q_desc, r.q_uv, r.q_mask = desc[i], uv[i], mask[i]
                r.q_bits = bits[i]

    def _run_batch(self, batch: list[_Request]):
        out: list[tuple[_Request, dict | Exception]] = []
        img_reqs = [r for r in batch if r.image is not None]
        if img_reqs:
            try:
                self._extract(img_reqs)
            except Exception as e:
                for r in img_reqs:
                    out.append((r, e))
                batch = [r for r in batch if r.image is None]

        # group by (map id, K, binary) so each group is ONE vmapped call
        by_map: dict[tuple, list[_Request]] = {}
        for r in batch:
            if r.q_desc is None:
                out.append((r, ValueError("no features or image in request")))
                continue
            binary = (r.q_bits is not None and
                      getattr(self.maps[r.map_id][0], "lm_bits", None) is not None)
            by_map.setdefault((r.map_id, r.q_desc.shape[0], binary), []).append(r)
        for (map_id, _k, binary), reqs in by_map.items():
            try:
                out.extend(self._localize_group(map_id, reqs, binary))
            except Exception as e:
                for r in reqs:
                    out.append((r, e))
        return out

    def _localize_group(self, map_id: str, reqs: list[_Request], binary: bool):
        from .router import MapShardRouter

        lmap, intr0, cfg = self.maps[map_id]
        lc = cfg.localize
        self._key, k = jax.random.split(self._key)
        b = _bucket(len(reqs), self.max_batch)
        keys = jax.random.split(k, b)

        def pad(stack):
            return np.concatenate([stack, np.repeat(stack[:1], b - len(reqs), 0)]) \
                if len(reqs) < b else stack

        q_desc = jnp.asarray(pad(np.stack([r.q_desc for r in reqs])))
        q_uv = jnp.asarray(pad(np.stack([r.q_uv for r in reqs])))
        q_mask = jnp.asarray(pad(np.stack([r.q_mask for r in reqs])))
        intr_b = jnp.asarray(pad(np.stack([
            np.asarray(r.intr, np.float32) if r.intr is not None
            else np.asarray(intr0) for r in reqs])))
        kw = dict(top_k_kf=lc.top_k_kf, m_cap=lc.m_cap,
                  k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
                  sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers,
                  ham_thresh=lc.ham_thresh, pnp_solver=lc.pnp_solver)
        if isinstance(lmap, MapShardRouter):
            # multi-device map: route each query to its shard's device; the
            # full localize kwarg set (incl. pnp_solver/ham_thresh) forwards
            q_bits = jnp.asarray(pad(np.stack([r.q_bits for r in reqs]))) \
                if binary else None
            res_b, _ = lmap.localize_batch(
                q_desc, q_uv, q_mask, intr_b, k, q_bits=q_bits, **kw)
        elif binary:
            q_bits = jnp.asarray(pad(np.stack([r.q_bits for r in reqs])))
            fn = lambda d, u, m, ki, kq, bq: localize_query(
                lmap, d, u, m, ki, kq, q_bits=bq, **kw)
            res_b = jax.vmap(fn)(q_desc, q_uv, q_mask, intr_b, keys, q_bits)
        elif use_streaming(lc, lmap, binary):
            # map-scale path: whole batch vs every landmark in ONE top-2
            # kernel call (no retrieval gather, no m_cap truncation)
            res_b = localize_batch_streaming(
                lmap, q_desc, q_uv, q_mask, intr_b, k,
                k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
                sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers,
                pnp_solver=lc.pnp_solver)
        else:
            fn = lambda d, u, m, ki, kq: localize_query(lmap, d, u, m, ki, kq, **kw)
            res_b = jax.vmap(fn)(q_desc, q_uv, q_mask, intr_b, keys)
        res_np = jax.tree_util.tree_map(np.asarray, res_b)
        out = []
        for i, r in enumerate(reqs):
            res = jax.tree_util.tree_map(lambda x: x[i], res_np)
            fused = fuse(res, r.prior)
            out.append((r, {
                "t": np.asarray(res.t).tolist(),
                "R": np.asarray(res.R).tolist(),
                "center": np.asarray(fused.center).tolist(),
                "n_inliers": int(res.n_inliers),
                "confidence": float(fused.confidence),
                "source": int(fused.source),
            }))
        return out


def decode_image_payload(data: bytes, resize_to=(640, 480)) -> np.ndarray:
    """Decode an uploaded JPEG/PNG to the (H,W) float32 grayscale in [0,1]
    the extractor consumes (same path as cli.ingest)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("L")
    if resize_to is not None:
        img = img.resize(resize_to, Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def make_app(service: LocalizationService):
    """aiohttp application exposing the reference's serving surface.

    POST /localize  {map_id,
                     image: base64 JPEG/PNG           # preferred: pixels in
                     | features: {desc:[[...]], uv:[[x,y]...], bits?: [[...]]},
                     intrinsics?: [fx,fy,cx,cy,k1,k2,k3],
                     beacons?: {center:[x,y,z], radius, confidence}}
    GET  /maps      list loaded maps
    GET  /stats     serving metrics
    """
    from aiohttp import web

    async def localize(request: web.Request):
        body = await request.json()
        map_id = body["map_id"]
        if map_id not in service.maps:
            return web.json_response({"error": f"unknown map {map_id}"}, status=404)
        prior = None
        if "beacons" in body and body["beacons"]:
            b = body["beacons"]
            prior = BeaconPrior(jnp.asarray(b["center"], jnp.float32),
                                float(b["radius"]), float(b.get("confidence", 0.5)))
        intr = (np.asarray(body["intrinsics"], np.float32)
                if body.get("intrinsics") else None)

        if "image" in body and body["image"]:
            cfg = service.maps[map_id][2]
            try:
                img = decode_image_payload(base64.b64decode(body["image"]),
                                           resize_to=cfg.resize_to)
            except Exception as e:
                return web.json_response({"error": f"bad image: {e}"}, status=400)
            out = await service.localize(map_id, prior=prior, image=img,
                                         intr=intr)
            return web.json_response(out)

        if "features" not in body:
            return web.json_response(
                {"error": "request needs 'image' or 'features'"}, status=400)
        desc = np.asarray(body["features"]["desc"], np.float32)
        uv = np.asarray(body["features"]["uv"], np.float32)
        k_cap = 512
        K, D = desc.shape
        q_desc = np.zeros((k_cap, D), np.float32)
        q_uv = np.zeros((k_cap, 2), np.float32)
        q_mask = np.zeros(k_cap, bool)
        n = min(K, k_cap)
        q_desc[:n], q_uv[:n], q_mask[:n] = desc[:n], uv[:n], True
        q_bits = None
        if body["features"].get("bits"):
            bits = np.asarray(body["features"]["bits"], np.uint32)
            q_bits = np.zeros((k_cap, bits.shape[1]), np.uint32)
            q_bits[:n] = bits[:n]
        out = await service.localize(map_id, q_desc, q_uv, q_mask, prior,
                                     q_bits=q_bits, intr=intr)
        return web.json_response(out)

    async def maps(_request):
        return web.json_response({"maps": list(service.maps.keys())})

    async def stats(_request):
        return web.json_response(service.stats.snapshot())

    app = web.Application(client_max_size=32 * 1024 ** 2)
    app.router.add_post("/localize", localize)
    app.router.add_get("/maps", maps)
    app.router.add_get("/stats", stats)

    async def on_startup(_app):
        await service.start()

    async def on_cleanup(_app):
        await service.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app
