"""Map-sharded localization: the landmark pool split over the device mesh.

Capability parity: the reference localizes against one in-RAM map on one
machine (SURVEY §3.2).  At building/city scale (BASELINE configs 4-5) the
landmark pool — positions + descriptors, the dominant serving state — does
not fit one chip's HBM.  Here it is sharded over a ``map`` mesh axis
(SURVEY §2.3 TP row: "tiled matcher with sharded map-descriptor pool").

Design: queries are replicated (they are small); each device runs top-2
matching of the whole query batch against ITS landmark shard, then one
``all_gather`` of per-shard (best, argbest, second) — 3 scalars per query
feature per shard — merges to the exact global top-2.  Landmark positions
for the winning indices are fetched with a masked local gather + ``psum``.
Total comm per batch: O(n_shards * B * K) scalars, independent of pool
size P.  The PnP-RANSAC tail then runs replicated (it is per-query work on
K correspondences).

The per-shard matcher is ``kernels.top2.top2`` (the kernel on the GPU, the
chunked plain version on the CPU) — same acceptance semantics (Lowe ratio +
absolute floor) as ``localize_batch_streaming``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import cameras
from .localize import LocalizationMap, LocalizeResult, _pnp_from_matches

AXIS = "map"


def shard_localization_map(lmap: LocalizationMap, mesh: Mesh) -> LocalizationMap:
    """Place landmark columns (X, desc, alive) along the ``map`` mesh axis,
    keyframe columns replicated.  Pads P to a multiple of the axis size with
    dead rows; returns the same pytree type (drop-in for the sharded path)."""
    n = mesh.shape[AXIS]
    Pn = lmap.X.shape[0]
    pad = (-Pn) % n
    X = np.pad(np.asarray(lmap.X), ((0, pad), (0, 0)))
    desc = np.pad(np.asarray(lmap.lm_desc), ((0, pad), (0, 0)))
    alive = np.pad(np.asarray(lmap.lm_alive), (0, pad))
    bits = lmap.lm_bits
    if bits is not None:
        bits = jax.device_put(np.pad(np.asarray(bits), ((0, pad), (0, 0))),
                              NamedSharding(mesh, P(AXIS)))
    sh = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    return lmap._replace(
        X=jax.device_put(X, sh),
        lm_desc=jax.device_put(desc, sh),
        lm_alive=jax.device_put(alive, sh),
        lm_bits=bits,
        kf_gdesc=jax.device_put(np.asarray(lmap.kf_gdesc), rep),
        kf_alive=jax.device_put(np.asarray(lmap.kf_alive), rep),
        kf_centers=jax.device_put(np.asarray(lmap.kf_centers), rep),
        kf_lm=jax.device_put(np.asarray(lmap.kf_lm), rep),
        kf_lm_mask=jax.device_put(np.asarray(lmap.kf_lm_mask), rep),
        vocab=(jax.device_put(np.asarray(lmap.vocab), rep)
               if lmap.vocab is not None else None),
    )


@partial(jax.jit, static_argnames=("mesh", "k_hypotheses"))
def _localize_sharded_jit(lmap, q_desc, q_uv, q_mask, intr_b, key, *, mesh,
                          k_hypotheses, px_thresh, ratio, sim_thresh,
                          min_inliers):
    from ..kernels.top2 import top2

    B, K, D = q_desc.shape
    q = q_desc.reshape(B * K, D)

    def shard_fn(X_l, desc_l, alive_l, q):
        n = jax.lax.axis_size(AXIS)
        d = jax.lax.axis_index(AXIS)
        Pl = desc_l.shape[0]
        s1, i1, s2 = top2(q, desc_l, alive_l)
        # exact global top-2 from per-shard (s1, i1, s2): winner's best is
        # global best; global second = max(winner's second, losers' bests).
        # Expressed with pmax/pmin/psum so every output is statically known
        # replicated; comm is O(BK) scalars per collective, independent of P.
        s1g = jax.lax.pmax(s1, AXIS)                   # (BK,) global best
        tied = s1 >= s1g                               # float-exact: s1 <= s1g
        win = jax.lax.pmin(jnp.where(tied, d, n), AXIS)  # tie -> lowest shard
        mine = win == d
        ig = jax.lax.psum(jnp.where(mine, i1 + d * Pl, 0), AXIS)
        s2g = jnp.maximum(
            jax.lax.pmax(jnp.where(mine, s2, -jnp.inf), AXIS),
            jax.lax.pmax(jnp.where(mine, -jnp.inf, s1), AXIS))
        # fetch winning landmark positions: masked local gather + psum
        X3 = jax.lax.psum(
            jnp.where(mine[:, None], X_l[jnp.clip(i1, 0, Pl - 1)], 0.0), AXIS)
        aliveg = jax.lax.psum(
            jnp.where(mine, alive_l[jnp.clip(i1, 0, Pl - 1)], False)
            .astype(jnp.int32), AXIS) > 0
        return s1g, s2g, ig, X3, aliveg

    s1, s2, idx, X3, alive = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )(lmap.X, lmap.lm_desc, lmap.lm_alive, q)

    from ..kernels.matching import ratio_accept

    ok = ratio_accept(s1, s2, ratio) & (s1 > sim_thresh) & alive
    corr_ok = ok.reshape(B, K) & q_mask
    X3 = X3.reshape(B, K, 3)

    xn = jax.vmap(cameras.pixel_to_normalized)(intr_b, q_uv)
    keys = jax.random.split(key, B)
    fn = partial(_pnp_from_matches, k_hypotheses=k_hypotheses,
                 px_thresh=px_thresh, min_inliers=min_inliers)
    return jax.vmap(fn)(xn, X3, corr_ok, intr_b, keys), idx.reshape(B, K)


def localize_batch_sharded(
    lmap: LocalizationMap,     # from shard_localization_map
    q_desc: jax.Array,         # (B,K,D)
    q_uv: jax.Array,           # (B,K,2)
    q_mask: jax.Array,         # (B,K)
    intr: jax.Array,           # (7,) or (B,7)
    key: jax.Array,
    *,
    mesh: Mesh,
    k_hypotheses: int = 1024,
    px_thresh: float = 4.0,
    ratio: float = 0.85,
    sim_thresh: float = 0.75,
    min_inliers: int = 12,
) -> LocalizeResult:
    """Batch localization against a mesh-sharded landmark pool (see module
    docstring).  ``lmap`` must come from :func:`shard_localization_map`."""
    B = q_desc.shape[0]
    intr_b = jnp.broadcast_to(jnp.atleast_2d(intr), (B, 7))
    res, _ = _localize_sharded_jit(
        lmap, q_desc, q_uv, q_mask, intr_b, key, mesh=mesh,
        k_hypotheses=k_hypotheses, px_thresh=px_thresh, ratio=ratio,
        sim_thresh=sim_thresh, min_inliers=min_inliers)
    return res
