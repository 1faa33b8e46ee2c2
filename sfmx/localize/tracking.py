"""Sequential localization: per-frame tracking with a temporal pose prior.

Capability parity: the reference's deployment pattern (SURVEY §1.1, §3.2) is
CONTINUOUS localization — NavCog localizes a stream of camera frames, where
each estimate constrains the next frame's search the same way a beacon
prior does, and a lost track falls back to global relocalization.

Design: tracking reuses the ONE jitted ``localize_query`` in two
compiled specializations — prior-gated (the C10 fusion hook:
``prior_center``/``prior_radius`` mask retrieval) and global (relocalize).
Both trace once; the host loop between frames carries only a tiny
(center, tracked) state and never changes shapes.  The prior keeps
retrieval honest in self-similar corridors (the repetitive-texture failure
mode of global retrieval) and is the serving-path analog of the beacon
gate, so beacons and tracking compose: the prior radius is simply the
tighter of the two.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .localize import LocalizationMap, LocalizeResult, localize_query


@dataclass
class TrackingConfig:
    radius: float = 3.0          # map-units search radius around the prior
    min_conf: float = 0.05       # below this the frame does not update the prior
    min_inliers: int = 12        # accept gate (shared with LocalizeConfig)
    max_coast: int = 3           # tracked frames allowed without an accept
    # localize_query passthrough:
    top_k_kf: int = 8
    m_cap: int = 2048
    k_hypotheses: int = 1024
    px_thresh: float = 4.0
    sim_thresh: float = 0.75
    pnp_solver: str = "dlt6"
    extra: dict = field(default_factory=dict)  # q_bits etc. per-call extras


@dataclass
class TrackingState:
    """Host-side inter-frame state (tiny; never enters a jitted program)."""

    center: np.ndarray | None = None
    tracked: bool = False
    coast: int = 0               # consecutive low-confidence frames


class SequenceLocalizer:
    """Frame-by-frame localization against one map with track/reloc logic.

    Usage::

        seq = SequenceLocalizer(lmap, intr, TrackingConfig(radius=2.0))
        for frame_feats in stream:
            res, tracked = seq.step(desc, uv, mask, key)
    """

    def __init__(self, lmap: LocalizationMap, intr: jax.Array,
                 cfg: TrackingConfig | None = None):
        self.lmap = lmap
        self.intr = jnp.asarray(intr)
        self.cfg = cfg or TrackingConfig()
        self.state = TrackingState()
        self.stats = {"frames": 0, "tracked": 0, "relocalized": 0, "lost": 0}

    def _kw(self):
        c = self.cfg
        return dict(top_k_kf=c.top_k_kf, m_cap=c.m_cap,
                    k_hypotheses=c.k_hypotheses, px_thresh=c.px_thresh,
                    sim_thresh=c.sim_thresh, min_inliers=c.min_inliers,
                    pnp_solver=c.pnp_solver, **c.extra)

    def step(self, q_desc, q_uv, q_mask, key) -> tuple[LocalizeResult, bool]:
        """Localize one frame. Returns (result, tracked_flag).

        tracked_flag is True when the accepted pose came from the prior-gated
        search (continuous track), False for global (re)localization.
        """
        c, st = self.cfg, self.state
        self.stats["frames"] += 1
        res, via_prior = None, False
        if st.tracked and st.center is not None:
            res = localize_query(
                self.lmap, q_desc, q_uv, q_mask, self.intr, key,
                prior_center=jnp.asarray(st.center, jnp.float32),
                prior_radius=c.radius, **self._kw())
            # Only an ACCEPTED prior-gated pose counts as tracking; a weak
            # result (0 < conf < min_conf) must still fall through to global
            # relocalization, which searches the whole map.
            via_prior = float(res.confidence) >= c.min_conf
        if res is None or not via_prior:
            # global relocalization (also the cold-start path)
            res = localize_query(self.lmap, q_desc, q_uv, q_mask, self.intr,
                                 key, **self._kw())

        accepted = float(res.confidence) >= c.min_conf
        if accepted:
            st.center = np.asarray(res.center)
            st.coast = 0
            st.tracked = True
            self.stats["tracked" if via_prior else "relocalized"] += 1
        else:
            st.coast += 1
            self.stats["lost"] += 1
            if st.coast > c.max_coast:
                st.tracked = False  # stop trusting the stale prior
        return res, via_prior and accepted


def _sequence_scan(lmap: LocalizationMap, q_desc, q_uv, q_mask, intr, keys,
                   cfg: TrackingConfig):
    """Whole-sequence tracking as ONE device program (lax.scan).

    The host version pays two dispatches and two blocking host reads per
    frame; here the (center, tracked, coast) state stays on-device
    and frames run back-to-back.  Same decision logic as
    ``SequenceLocalizer.step``, cond-gated: the prior-gated search runs
    only while tracked, and global relocalization only when the prior-gated
    result is not accepted.
    """
    c = cfg
    kw = dict(top_k_kf=c.top_k_kf, m_cap=c.m_cap,
              k_hypotheses=c.k_hypotheses, px_thresh=c.px_thresh,
              sim_thresh=c.sim_thresh, min_inliers=c.min_inliers,
              pnp_solver=c.pnp_solver, **c.extra)

    def empty_result():
        return LocalizeResult(
            R=jnp.eye(3, dtype=jnp.float32), t=jnp.zeros(3, jnp.float32),
            n_inliers=jnp.asarray(0, jnp.int32),
            confidence=jnp.asarray(0.0, jnp.float32),
            center=jnp.zeros(3, jnp.float32))

    def step(carry, x):
        center, tracked, coast = carry
        d, u, m, k = x
        res1 = jax.lax.cond(
            tracked,
            lambda: localize_query(lmap, d, u, m, intr, k,
                                   prior_center=center,
                                   prior_radius=c.radius, **kw),
            empty_result)
        via_prior = tracked & (res1.confidence >= c.min_conf)
        res = jax.lax.cond(
            via_prior,
            lambda: res1,
            lambda: localize_query(lmap, d, u, m, intr, k, **kw))
        accepted = res.confidence >= c.min_conf
        center2 = jnp.where(accepted, res.center, center)
        coast2 = jnp.where(accepted, 0, coast + 1)
        tracked2 = jnp.where(accepted, True,
                             tracked & (coast2 <= c.max_coast))
        return ((center2, tracked2, coast2),
                (res, via_prior & accepted, accepted, via_prior))

    init = (jnp.zeros(3, jnp.float32), jnp.asarray(False),
            jnp.asarray(0, jnp.int32))
    _, out = jax.lax.scan(step, init, (q_desc, q_uv, q_mask, keys))
    return out


def localize_sequence(lmap: LocalizationMap, q_desc, q_uv, q_mask, intr,
                      key, cfg: TrackingConfig | None = None):
    """Localize a whole (N,K,...) feature sequence with temporal tracking.

    Returns (list[LocalizeResult], list[bool] tracked flags, stats dict).
    Runs as one jitted lax.scan over the frames (see ``_sequence_scan``).
    """
    cfg = cfg or TrackingConfig()
    n = q_desc.shape[0]
    keys = jax.random.split(key, n)
    res_b, flags_b, acc_b, via_b = jax.jit(
        lambda d, u, m, i, k: _sequence_scan(lmap, d, u, m, i, k, cfg))(
        jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask),
        jnp.asarray(intr), keys)
    flags = [bool(f) for f in np.asarray(flags_b)]
    acc = np.asarray(acc_b)
    via = np.asarray(via_b)
    results = [jax.tree_util.tree_map(lambda x, i=i: x[i], res_b)
               for i in range(n)]
    stats = {"frames": n,
             "tracked": int((acc & via).sum()),
             "relocalized": int((acc & ~via).sum()),
             "lost": int((~acc).sum())}
    return results, flags, stats
