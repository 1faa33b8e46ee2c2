"""Multi-session map merge (C12): cross-registration → fusion → joint BA.

Capability parity: the reference's model-merge tool (SURVEY §3.5): match
common features across session reconstructions, solve the similarity
transform between them, concatenate, and jointly bundle-adjust.

Design: cross-session registration is a landmark-descriptor GEMM +
batched 3-point RANSAC over Umeyama hypotheses (vmapped closed-form solves,
no iterative alignment); matched landmark pairs are FUSED (one landmark id,
observations remapped), which is what stitches the sessions together in the
joint BA.

Robustness (VERDICT r4 item 1): every registration goes through
``recon.register`` — support gate + split-half stability + cross-
reprojection verification, retried across thresholds/keys, RegistrationError
on exhaustion.  Sessions no longer register star-wise onto session 0: a
registration GRAPH is built over every verified session pair and sessions
compose into the root frame along its maximum-inlier spanning tree, so a
20k-image city block whose sessions only overlap pairwise chains through
its neighbors (SURVEY §3.5).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.masking import NEG_INF
from ..mapstore.scene import Scene
from ..solvers import lm, ransac, umeyama
from .register import RegistrationError, register_landmarks_verified


def landmark_descriptors(scene: Scene, feat_desc: np.ndarray, obs_feat: np.ndarray):
    """Mean per-landmark descriptor over alive observations (host-side)."""
    obs_cam = np.asarray(scene.obs_cam)
    obs_pt = np.asarray(scene.obs_pt)
    alive = np.asarray(scene.obs_alive)
    P, D = scene.X.shape[0], feat_desc.shape[-1]
    acc = np.zeros((P, D), np.float32)
    cnt = np.zeros(P, np.float32)
    np.add.at(acc, obs_pt[alive], feat_desc[obs_cam[alive], obs_feat[alive]])
    np.add.at(cnt, obs_pt[alive], 1.0)
    acc /= np.maximum(cnt[:, None], 1.0)
    n = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(n, 1e-8)


def register_pair(Xa, desc_a, alive_a, Xb, desc_b, alive_b, *,
                  key=None, ratio: float = 0.9, k_hypotheses: int = 2048,
                  inlier_frac_of_extent: float = 0.02):
    """Estimate sim3 taking scene B coords into scene A's frame.

    Returns (s, R, t, pairs (M,2) matched landmark ids, inlier_mask (M,)).
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    sim = desc_a @ desc_b.T
    sim[~alive_a] = -2
    sim[:, ~alive_b] = -2
    best_b = sim.argmax(1)
    best_s = sim.max(1)
    mutual = sim.argmax(0)[best_b] == np.arange(len(desc_a))
    cand = (best_s > 0.7) & mutual & alive_a
    ia = np.where(cand)[0]
    ib = best_b[ia]
    if len(ia) < 3:
        raise ValueError(f"too few cross-session landmark matches: {len(ia)}")

    Pa = jnp.asarray(Xa[ia], jnp.float32)
    Pb = jnp.asarray(Xb[ib], jnp.float32)
    extent = float(np.linalg.norm(Xa[alive_a].max(0) - Xa[alive_a].min(0)))
    thresh = (inlier_frac_of_extent * extent) ** 2

    def solver(pa, pb):
        s, R, t = umeyama.umeyama(pb, pa)  # B -> A
        return s, R, t

    def residual_fn(model, pa, pb):
        s, R, t = model
        pred = umeyama.apply_sim3(s, R, t, pb)
        return jnp.sum((pred - pa) ** 2, axis=-1)

    mask = jnp.ones(len(ia), bool)
    (s, R, t), inliers, cnt = ransac.ransac(
        key, solver, residual_fn, (Pa, Pb), mask,
        k_hypotheses=k_hypotheses, sample_size=3, inlier_threshold=thresh,
    )
    # refine on inliers
    s, R, t = umeyama.umeyama(Pb, Pa, inliers)
    pairs = np.stack([ia, ib], axis=1)
    return float(s), np.asarray(R), np.asarray(t), pairs, np.asarray(inliers)


def transform_scene_inplace(cam_R, cam_t, X, s, R, t):
    """Apply world similarity (B->A) to poses and points of scene B.

    New pose: R' = Rc R^T, t' = s*tc - R' t  (keeps pixel projections, depths
    scale by s).
    """
    X2 = s * (X @ R.T) + t
    R2 = np.einsum("cij,kj->cik", cam_R, R)  # Rc @ R^T
    t2 = s * cam_t - np.einsum("cij,j->ci", R2, t)
    return R2, t2, X2


def merge_scenes(sessions, *, ba_iters: int = 20, cg_iters: int = 40,
                 huber_px: float = 4.0, seed: int = 0,
                 reproj_px: float = 10.0):
    """Merge session maps into one scene + joint BA.

    sessions: list of (Scene, feat_desc (C,K,D), kp_uv, kp_mask, obs_feat).
    The first session defines the output frame.

    Raises RegistrationError (with per-pair diagnostics) when the verified
    registration graph does not connect every session — a merge that cannot
    be verified is an ERROR, not a silently corrupted map.
    """
    key = jax.random.PRNGKey(seed)
    N = len(sessions)
    stats = {"n_sessions": N, "pair_inliers": [], "edges": [],
             "failed_edges": []}

    # Per-session numpy state.
    st = []
    for scene, desc, kp_uv, kp_mask, obs_feat in sessions:
        st.append({
            "R": np.array(scene.cam_R), "t": np.array(scene.cam_t),
            "X": np.array(scene.X), "Xa": np.array(scene.X_alive),
            "cam_alive": np.array(scene.cam_alive), "cam_k": np.array(scene.cam_k),
            "obs_cam": np.array(scene.obs_cam), "obs_pt": np.array(scene.obs_pt),
            "obs_uv": np.array(scene.obs_uv), "obs_alive": np.array(scene.obs_alive),
            "intr": np.array(scene.intr),
            "ldesc": landmark_descriptors(scene, desc, obs_feat),
        })

    # --- registration graph: every session pair, verified -------------------
    edges = {}  # (i,j) -> RegResult (sim3 j->i)
    for i in range(N):
        for j in range(i + 1, N):
            key, sk = jax.random.split(key)
            try:
                reg = register_landmarks_verified(
                    st[i]["X"], st[i]["ldesc"], st[i]["Xa"],
                    st[j]["X"], st[j]["ldesc"], st[j]["Xa"],
                    scene_a=st[i], scene_b=st[j], key=sk,
                    reproj_px=reproj_px)
                edges[(i, j)] = reg
                stats["edges"].append(
                    {"pair": (i, j), "inliers": int(reg.inliers.sum()),
                     **{k: v for k, v in reg.diag.items()
                        if k in ("reproj_px", "inlier_frac")}})
            except RegistrationError as e:
                stats["failed_edges"].append(
                    {"pair": (i, j), "attempts": e.attempts})

    # --- maximum-inlier spanning tree from session 0 ------------------------
    in_tree = {0}
    tree: list[tuple[int, int]] = []  # (parent_in_tree, child)
    while len(in_tree) < N:
        best = None
        for (i, j), reg in edges.items():
            w = int(reg.inliers.sum())
            if (i in in_tree) != (j in in_tree):
                parent, child = (i, j) if i in in_tree else (j, i)
                if best is None or w > best[0]:
                    best = (w, parent, child)
        if best is None:
            missing = sorted(set(range(N)) - in_tree)
            raise RegistrationError(
                f"registration graph disconnected: sessions {missing} have "
                f"no verified edge into the merged component "
                f"({len(edges)} verified / {len(stats['failed_edges'])} "
                "failed edges)",
                [a for fe in stats["failed_edges"] for a in fe["attempts"]])
        _, parent, child = best
        in_tree.add(child)
        tree.append((parent, child))
    stats["tree"] = tree
    stats["pair_inliers"] = [int(edges[e].inliers.sum())
                             for e in sorted(edges)]

    # --- compose similarities into the root frame along the tree ------------
    # T[i] = (s,R,t) taking session-i coords into session-0 coords
    T = {0: (1.0, np.eye(3), np.zeros(3))}
    changed = True
    while changed:
        changed = False
        for parent, child in tree:
            if child in T or parent not in T:
                continue
            sp, Rp, tp = T[parent]
            if (parent, child) in edges:
                r = edges[(parent, child)]  # child -> parent
                sc_, Rc, tc = r.s, r.R, r.t
            else:
                r = edges[(child, parent)]  # parent -> child: invert
                sc_ = 1.0 / r.s
                Rc = r.R.T
                tc = -(Rc @ r.t) / r.s
            # compose: parent∘child→parent = 0-frame
            T[child] = (sp * sc_, Rp @ Rc, sp * (Rp @ tc) + tp)
            changed = True

    for i in range(1, N):
        s, R, t = T[i]
        st[i]["R"], st[i]["t"], st[i]["X"] = transform_scene_inplace(
            st[i]["R"], st[i]["t"], st[i]["X"], s, R, t)

    # --- landmark fusion across ALL verified edges --------------------------
    # conflict-aware union-find over (session, landmark): a component may
    # hold at most one landmark per session (a physical point appears once
    # per session map), so a union whose components share a session is a
    # provably aliased match and is rejected — same rule as track building.
    P_sizes = [len(s_i["X"]) for s_i in st]
    pt_offsets = np.concatenate([[0], np.cumsum(P_sizes)]).astype(np.int64)
    parent = {}
    sess_sets = {}

    def find(x):
        r = x
        while parent.get(r, r) != r:
            r = parent[r]
        while parent.get(x, x) != r:
            parent[x], x = r, parent[x]
        return r

    def sset(root, default_session):
        if root not in sess_sets:
            sess_sets[root] = {default_session}  # fresh singleton component
        return sess_sets[root]

    for (i, j), reg in edges.items():
        for (a, b), ok in zip(reg.pairs, reg.inliers):
            if not ok:
                continue
            ga = int(pt_offsets[i] + a)
            gb = int(pt_offsets[j] + b)
            ra, rb = find(ga), find(gb)
            if ra == rb:
                continue
            sa = sset(ra, i)
            sb = sset(rb, j)
            if sa & sb:
                continue  # aliased: two landmarks of one session
            rn, ro = (ra, rb) if len(sa) >= len(sb) else (rb, ra)
            parent[ro] = rn
            sess_sets[rn] = sa | sb
            sess_sets.pop(ro, None)

    # --- concatenate into one table; fused landmarks share the root id -----
    cam_off, intr_off = 0, 0
    Rs, ts, cam_alive, cam_k, Xs, Xa, intrs = [], [], [], [], [], [], []
    obs_cam, obs_pt, obs_uv, obs_alive = [], [], [], []
    fused = {g: find(g) for g in parent}  # only fused landmarks remap
    for i, s_i in enumerate(st):
        C, P = len(s_i["R"]), len(s_i["X"])
        pt_map = np.arange(P, dtype=np.int64) + pt_offsets[i]
        Xa_i = s_i["Xa"].copy()
        for g, r in fused.items():
            if pt_offsets[i] <= g < pt_offsets[i + 1] and r != g:
                loc = g - pt_offsets[i]
                pt_map[loc] = r
                Xa_i[loc] = False  # fused away: root row carries the point
        Rs.append(s_i["R"]); ts.append(s_i["t"])
        cam_alive.append(s_i["cam_alive"]); cam_k.append(s_i["cam_k"] + intr_off)
        Xs.append(s_i["X"]); Xa.append(Xa_i)
        intrs.append(s_i["intr"])
        obs_cam.append(s_i["obs_cam"] + cam_off)
        obs_pt.append(pt_map[s_i["obs_pt"]])
        obs_uv.append(s_i["obs_uv"]); obs_alive.append(s_i["obs_alive"])
        cam_off += C; intr_off += len(s_i["intr"])

    merged = Scene(
        intr=jnp.asarray(np.concatenate(intrs), jnp.float32),
        cam_k=jnp.asarray(np.concatenate(cam_k), jnp.int32),
        cam_R=jnp.asarray(np.concatenate(Rs), jnp.float32),
        cam_t=jnp.asarray(np.concatenate(ts), jnp.float32),
        cam_alive=jnp.asarray(np.concatenate(cam_alive)),
        X=jnp.asarray(np.concatenate(Xs), jnp.float32),
        X_alive=jnp.asarray(np.concatenate(Xa)),
        obs_cam=jnp.asarray(np.concatenate(obs_cam), jnp.int32),
        obs_pt=jnp.asarray(np.concatenate(obs_pt), jnp.int32),
        obs_uv=jnp.asarray(np.concatenate(obs_uv), jnp.float32),
        obs_alive=jnp.asarray(np.concatenate(obs_alive)),
    )

    # Joint global BA (the reference's final merge step).
    w = np.asarray(merged.obs_alive).astype(np.float32)
    fixed = ~np.asarray(merged.cam_alive)
    first = np.flatnonzero(np.asarray(merged.cam_alive))
    if len(first):
        fixed[first[0]] = True
    R2, t2, X2, costs = lm.ba_solve(
        merged.intr, merged.cam_k, merged.cam_R, merged.cam_t, merged.X,
        merged.obs_cam, merged.obs_pt, merged.obs_uv, jnp.asarray(w),
        jnp.asarray(fixed), iters=ba_iters, cg_iters=cg_iters, huber_px=huber_px,
    )
    merged = dataclasses.replace(merged, cam_R=R2, cam_t=t2, X=X2)
    stats["joint_ba_cost"] = [float(costs[0]), float(costs[-1])]
    stats["n_cameras"] = int(np.asarray(merged.cam_alive).sum())
    stats["n_points"] = int(np.asarray(merged.X_alive).sum())
    return merged, stats
