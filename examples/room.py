"""Textured-room renderer for end-to-end demos and integration tests.

Ray-casts a box-room interior (6 value-noise textured faces) — the geometry
class the reference targets (indoor walkthroughs, locally planar surfaces).
Pure numpy; fast enough for a handful of QVGA frames.
"""
from __future__ import annotations

import numpy as np

ROOM = np.array([[-5.0, 5.0], [-2.5, 2.5], [-5.0, 5.0]])  # x, y, z extents


class RoomTexture:
    def __init__(self, seed=0, res=96, octaves=4):
        # res is the FINEST grid; on a 10m face seen from ~5m at f=280 a texel
        # is then ~15px on screen — structure detectors can latch onto.
        # Finer grids alias into view-inconsistent noise.
        rng = np.random.default_rng(seed)
        self.grids = [rng.standard_normal((6, res // (2**o) + 2, res // (2**o) + 2))
                      for o in range(octaves)]
        self.res = res
        self.octaves = octaves

    def sample(self, face, u, v):
        """face: (N,) int, u,v in [0,1] -> intensity (N,)."""
        out = np.zeros_like(u)
        for o, g in enumerate(self.grids):
            n = g.shape[1] - 2
            x = u * n
            y = v * n
            x0 = np.clip(x.astype(int), 0, n - 1)
            y0 = np.clip(y.astype(int), 0, n - 1)
            fx = x - x0
            fy = y - y0
            v00 = g[face, y0, x0]
            v01 = g[face, y0, x0 + 1]
            v10 = g[face, y0 + 1, x0]
            v11 = g[face, y0 + 1, x0 + 1]
            # smoothstep for C1 continuity (gives corners, not just ramps)
            fx = fx * fx * (3 - 2 * fx)
            fy = fy * fy * (3 - 2 * fy)
            val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                   + v10 * (1 - fx) * fy + v11 * fx * fy)
            out += val * (1.5 ** o)  # coarse octaves dominate (smooth base + detail)
        return out


def look_at(eye, target, up=np.array([0.0, 1.0, 0.0])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def render_room(tex: RoomTexture, R, eye, width=320, height=240, focal=280.0):
    """Render the room interior from world-to-cam rotation R, camera center eye."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    xn = (xs - width / 2) / focal
    yn = (ys - height / 2) / focal
    dirs_cam = np.stack([xn, yn, np.ones_like(xn)], -1).reshape(-1, 3)
    dirs = dirs_cam @ R  # R^T @ d
    N = dirs.shape[0]
    best_t = np.full(N, np.inf)
    best_face = np.zeros(N, int)
    best_uv = np.zeros((N, 2))
    face = 0
    for axis in range(3):
        for side in range(2):
            bound = ROOM[axis, side]
            d = dirs[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (bound - eye[axis]) / d
            t = np.where(np.abs(d) < 1e-12, np.inf, t)
            # inf * 0 rays (parallel to the face) are masked below; keep
            # the arithmetic finite so numpy stays quiet
            with np.errstate(invalid="ignore"):
                pt = eye[None, :] + t[:, None] * dirs
            oa = [a for a in range(3) if a != axis]
            inside = (
                (t > 1e-6)
                & (pt[:, oa[0]] >= ROOM[oa[0], 0] - 1e-6) & (pt[:, oa[0]] <= ROOM[oa[0], 1] + 1e-6)
                & (pt[:, oa[1]] >= ROOM[oa[1], 0] - 1e-6) & (pt[:, oa[1]] <= ROOM[oa[1], 1] + 1e-6)
            )
            better = inside & (t < best_t)
            best_t = np.where(better, t, best_t)
            best_face = np.where(better, face, best_face)
            u = (pt[:, oa[0]] - ROOM[oa[0], 0]) / (ROOM[oa[0], 1] - ROOM[oa[0], 0])
            v = (pt[:, oa[1]] - ROOM[oa[1], 0]) / (ROOM[oa[1], 1] - ROOM[oa[1], 0])
            best_uv[better] = np.stack([u, v], -1)[better]
            face += 1
    img = tex.sample(best_face, np.clip(best_uv[:, 0], 0, 1), np.clip(best_uv[:, 1], 0, 1))
    img = img.reshape(height, width)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
    return img.astype(np.float32)


def arc_poses(n, radius=1.5, arc_deg=120.0, target_dist=6.0):
    """Orbit poses (rotation-dominant — useful as a degenerate-geometry case)."""
    poses = []
    for a in np.deg2rad(np.linspace(0, arc_deg, n)):
        eye = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), radius * np.cos(a) - 2.0])
        target = np.array([target_dist * np.sin(a), 0.0, target_dist * np.cos(a) - 2.0])
        R, t = look_at(eye, target)
        poses.append((R, t, eye))
    return poses


def walk_poses(n, heading_deg=25.0):
    """Walkthrough poses: translate across the room with gentle heading drift.

    Translation-dominant motion (the geometry SfM needs): ~0.5m steps with
    walls 3-8m away gives several degrees of parallax per frame.
    """
    poses = []
    s = np.linspace(0.0, 1.0, n)
    for i, si in enumerate(s):
        eye = np.array([-3.0 + 6.0 * si, 0.2 * np.sin(6 * si), -3.0 + 2.0 * si])
        yaw = np.deg2rad(heading_deg + 20.0 * si)
        d = np.array([np.sin(yaw), 0.12 * np.sin(4 * si), np.cos(yaw)])
        R, t = look_at(eye, eye + 5.0 * d)
        poses.append((R, t, eye))
    return poses


# ---------------------------------------------------------------------------
# Multi-room corridor: K textured rooms connected by doorways.
#
# The single box room caps the landmark pool at ~600 points that every
# camera covisits — which is what pinned the block-BA halo fraction at
# ~0.57 in the config-4 proofs.  A corridor distributes structure along the
# trajectory (each room has its own textures), so map partitioning, loop
# windows and retrieval see REAL spatial locality.
# ---------------------------------------------------------------------------


class Corridor:
    """Axis-aligned textured rectangles forming n_rooms connected rooms.

    Rooms are 10(x) x 5(y) x room_len(z), in a row along +z; dividing
    walls carry a centered floor-to-1.0 doorway (x in [-1.2, 1.2]).
    """

    def __init__(self, n_rooms=4, seed=0, room_len=8.0, res=96, octaves=4):
        self.n_rooms = n_rooms
        self.room_len = room_len
        self.z0 = 0.0
        X, Y = 5.0, 2.5
        rects = []  # (axis, coord, ua, u0, u1, va, v0, v1)

        def add(axis, coord, ua, u0, u1, va, v0, v1):
            rects.append((axis, float(coord), ua, float(u0), float(u1),
                          va, float(v0), float(v1)))

        for r in range(n_rooms):
            za, zb = r * room_len, (r + 1) * room_len
            add(1, -Y, 0, -X, X, 2, za, zb)      # floor
            add(1, +Y, 0, -X, X, 2, za, zb)      # ceiling
            add(0, -X, 1, -Y, Y, 2, za, zb)      # left wall
            add(0, +X, 1, -Y, Y, 2, za, zb)      # right wall
        add(2, 0.0, 0, -X, X, 1, -Y, Y)          # near end wall
        add(2, n_rooms * room_len, 0, -X, X, 1, -Y, Y)  # far end wall
        dx, dy = 1.2, 1.0                         # doorway half-width / top
        for r in range(1, n_rooms):
            z = r * room_len
            add(2, z, 0, -X, -dx, 1, -Y, Y)      # left of door
            add(2, z, 0, dx, X, 1, -Y, Y)        # right of door
            add(2, z, 0, -dx, dx, 1, dy, Y)      # above door
        self.rects = rects
        rng = np.random.default_rng(seed)
        n_tex = len(rects)
        self.grids = [rng.standard_normal(
            (n_tex, res // (2 ** o) + 2, res // (2 ** o) + 2))
            for o in range(octaves)]

    def sample(self, tid, u, v):
        out = np.zeros_like(u)
        for o, g in enumerate(self.grids):
            n = g.shape[1] - 2
            x = u * n
            y = v * n
            x0 = np.clip(x.astype(int), 0, n - 1)
            y0 = np.clip(y.astype(int), 0, n - 1)
            fx = x - x0
            fy = y - y0
            fx = fx * fx * (3 - 2 * fx)
            fy = fy * fy * (3 - 2 * fy)
            val = (g[tid, y0, x0] * (1 - fx) * (1 - fy)
                   + g[tid, y0, x0 + 1] * fx * (1 - fy)
                   + g[tid, y0 + 1, x0] * (1 - fx) * fy
                   + g[tid, y0 + 1, x0 + 1] * fx * fy)
            out += val * (1.5 ** o)
        return out


def render_corridor(cor: Corridor, R, eye, width=320, height=240,
                    focal=280.0):
    """Ray-cast the corridor's rectangle set (nearest hit wins)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    xn = (xs - width / 2) / focal
    yn = (ys - height / 2) / focal
    dirs = np.stack([xn, yn, np.ones_like(xn)], -1).reshape(-1, 3) @ R
    N = dirs.shape[0]
    best_t = np.full(N, np.inf)
    best_tid = np.zeros(N, int)
    best_uv = np.zeros((N, 2))
    for tid, (axis, coord, ua, u0, u1, va, v0, v1) in enumerate(cor.rects):
        d = dirs[:, axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (coord - eye[axis]) / d
        t = np.where(np.abs(d) < 1e-12, np.inf, t)
        with np.errstate(invalid="ignore"):
            pu = eye[ua] + t * dirs[:, ua]
            pv = eye[va] + t * dirs[:, va]
        inside = ((t > 1e-6) & (pu >= u0 - 1e-6) & (pu <= u1 + 1e-6)
                  & (pv >= v0 - 1e-6) & (pv <= v1 + 1e-6))
        better = inside & (t < best_t)
        best_t = np.where(better, t, best_t)
        best_tid = np.where(better, tid, best_tid)
        u = (pu - u0) / max(u1 - u0, 1e-9)
        v = (pv - v0) / max(v1 - v0, 1e-9)
        best_uv[better] = np.stack([u, v], -1)[better]
    img = cor.sample(best_tid, np.clip(best_uv[:, 0], 0, 1),
                     np.clip(best_uv[:, 1], 0, 1))
    img = img.reshape(height, width)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
    return img.astype(np.float32)


def corridor_walk_poses(cor: Corridor, n):
    """Walk the corridor's length through the doorways, yaw sweeping so the
    walls (not just the far door) carry parallax."""
    L = cor.n_rooms * cor.room_len
    poses = []
    s = np.linspace(0.02, 0.98, n)
    for si in s:
        z = L * si
        eye = np.array([0.9 * np.sin(2.5 * np.pi * si) * 0.8,
                        0.15 * np.sin(11 * si), z])
        yaw = np.deg2rad(35.0 * np.sin(2 * np.pi * 1.7 * si))
        d = np.array([np.sin(yaw), 0.1 * np.sin(5 * si), np.cos(yaw)])
        R, t = look_at(eye, eye + 4.0 * d)
        poses.append((R, t, eye))
    return poses


# ---------------------------------------------------------------------------
# Parallel rendering (config-4/5 scale proofs render thousands of frames;
# single-threaded ray-casting is ~0.17 s/frame at 12 rooms = 14 min for 5k)
# ---------------------------------------------------------------------------

_PAR_CTX = {}


def _par_render_init(scene: str, rooms: int, seed: int):
    if scene == "corridor":
        _PAR_CTX["obj"] = Corridor(n_rooms=rooms, seed=seed)
    else:
        _PAR_CTX["obj"] = RoomTexture(seed=seed)
    _PAR_CTX["scene"] = scene


def _par_render_save(task):
    i, R, eye, outdir, width, height, focal = task
    from PIL import Image

    if _PAR_CTX["scene"] == "corridor":
        img = render_corridor(_PAR_CTX["obj"], R, eye, width, height, focal)
    else:
        img = render_room(_PAR_CTX["obj"], R, eye, width, height, focal)
    Image.fromarray((img * 255).astype(np.uint8)).save(
        f"{outdir}/{i:05d}.png")
    return i


def render_walk_parallel(scene: str, rooms: int, poses, outdir,
                         workers: int = 12, width: int = 320,
                         height: int = 240, focal: float = 280.0,
                         seed: int = 7):
    """Render+save a pose list with a spawn-based process pool.

    spawn (not fork): the caller usually holds a live device client, which
    a forked child must never inherit (one process per device).
    """
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    tasks = [(i, R, eye, str(outdir), width, height, focal)
             for i, (R, t, eye) in enumerate(poses)]
    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx,
                             initializer=_par_render_init,
                             initargs=(scene, rooms, seed)) as ex:
        list(ex.map(_par_render_save, tasks, chunksize=16))
