"""Point-sharded block BA on a RECONSTRUCTED scene.

Loads a scene produced by `sfmx build-map`, partitions its real
covisibility structure over every device JAX sees, and runs the
point-sharded distributed solve (dist/block_ba.py).  Prints one JSON line:
halo fraction, per-block load balance, LM cost trajectory.

  python bench_scripts/block_ba_real_scene.py /path/to/map [--iters 4]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def solve_scene(map_path: str, iters: int = 4, cg_iters: int = 15) -> dict:
    from sfmx.dist import block_ba, mesh as meshlib
    from sfmx.mapstore import load_scene

    scene = load_scene(map_path)
    alive = np.asarray(scene.obs_alive)
    cam_id = np.asarray(scene.obs_cam)[alive]
    pt_id = np.asarray(scene.obs_pt)[alive]
    uv = np.asarray(scene.obs_uv)[alive]
    P = int(np.asarray(scene.X).shape[0])
    w = np.ones(len(cam_id), np.float32)
    registered = np.asarray(scene.cam_alive)
    fixed = ~registered
    fixed[np.flatnonzero(registered)[0]] = True

    mesh = meshlib.make_mesh(block_ba.AXIS)
    t0 = time.time()
    R2, t2, X2, costs, stats = block_ba.ba_solve_blocked(
        np.asarray(scene.intr), np.asarray(scene.cam_k),
        np.asarray(scene.cam_R), np.asarray(scene.cam_t), np.asarray(scene.X),
        cam_id, pt_id, uv, w, fixed, mesh, iters=iters, cg_iters=cg_iters)
    wall = time.time() - t0
    costs = np.asarray(costs)
    return {
        "map": map_path, "n_cams": int(registered.sum()), "n_pts": P,
        "n_obs": int(len(cam_id)), "n_blocks": int(np.prod(mesh.devices.shape)),
        **stats,
        "cost0": float(costs[0]), "cost_final": float(costs[-1]),
        "cost_monotone_ok": bool(costs[-1] <= costs[0]),
        "wall_s": round(wall, 1),
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("map_path")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cg-iters", type=int, default=15)
    p.add_argument("--platform", default=None)
    a = p.parse_args()
    import jax

    if a.platform:
        jax.config.update("jax_platforms", a.platform)
    from sfmx.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(solve_scene(a.map_path, a.iters, a.cg_iters)))
