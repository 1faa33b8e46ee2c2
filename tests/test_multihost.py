"""Multi-host bootstrap (SURVEY §4.2.4/§5.8): 2 processes over loopback.

Exercises jax.distributed.initialize + the obs-sharded BA collectives across
process boundaries — the code path configs 4-5 use across real hosts.  Runs
two CPU subprocesses (4 virtual devices each -> an 8-device global mesh).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORKER = textwrap.dedent("""
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1])
    jax.distributed.initialize(coordinator_address="localhost:12421",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sfmx.dist import dist_ba, mesh as meshlib
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.device_count() == 8, jax.device_count()
    assert jax.process_count() == 2

    mesh = meshlib.make_mesh("obs")
    rng = np.random.default_rng(0)
    C, Pn, O = 6, 48, 64
    intr = jnp.asarray([[100.0, 100.0, 32.0, 24.0, 0, 0, 0]], jnp.float32)
    k_idx = jnp.zeros(C, jnp.int32)
    X = jnp.asarray(rng.uniform(-1, 1, (Pn, 3)), jnp.float32)
    R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (C, 3, 3))
    t = jnp.asarray(np.concatenate([rng.uniform(-0.2, 0.2, (C, 2)),
                                    np.full((C, 1), 4.0)], 1), jnp.float32)
    cam_id = rng.integers(0, C, O).astype(np.int32)
    pt_id = rng.integers(0, Pn, O).astype(np.int32)
    Xc = np.asarray(X)[pt_id] + np.asarray(t)[cam_id]
    uv = (Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0])
    w = np.ones(O, np.float32)
    fixed = jnp.zeros(C, bool).at[0].set(True)

    sh = NamedSharding(mesh, P("obs"))
    def put(x):
        x = jnp.asarray(x)
        return jax.make_array_from_process_local_data(sh, np.asarray(x))
    cam_id_s, pt_id_s = put(cam_id), put(pt_id)
    uv_s, w_s = put(uv.astype(np.float32)), put(w)

    step = dist_ba.make_ba_step(mesh, iters=2, cg_iters=5)
    R1, t1, X1, costs = step(intr, k_idx, R, t, X, cam_id_s, pt_id_s, uv_s, w_s, fixed)
    costs = np.asarray(costs)
    assert np.isfinite(costs).all(), costs
    assert costs[-1] <= costs[0] * 1.01, costs
    print(f"proc {pid} OK costs={costs.tolist()}")
""")


def _run_two_procs(tmp_path, worker_src, name):
    script = tmp_path / name
    script.write_text(worker_src)
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    })
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out
    return outs


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    _run_two_procs(tmp_path, WORKER, "worker.py")


# Point-sharded block BA across a REAL process boundary: the halo
# all_gather and ring reduce-scatter cross processes here — exactly the
# collectives DCN would carry at configs 4-5 (SURVEY §5.7/§5.8).
BLOCK_WORKER = textwrap.dedent("""
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1])
    jax.distributed.initialize(coordinator_address="localhost:12422",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sfmx.dist import block_ba, mesh as meshlib
    from sfmx.dist.block_layout import (build_block_layout, gather_cams,
                                        gather_pts, scatter_cams, scatter_pts)
    from sfmx.solvers import lm
    from tests.test_block_ba import _corridor

    assert jax.device_count() == 8 and jax.process_count() == 2
    mesh = meshlib.make_mesh(block_ba.AXIS)

    intr, R, t, X, cam_id, pt_id, uv, w = _corridor(C=32, P=800, obs_per_cam=40)
    C, Pn = len(R), len(X)
    rng = np.random.default_rng(5)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    t0 = t + 0.02 * rng.standard_normal(t.shape).astype(np.float32)
    fixed = np.zeros(C, bool); fixed[0] = True

    # every process builds the SAME layout from the same global arrays
    lay = build_block_layout(cam_id, pt_id, uv, w, C, Pn, 8)
    k_l, R_l, t_l, fixed_l = scatter_cams(lay, np.zeros(C, np.int32), R, t0, fixed)
    fixed_l = fixed_l | (lay.cam_global < 0)
    (X_l,) = scatter_pts(lay, X0)

    sh = NamedSharding(mesh, P(block_ba.AXIS))
    def put(a):
        # each process contributes its 4 local blocks' rows
        a = np.asarray(a)
        n = a.shape[0] // 2
        return jax.make_array_from_process_local_data(
            sh, a[pid * n:(pid + 1) * n])
    args = tuple(put(a) for a in (
        k_l, R_l, t_l, X_l, fixed_l, lay.obs_cam_l, lay.obs_pt_ext,
        lay.obs_uv, lay.obs_w, lay.halo_idx, lay.halo_mask))

    step = block_ba.make_block_ba_step(mesh, n_blocks=8, hcap=lay.hcap,
                                       iters=6, cg_iters=20)
    R_s, t_s, X_s, costs, lam = step(
        jnp.asarray(intr), jnp.asarray(1e-4, jnp.float32), *args)
    costs = np.asarray(jax.device_get(costs))
    assert np.isfinite(costs).all(), costs
    assert costs[-1] < costs[0] * 0.1, costs

    # parity vs the single-process replicated solver (local jit, no mesh)
    _, _, _, costs_ref = lm.ba_solve(
        jnp.asarray(intr), jnp.zeros(C, jnp.int32), jnp.asarray(R),
        jnp.asarray(t0), jnp.asarray(X0), jnp.asarray(cam_id),
        jnp.asarray(pt_id), jnp.asarray(uv), jnp.asarray(w),
        jnp.asarray(fixed), iters=6, cg_iters=20)
    ref = float(np.asarray(costs_ref)[-1])
    assert abs(float(costs[-1]) - ref) <= 0.05 * abs(ref), (costs[-1], ref)
    print(f"proc {pid} OK costs={costs.tolist()}")
""")


@pytest.mark.slow
def test_two_process_block_ba_parity(tmp_path):
    """The point-sharded solve (halo all_gather + ring reduce-scatter)
    crosses a process boundary and matches the replicated solver."""
    _run_two_procs(tmp_path, BLOCK_WORKER, "block_worker.py")
