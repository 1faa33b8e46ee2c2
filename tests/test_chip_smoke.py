"""chip_smoke.py's phases at tiny sizes on the CPU.

The same functions run at full size on the GPU; here they prove the control
flow, the gates and the references.  The multi-device phases run on the
suite's 8 virtual CPU devices.
"""
import dataclasses

import numpy as np
import pytest

import chip_smoke as cs

N_Q = 4


@pytest.fixture(scope="module")
def ctx():
    ok, c = cs.phase_build(20, max_keypoints=256, pair_chunk=64)
    lc = dataclasses.replace(c["cfg"].localize, streaming_min_landmarks=4096)
    c["cfg"] = dataclasses.replace(c["cfg"], localize=lc)
    c.update(n_queries=N_Q, max_batch=N_Q, build_ok=ok)
    return c


def test_chip_smoke_build_phase(ctx):
    assert ctx["build_ok"]
    assert ctx["lmap"].X.shape[0] > 100


def test_chip_smoke_serve_gather_phase(ctx):
    ok, sc = cs.phase_serve_gather(ctx, min_good=N_Q - 1)
    assert ok
    assert sc["err_m"].shape == (N_Q,)


def test_chip_smoke_serve_streaming_phase(ctx):
    ok, sc = cs.phase_serve_streaming(ctx, min_good=N_Q - 1, pool_size=8192,
                                      require_kernel=False)
    assert ok
    assert ctx["padded"].X.shape[0] == 8192


def test_chip_smoke_ba_phase():
    assert cs.phase_ba(C=32, P=800, O=8000, iters=10)


def test_chip_smoke_multi_device_phases(ctx):
    """The --chips 4 phases on virtual devices: router, sharded pool and
    block BA, each against its one-device answer."""
    ok, single = cs.phase_serve_streaming(ctx, min_good=N_Q - 1,
                                          pool_size=8192,
                                          require_kernel=False)
    assert ok
    assert cs.phase_router(ctx, single, min_good=N_Q - 1)
    assert cs.phase_sharded_localize(ctx)
    assert cs.phase_block_ba(C=32, P=800, O=8000, iters=10)


def test_ba_problem_is_camera_local():
    args, caps = cs.ba_problem(C=40, P=500, O=4000)
    cam_id, pt_id = np.asarray(args[5]), np.asarray(args[6])
    assert np.all(np.diff(pt_id) >= 0)
    assert caps["tp_cap"] >= np.bincount(pt_id).max()
    assert caps["tc_cap"] >= np.bincount(cam_id).max()
