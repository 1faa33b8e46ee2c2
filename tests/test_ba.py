"""BA tests: Schur system vs dense oracle; LM convergence on noisy scenes."""
import jax
import jax.numpy as jnp
import numpy as np

from sfmx.solvers import lm, schur

from .synthetic import make_scene


def build_obs_table(sc, noise_px=0.0, pad_obs=0):
    """Flatten a synthetic scene's visibility into the (O,) observation table."""
    C, P = sc.visible.shape
    cam_id, pt_id, uv = [], [], []
    for c in range(C):
        idx = np.where(sc.visible[c])[0]
        cam_id.append(np.full(len(idx), c))
        pt_id.append(idx)
        uv.append(sc.uv[c][idx])
    cam_id = np.concatenate(cam_id).astype(np.int32)
    pt_id = np.concatenate(pt_id).astype(np.int32)
    uv = np.concatenate(uv).astype(np.float32)
    w = np.ones(len(cam_id), np.float32)
    if pad_obs:
        cam_id = np.concatenate([cam_id, np.zeros(pad_obs, np.int32)])
        pt_id = np.concatenate([pt_id, np.zeros(pad_obs, np.int32)])
        uv = np.concatenate([uv, np.zeros((pad_obs, 2), np.float32)])
        w = np.concatenate([w, np.zeros(pad_obs, np.float32)])
    return cam_id, pt_id, uv, w


def _dense_schur_oracle(Jc, Jp, r, w, cam_id, pt_id, C, P, lam):
    """Materialize full H/b in numpy f64 and Schur-eliminate — exact oracle."""
    O = len(cam_id)
    nC, nP = 6 * C, 3 * P
    H = np.zeros((nC + nP, nC + nP))
    b = np.zeros(nC + nP)
    for o in range(O):
        if w[o] == 0:
            continue
        J = np.zeros((2, nC + nP))
        J[:, 6 * cam_id[o]:6 * cam_id[o] + 6] = Jc[o]
        J[:, nC + 3 * pt_id[o]:nC + 3 * pt_id[o] + 3] = Jp[o]
        H += w[o] * J.T @ J
        b += -w[o] * J.T @ r[o]
    # damping (matches schur._damp: lam * diag, multiplicative)
    H[np.arange(nC + nP), np.arange(nC + nP)] += lam * np.diag(H) + 1e-10
    A = H[:nC, :nC]
    Bm = H[:nC, nC:]
    D = H[nC:, nC:]
    Dinv = np.linalg.inv(D + 1e-8 * np.eye(nP))
    S = A - Bm @ Dinv @ Bm.T
    b_red = b[:nC] - Bm @ Dinv @ b[nC:]
    return S, b_red, Dinv, b


def test_schur_matvec_matches_dense_oracle(rng):
    sc = make_scene(n_cams=4, n_points=30, noise_px=0.5)
    cam_id, pt_id, uv, w = build_obs_table(sc, pad_obs=7)
    C, P = 4, 30
    intr = jnp.asarray(sc.intrinsics, jnp.float32)[None]
    k_idx = jnp.zeros(C, jnp.int32)
    R = jnp.asarray(sc.Rs, jnp.float32)
    t = jnp.asarray(sc.ts, jnp.float32)
    X = jnp.asarray(sc.points, jnp.float32)

    r, Jc, Jp = lm._jacobians(intr, k_idx, R, t, X, cam_id, pt_id, jnp.asarray(uv))
    lam = 1e-3
    nb = schur.assemble(Jc, Jp, r, jnp.asarray(w), cam_id, pt_id, C, P)
    sys = schur.reduce_system(nb, jnp.asarray(lam, jnp.float32))

    S, b_red, _, _ = _dense_schur_oracle(
        np.asarray(Jc, np.float64), np.asarray(Jp, np.float64), np.asarray(r, np.float64),
        w, cam_id, pt_id, C, P, lam,
    )
    # f32 assembly cancels large near-equal terms (SURVEY §7.4): compare at the
    # vector-norm level, ~1% is the expected f32 agreement with the f64 oracle.
    def rel(a, b):
        return np.linalg.norm(np.asarray(a).ravel() - b.ravel()) / max(np.linalg.norm(b), 1e-12)

    assert rel(sys.b_red, b_red) < 0.02
    v = rng.normal(size=(C, 6)).astype(np.float32)
    Sv = np.asarray(schur.schur_matvec(sys, jnp.asarray(v)))
    Sv_ref = (S @ v.ravel()).reshape(C, 6)
    assert rel(Sv, Sv_ref) < 0.02


def test_pcg_solves_reduced_system(rng):
    sc = make_scene(n_cams=5, n_points=40, noise_px=0.3)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    C, P = 5, 40
    intr = jnp.asarray(sc.intrinsics, jnp.float32)[None]
    k_idx = jnp.zeros(C, jnp.int32)
    r, Jc, Jp = lm._jacobians(
        intr, k_idx, jnp.asarray(sc.Rs, jnp.float32), jnp.asarray(sc.ts, jnp.float32),
        jnp.asarray(sc.points, jnp.float32), cam_id, pt_id, jnp.asarray(uv),
    )
    nb = schur.assemble(Jc, Jp, r, jnp.asarray(w), cam_id, pt_id, C, P)
    sys = schur.reduce_system(nb, jnp.asarray(1e-2, jnp.float32))
    fixed = jnp.zeros(C, bool).at[0].set(True)
    x, rnorm = schur.pcg(sys, iters=60, fixed_cam_mask=fixed)
    # Residual of the projected system should be tiny relative to RHS.
    b = np.asarray(jnp.where(fixed[:, None], 0.0, sys.b_red))
    assert float(rnorm) < 1e-3 * max(np.linalg.norm(b), 1.0)
    assert np.allclose(np.asarray(x)[0], 0.0)


def test_ba_converges_from_perturbed_scene(rng):
    sc = make_scene(n_cams=6, n_points=80, noise_px=0.0)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    C, P = 6, 80
    intr = jnp.asarray(sc.intrinsics, jnp.float32)[None]
    k_idx = jnp.zeros(C, jnp.int32)

    # Perturb ground truth.
    from sfmx.core import se3
    key = jax.random.PRNGKey(0)
    dR = se3.so3_exp_b(0.01 * jax.random.normal(key, (C, 3)))
    R0 = jnp.einsum("cij,cjk->cik", dR, jnp.asarray(sc.Rs, jnp.float32))
    t0 = jnp.asarray(sc.ts, jnp.float32) + 0.02 * jax.random.normal(key, (C, 3))
    X0 = jnp.asarray(sc.points, jnp.float32) + 0.03 * jax.random.normal(key, (P, 3))

    fixed = jnp.zeros(C, bool).at[0].set(True)
    rmse0 = lm.reprojection_rmse(intr, k_idx, R0, t0, X0, cam_id, pt_id, jnp.asarray(uv), jnp.asarray(w))
    R1, t1, X1, costs = lm.ba_solve(
        intr, k_idx, R0, t0, X0, cam_id, pt_id, jnp.asarray(uv), jnp.asarray(w),
        fixed, iters=25, cg_iters=40,
    )
    rmse1 = lm.reprojection_rmse(intr, k_idx, R1, t1, X1, cam_id, pt_id, jnp.asarray(uv), jnp.asarray(w))
    assert float(rmse0) > 1.0          # the perturbation was material
    assert float(rmse1) < 0.05         # noiseless scene -> near-zero residual
    assert float(costs[-1]) < float(costs[0]) * 1e-4


def test_ba_noise_floor(rng):
    noise = 0.5
    sc = make_scene(n_cams=6, n_points=80, noise_px=noise)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    C, P = 6, 80
    intr = jnp.asarray(sc.intrinsics, jnp.float32)[None]
    k_idx = jnp.zeros(C, jnp.int32)
    fixed = jnp.zeros(C, bool).at[0].set(True)
    R1, t1, X1, costs = lm.ba_solve(
        intr, k_idx,
        jnp.asarray(sc.Rs, jnp.float32), jnp.asarray(sc.ts, jnp.float32),
        jnp.asarray(sc.points, jnp.float32),
        cam_id, pt_id, jnp.asarray(uv), jnp.asarray(w), fixed,
        iters=15, cg_iters=40,
    )
    rmse = lm.reprojection_rmse(intr, k_idx, R1, t1, X1, cam_id, pt_id, jnp.asarray(uv), jnp.asarray(w))
    # Optimum RMSE should be at the noise floor (not above ~1.2x noise).
    assert float(rmse) < 1.2 * noise


def test_planes_pipeline_parity():
    """Analytic planes Jacobians + planes Schur path == jacfwd/einsum path."""
    import jax
    import jax.numpy as jnp

    from sfmx.core import se3
    from sfmx.solvers import lm

    rng = np.random.default_rng(3)
    C, P, O = 6, 60, 400
    intr = jnp.asarray([[300.0, 310.0, 160, 120, -0.05, 0.01, 0.0]], jnp.float32)
    k_idx = jnp.zeros(C, jnp.int32)
    R = jnp.stack([se3.so3_exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32))
                   for _ in range(C)])
    t = jnp.asarray(rng.normal(0, 0.5, (C, 3)), jnp.float32) + jnp.asarray([0, 0, 6.0])
    X = jnp.asarray(rng.uniform(-2, 2, (P, 3)), jnp.float32)
    cam_id = jnp.asarray(rng.integers(0, C, O), jnp.int32)
    pt_id = jnp.asarray(rng.integers(0, P, O), jnp.int32)
    Xc = X[pt_id] + t[cam_id]
    uv = jnp.einsum("oij,oj->oi", R[cam_id], X[pt_id])
    Xcam = uv + t[cam_id]
    proj = Xcam[:, :2] / Xcam[:, 2:3] * 300.0 + jnp.asarray([160.0, 120.0])
    proj = proj + 0.5 * jnp.asarray(rng.normal(0, 1, (O, 2)), jnp.float32)
    w = jnp.ones(O, jnp.float32)
    fixed = jnp.zeros(C, bool).at[0].set(True)

    # jacobian parity
    r0, Jc0, Jp0 = lm._jacobians(intr, k_idx, R, t, X, cam_id, pt_id, proj)
    r1, Jc1, Jp1 = lm._jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, proj)
    np.testing.assert_allclose(np.asarray(r0), np.asarray(r1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(Jc0).reshape(O, 12), np.asarray(Jc1),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jp0).reshape(O, 6), np.asarray(Jp1),
                               atol=1e-4)

    # full-solve parity: same final cost trajectory to tolerance
    outA = lm.ba_solve(intr, k_idx, R, t, X, cam_id, pt_id, proj, w, fixed,
                       iters=8, cg_iters=20)
    outB = lm.ba_solve(intr, k_idx, R, t, X, cam_id, pt_id, proj, w, fixed,
                       iters=8, cg_iters=20, tp_cap=32, tc_cap=128)
    cA, cB = np.asarray(outA[3]), np.asarray(outB[3])
    assert cB[-1] <= cA[0], "planes path failed to reduce cost"
    np.testing.assert_allclose(cA[-1], cB[-1], rtol=0.05)


def test_ba_solve_planes_einsum_parity_long_tracks():
    """Orbit scene whose tracks span every camera (the long-track scene the
    removed dense-layout path was tested on): the planes formulation with a
    track bound converges to the same optimum as the einsum formulation."""
    sc = make_scene(n_cams=8, n_points=120, noise_px=0.3)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    lens = np.bincount(np.asarray(pt_id), minlength=120)
    assert lens.max() > 4  # tracks really are long
    intr = jnp.asarray(sc.intrinsics, jnp.float32)[None]
    k_idx = jnp.zeros(8, jnp.int32)
    fixed = jnp.zeros(8, bool).at[0].set(True)
    rng = np.random.default_rng(2)
    R0 = jnp.asarray(sc.Rs, jnp.float32)
    t0 = jnp.asarray(sc.ts + 0.03 * rng.standard_normal((8, 3)), jnp.float32)
    X0 = jnp.asarray(sc.points + 0.03 * rng.standard_normal((120, 3)),
                     jnp.float32)
    args = (intr, k_idx, R0, t0, X0, cam_id, pt_id, jnp.asarray(uv),
            jnp.asarray(w), fixed)
    tp = 1 << int(lens.max() - 1).bit_length()
    tc = 1 << int(np.bincount(np.asarray(cam_id)).max() - 1).bit_length()
    _, _, _, costs_e = lm.ba_solve(*args, iters=8, cg_iters=25)
    _, _, _, costs_p = lm.ba_solve(*args, iters=8, cg_iters=25, tp_cap=tp,
                                   tc_cap=tc)
    assert float(costs_p[-1]) < float(costs_p[0]) * 0.1
    np.testing.assert_allclose(float(costs_p[-1]), float(costs_e[-1]),
                               rtol=0.02)
