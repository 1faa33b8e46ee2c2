"""Golden tests for triangulation, Umeyama, epipolar, PnP, RANSAC (SURVEY §4.2.1)."""
import jax
import jax.numpy as jnp
import numpy as np

from sfmx.core import cameras
from sfmx.solvers import epipolar, pnp, ransac, triangulate, umeyama

from .synthetic import make_scene


def _normalized(sc, c):
    Xc = sc.points @ sc.Rs[c].T + sc.ts[c]
    return (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)


def test_two_view_triangulation_exact():
    sc = make_scene(n_cams=2, n_points=120)
    xn1, xn2 = _normalized(sc, 0), _normalized(sc, 1)
    X, ok = triangulate.triangulate_two_view(
        jnp.asarray(sc.Rs[0], jnp.float32), jnp.asarray(sc.ts[0], jnp.float32),
        jnp.asarray(sc.Rs[1], jnp.float32), jnp.asarray(sc.ts[1], jnp.float32),
        jnp.asarray(xn1), jnp.asarray(xn2),
    )
    vis = sc.visible[0] & sc.visible[1]
    assert np.all(np.asarray(ok)[vis])
    np.testing.assert_allclose(np.asarray(X)[vis], sc.points[vis], atol=5e-2)


def test_nview_triangulation_masked():
    sc = make_scene(n_cams=6, n_points=60)
    V = 6
    Ps = np.concatenate([sc.Rs, sc.ts[:, :, None]], axis=2).astype(np.float32)  # (6,3,4)
    xns = np.stack([_normalized(sc, c) for c in range(V)], axis=1)  # (P,V,2)
    mask = sc.visible.T.copy()  # (P,V)
    mask[:, 3] = False  # drop one view entirely; must still work
    Ps_b = np.broadcast_to(Ps, (sc.points.shape[0], V, 3, 4))
    X, ok = triangulate.triangulate_nview_b(
        jnp.asarray(Ps_b), jnp.asarray(xns), jnp.asarray(mask)
    )
    good = np.asarray(ok) & (mask.sum(1) >= 2)
    np.testing.assert_allclose(np.asarray(X)[good], sc.points[good], atol=5e-2)


def test_umeyama_recovers_similarity(rng):
    src = rng.normal(size=(50, 3)).astype(np.float32)
    from scipy.spatial.transform import Rotation as Rsc
    R_true = Rsc.random(rng=3).as_matrix()
    s_true, t_true = 2.5, np.array([1.0, -2.0, 0.5])
    dst = (s_true * (src @ R_true.T) + t_true).astype(np.float32)
    s, R, t = umeyama.umeyama(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(float(s), s_true, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-3)


def test_umeyama_masked_ignores_outliers(rng):
    src = rng.normal(size=(50, 3)).astype(np.float32)
    dst = (src * 1.5 + np.array([1, 2, 3])).astype(np.float32)
    dst[:5] += 100.0  # outliers
    mask = np.ones(50, bool)
    mask[:5] = False
    s, R, t = umeyama.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    np.testing.assert_allclose(float(s), 1.5, rtol=1e-4)


def test_ate_rmse_zero_for_identical():
    sc = make_scene(n_cams=8)
    c = sc.centers.astype(np.float32)
    rmse, _ = umeyama.ate_rmse(jnp.asarray(c), jnp.asarray(c * 2.0 + 1.0))
    assert float(rmse) < 1e-4


def test_eight_point_essential_and_pose():
    sc = make_scene(n_cams=2, n_points=200)
    xn1, xn2 = _normalized(sc, 0), _normalized(sc, 1)
    vis = sc.visible[0] & sc.visible[1]
    E = epipolar.eight_point(jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(vis), essential=True)
    errs = epipolar.sampson_error(E, jnp.asarray(xn1), jnp.asarray(xn2))
    assert float(np.median(np.asarray(errs)[vis])) < 1e-8

    R, t, count, _ = epipolar.relative_pose_from_essential(
        E, jnp.asarray(xn1), jnp.asarray(xn2), jnp.asarray(vis)
    )
    # Ground-truth relative pose cam1->cam2.
    R_rel = sc.Rs[1] @ sc.Rs[0].T
    t_rel = sc.ts[1] - R_rel @ sc.ts[0]
    t_rel = t_rel / np.linalg.norm(t_rel)
    np.testing.assert_allclose(np.asarray(R), R_rel, atol=1e-3)
    np.testing.assert_allclose(np.asarray(t), t_rel, atol=1e-3)
    assert int(count) >= vis.sum() - 2


def test_dlt_pnp_exact():
    sc = make_scene(n_cams=3, n_points=100)
    c = 2
    xn = _normalized(sc, c)
    vis = sc.visible[c]
    R, t = pnp.dlt_pnp(jnp.asarray(xn), jnp.asarray(sc.points, jnp.float32), jnp.asarray(vis))
    np.testing.assert_allclose(np.asarray(R), sc.Rs[c], atol=1e-3)
    np.testing.assert_allclose(np.asarray(t), sc.ts[c], atol=1e-3)


def test_pnp_ransac_with_outliers(rng):
    sc = make_scene(n_cams=3, n_points=256)
    c = 1
    xn = _normalized(sc, c).copy()
    n = xn.shape[0]
    outl = rng.random(n) < 0.35
    xn[outl] += rng.normal(scale=0.3, size=(outl.sum(), 2))
    X = sc.points.astype(np.float32)
    mask = sc.visible[c]

    def residual_fn(model, xn_d, X_d):
        R, t = model
        r = pnp.pnp_residual(R, t, xn_d, X_d)
        return jnp.sum(r * r, axis=-1)

    (R, t), inliers, cnt = ransac.ransac(
        jax.random.PRNGKey(0),
        pnp.dlt_pnp_minimal,
        residual_fn,
        (jnp.asarray(xn), jnp.asarray(X)),
        jnp.asarray(mask),
        k_hypotheses=512,
        sample_size=pnp.MIN_SAMPLE,
        inlier_threshold=(2.0 / 520.0) ** 2,
    )
    R, t = pnp.refine_pnp_gn(R, t, jnp.asarray(xn), jnp.asarray(X), inliers)
    np.testing.assert_allclose(np.asarray(R), sc.Rs[c], atol=5e-3)
    np.testing.assert_allclose(np.asarray(t), sc.ts[c], atol=2e-2)
    # Inliers found should be ~ the non-outlier visible set.
    assert int(cnt) > 0.8 * (mask & ~outl).sum()


def test_ransac_sampling_valid_and_distinct():
    mask = np.zeros(100, bool)
    mask[10:30] = True
    idx = ransac.sample_minimal(jax.random.PRNGKey(1), jnp.asarray(mask), 64, 6)
    idx = np.asarray(idx)
    assert idx.shape == (64, 6)
    assert np.all((idx >= 10) & (idx < 30))
    for row in idx:
        assert len(set(row.tolist())) == 6


def test_inv_spd6_blocked_matches_lu():
    """Blocked 3x3-Schur 6x6 SPD inverse == LU inverse (PCG preconditioner
    path)."""
    import numpy as np
    import jax.numpy as jnp

    from sfmx.solvers.schur import _inv_spd6

    rng = np.random.default_rng(5)
    A = rng.standard_normal((64, 6, 6)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    ref = np.linalg.inv(M)
    out = np.asarray(_inv_spd6(jnp.asarray(M)))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
