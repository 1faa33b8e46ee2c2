"""P3P minimal solver: Grunert's quartic, branch-free for batched RANSAC.

Capability parity: the reference's localizer and OpenMVG's resection use
3-point minimal solvers (P3P) inside ``solvePnPRansac`` / ACRANSAC — the
minimal sample size is what makes RANSAC survive low inlier ratios: at
inlier ratio w the per-hypothesis success probability is w^3 for P3P vs
w^6 for the 6-point DLT (``pnp.dlt_pnp_minimal``), a 37x gap at w=0.3.

Design: the textbook P3P implementations are branchy (real-root
counting, per-root early exits).  Here everything is fixed-shape elementwise work:

- Grunert's quartic coefficients (Haralick et al. 1994 review) are computed
  per sample in f32;
- all four roots come from Ferrari's closed form evaluated in MANUAL
  complex arithmetic over (re, im) pairs — polar-form sqrt/cbrt built from
  hypot/atan2/cos/sin, no XLA complex dtypes anywhere — then each root's
  real part is polished by fixed-iteration Newton on the real quartic;
- every root yields a pose candidate via triad absolute orientation — for 3
  points the centered cross-covariance is rank-2, so instead of a
  Procrustes/SVD step the triangle's orthonormal frame is built in both
  coordinate systems (cross products + normalize only) and R maps one to
  the other exactly;
- complex-pair or degenerate roots produce finite garbage poses that simply
  score zero inliers — RANSAC's argmax is the selection mechanism, so no
  root-validity branching is ever needed.

Returns all 4 candidates per sample; ``ransac.ransac(n_candidates=4)``
flattens them into the hypothesis pool.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MIN_SAMPLE = 3
N_CANDIDATES = 4

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Manual complex arithmetic over (re, im) pairs — real ops only.
# ---------------------------------------------------------------------------


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv(a, b):
    d = jnp.maximum(b[0] * b[0] + b[1] * b[1], _EPS)
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _csqrt(a):
    """Principal square root via polar form."""
    r = jnp.hypot(a[0], a[1])
    th = jnp.arctan2(a[1], a[0])
    s = jnp.sqrt(r)
    return s * jnp.cos(0.5 * th), s * jnp.sin(0.5 * th)


def _ccbrt(a):
    """Principal cube root via polar form."""
    r = jnp.hypot(a[0], a[1])
    th = jnp.arctan2(a[1], a[0])
    s = jnp.cbrt(r)
    return s * jnp.cos(th / 3.0), s * jnp.sin(th / 3.0)


def quartic_roots(coeffs: jax.Array, polish_iters: int = 12) -> jax.Array:
    """Real parts of the 4 roots of a real quartic, Newton-polished.

    Args:
      coeffs: (5,) real coefficients, highest degree first.

    Ferrari's closed form gives all roots at once with no data-dependent
    control flow; f32 closed-form error is then removed by Newton iteration
    on the real polynomial (quadratic convergence near simple roots).
    Complex-conjugate pairs yield real parts that polish to wherever Newton
    drifts — downstream RANSAC scoring rejects the resulting poses, so no
    realness test is needed.
    """
    A4 = coeffs[0]
    # sign-preserving clamp: degenerate leading coefficient (measure-zero
    # configurations) must not produce inf/nan, just a wrong-but-finite root
    scale = jnp.max(jnp.abs(coeffs))
    A4s = jnp.where(jnp.abs(A4) < 1e-9 * scale,
                    jnp.where(A4 < 0, -1e-9, 1e-9) * scale, A4)
    a, b, c, d = coeffs[1] / A4s, coeffs[2] / A4s, coeffs[3] / A4s, coeffs[4] / A4s

    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - 0.5 * a * b + a * a * a / 8.0
    r = d - 0.25 * a * c + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    # resolvent cubic 8m^3 + 8p m^2 + (2p^2 - 8r) m - q^2 = 0
    # -> m^3 + P m^2 + Q m + S = 0
    P, Q, S = p, 0.25 * p * p - r, -q * q / 8.0
    # depressed cubic w^3 + pw*w + qw = 0, m = w - P/3
    pw = Q - P * P / 3.0
    qw = 2.0 * P ** 3 / 27.0 - P * Q / 3.0 + S
    disc = _csqrt((qw * qw / 4.0 + pw ** 3 / 27.0, jnp.zeros_like(qw)))
    u = _ccbrt((-0.5 * qw + disc[0], disc[1]))
    # w = u - pw/(3u); guard u ~ 0 (then w = cbrt(-qw))
    u_small = jnp.hypot(u[0], u[1]) < 1e-20
    u = (jnp.where(u_small, 1.0, u[0]), jnp.where(u_small, 0.0, u[1]))
    w = (u[0] - pw / 3.0 * _cdiv((1.0, 0.0), u)[0],
         u[1] - pw / 3.0 * _cdiv((1.0, 0.0), u)[1])
    w = (jnp.where(u_small, jnp.cbrt(-qw), w[0]),
         jnp.where(u_small, 0.0, w[1]))
    m = (w[0] - P / 3.0, w[1])

    # s = sqrt(2m); guard m ~ 0 (biquadratic case): nudge so q/(2s) is finite;
    # Newton polish absorbs the perturbation
    m = (jnp.where(jnp.hypot(m[0], m[1]) < 1e-12, 1e-12, m[0]), m[1])
    s = _csqrt((2.0 * m[0], 2.0 * m[1]))
    t_half = (0.5 * p + m[0], m[1])
    q_2s = _cdiv((q, jnp.zeros_like(q)), (2.0 * s[0], 2.0 * s[1]))

    # y^2 -+ s y + (p/2 + m +- q/(2s)) = 0
    def quad(sgn):
        # y = [sgn*s ± sqrt(s^2 - 4(p/2+m+sgn*q/(2s)))]/2
        cterm = (t_half[0] + sgn * q_2s[0], t_half[1] + sgn * q_2s[1])
        s2 = _cmul(s, s)
        disc = _csqrt((s2[0] - 4.0 * cterm[0], s2[1] - 4.0 * cterm[1]))
        y0 = (0.5 * (sgn * s[0] + disc[0]), 0.5 * (sgn * s[1] + disc[1]))
        y1 = (0.5 * (sgn * s[0] - disc[0]), 0.5 * (sgn * s[1] - disc[1]))
        return y0, y1

    (ya, yb), (yc, yd) = quad(1.0), quad(-1.0)
    y_re = jnp.stack([ya[0], yb[0], yc[0], yd[0]])
    x = y_re - 0.25 * a  # (4,) real parts of the roots

    # Newton polish on the real quartic (monic form)
    def body(_, x):
        f = (((x + a) * x + b) * x + c) * x + d
        fp = ((4.0 * x + 3.0 * a) * x + 2.0 * b) * x + c
        fp = jnp.where(jnp.abs(fp) < _EPS, jnp.where(fp < 0, -_EPS, _EPS), fp)
        return x - f / fp

    x = jax.lax.fori_loop(0, polish_iters, body, x)
    return jnp.where(jnp.isfinite(x), x, 0.0)


def p3p_minimal(xn: jax.Array, X: jax.Array):
    """Grunert P3P: 3 normalized image points + 3 world points -> 4 poses.

    Args:
      xn: (3,2) undistorted normalized image coords.
      X:  (3,3) world points.

    Returns (R, t) with shapes (4,3,3), (4,3) — world-to-camera candidates.
    Degenerate samples (collinear points, coincident rays) yield finite
    garbage candidates; RANSAC scoring discards them.
    """
    f = jnp.concatenate([xn, jnp.ones_like(xn[:, :1])], axis=1)  # (3,3) rays
    f = f / jnp.linalg.norm(f, axis=1, keepdims=True)

    a2 = jnp.sum((X[1] - X[2]) ** 2)  # side opposite P1
    b2 = jnp.sum((X[0] - X[2]) ** 2)  # side opposite P2
    c2 = jnp.sum((X[0] - X[1]) ** 2)  # side opposite P3
    b2 = jnp.maximum(b2, _EPS)
    ca = f[1] @ f[2]
    cb = f[0] @ f[2]
    cg = f[0] @ f[1]

    q1 = (a2 - c2) / b2
    q2 = (a2 + c2) / b2
    q3 = (b2 - c2) / b2
    q4 = (b2 - a2) / b2
    A4 = (q1 - 1.0) ** 2 - 4.0 * c2 / b2 * ca ** 2
    A3 = 4.0 * (q1 * (1.0 - q1) * cb - (1.0 - q2) * ca * cg
                + 2.0 * c2 / b2 * ca ** 2 * cb)
    A2 = 2.0 * (q1 ** 2 - 1.0 + 2.0 * q1 ** 2 * cb ** 2 + 2.0 * q3 * ca ** 2
                - 4.0 * q2 * ca * cb * cg + 2.0 * q4 * cg ** 2)
    A1 = 4.0 * (-q1 * (1.0 + q1) * cb + 2.0 * a2 / b2 * cg ** 2 * cb
                - (1.0 - q2) * ca * cg)
    A0 = (1.0 + q1) ** 2 - 4.0 * a2 / b2 * cg ** 2

    v = quartic_roots(jnp.stack([A4, A3, A2, A1, A0]))  # (4,) v = s3/s1

    # depth recovery: s1 from the 1-3 law-of-cosines equation, then u = s2/s1
    # from the 1-2 equation (quadratic in u -> two roots), disambiguated by
    # the 2-3 equation's residual.  This is branch-free and — unlike the
    # textbook linear u formula — has no cg - v*ca ~ 0 singularity.
    s1sq = b2 / jnp.maximum(1.0 + v * v - 2.0 * v * cb, _EPS)
    s1 = jnp.sqrt(s1sq)
    rad = jnp.sqrt(jnp.maximum(cg * cg - 1.0 + c2 / s1sq, 0.0))
    u_a, u_b = cg + rad, cg - rad
    res_23 = lambda u: jnp.abs(s1sq * (u * u + v * v - 2.0 * u * v * ca) - a2)
    u = jnp.where(res_23(u_a) <= res_23(u_b), u_a, u_b)
    s = jnp.stack([s1, u * s1, v * s1], axis=1)          # (4,3) depths

    # Newton polish of the depths on the full law-of-cosines system — removes
    # the f32 closed-form error (quadratic convergence; ~machine precision in
    # 3 iterations).  Tiny 3x3 solves, all elementwise.
    def polish(_, s):
        s1_, s2_, s3_ = s[:, 0], s[:, 1], s[:, 2]
        g = jnp.stack([
            s2_ * s2_ + s3_ * s3_ - 2.0 * s2_ * s3_ * ca - a2,
            s1_ * s1_ + s3_ * s3_ - 2.0 * s1_ * s3_ * cb - b2,
            s1_ * s1_ + s2_ * s2_ - 2.0 * s1_ * s2_ * cg - c2,
        ], axis=1)                                        # (4,3)
        z = jnp.zeros_like(s1_)
        J = 2.0 * jnp.stack([
            jnp.stack([z, s2_ - s3_ * ca, s3_ - s2_ * ca], 1),
            jnp.stack([s1_ - s3_ * cb, z, s3_ - s1_ * cb], 1),
            jnp.stack([s1_ - s2_ * cg, s2_ - s1_ * cg, z], 1),
        ], axis=1)                                        # (4,3,3)
        delta = jnp.linalg.solve(
            J + 1e-9 * jnp.eye(3, dtype=s.dtype), g[..., None])[..., 0]
        s_new = s - delta
        return jnp.where(jnp.isfinite(s_new), s_new, s)

    s = jax.lax.fori_loop(0, 3, polish, s)

    Y = s[:, :, None] * f[None, :, :]                    # (4,3,3) cam points

    # Absolute orientation per candidate by the TRIAD method: for 3 points
    # the centered cross-covariance is rank-2 (planar), so polar/Procrustes
    # projections are ill-posed — instead build the orthonormal frame of the
    # triangle in each coordinate system directly; R maps one to the other
    # exactly for congruent sets.  Cross products + rsqrt only, no SVD.
    def _frame(p1, p2, p3):
        e1 = p2 - p1
        e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), _EPS)
        n = jnp.cross(e1, p3 - p1)
        e3 = n / jnp.maximum(jnp.linalg.norm(n), _EPS)
        return jnp.stack([e1, jnp.cross(e3, e1), e3], axis=1)  # columns

    V = _frame(X[0], X[1], X[2])

    def orient(Yk):
        U = _frame(Yk[0], Yk[1], Yk[2])
        R = U @ V.T
        t = jnp.mean(Yk, axis=0) - R @ jnp.mean(X, axis=0)
        return R, t

    return jax.vmap(orient)(Y)
