"""SO(3)/SE(3) Lie-group operations, numerically safe under jit/vmap/f32.

Capability parity: the reference represents poses as OpenMVG ``geometry::Pose3``
(rotation matrix + center) manipulated by Eigen; BA perturbs rotations via
Ceres' angle-axis local parameterization.  Here everything is a pure jnp
function so it vmaps over camera batches and differentiates for LM.

Conventions:
  * Rotations are world-to-camera 3x3 matrices ``R``; translation ``t`` so that
    a world point X maps to camera coords ``R @ X + t``.
  * Tangent updates are applied on the LEFT: ``R' = exp(w) @ R``.
  * All functions accept arbitrary leading batch dims via vmap; the base
    implementations are single-instance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: (3,) -> (3,3) skew-symmetric matrix."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy]),
            jnp.stack([wz, z, -wx]),
            jnp.stack([-wy, wx, z]),
        ]
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: (3,3) skew -> (3,)."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, Taylor-safe near theta=0.

    exp(hat(w)) = I + sin(th)/th * W + (1-cos(th))/th^2 * W^2
    """
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # Taylor fallbacks: sin(th)/th ~ 1 - th^2/6 ; (1-cos)/th^2 ~ 1/2 - th^2/24
    use_taylor = theta2 < 1e-8
    a = jnp.where(use_taylor, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) + a * W + b * (W @ W)


def so3_log(R: jax.Array) -> jax.Array:
    """Matrix log of a rotation, safe near identity and near pi.

    Uses the quaternion route (stable at both ends) rather than the
    trace/arccos formula which loses precision near theta=pi in f32.
    """
    q = rot_to_quat(R)  # (w, x, y, z), w >= 0
    qw = q[0]
    qv = q[1:]
    nv = jnp.linalg.norm(qv)
    # theta = 2*atan2(|qv|, qw); axis = qv/|qv|
    theta = 2.0 * jnp.arctan2(nv, qw)
    scale = jnp.where(nv < 1e-7, 2.0 / jnp.maximum(qw, 1e-7), theta / jnp.maximum(nv, 1e-30))
    return scale * qv


def rot_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w,x,y,z) with w>=0.

    Branchless Shepperd's method: compute all four candidate constructions and
    select the one keyed on the largest of (trace, R00, R11, R22). jit-safe.
    """
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (guaranteed >= 0 pre-clip).
    qw2 = jnp.maximum(1.0 + tr, 0.0)
    qx2 = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy2 = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz2 = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    # candidate built from w
    sw = jnp.sqrt(qw2 + _EPS * _EPS) * 2.0
    cw = jnp.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw])
    sx = jnp.sqrt(qx2 + _EPS * _EPS) * 2.0
    cx = jnp.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx])
    sy = jnp.sqrt(qy2 + _EPS * _EPS) * 2.0
    cy = jnp.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy])
    sz = jnp.sqrt(qz2 + _EPS * _EPS) * 2.0
    cz = jnp.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz])

    cands = jnp.stack([cw, cx, cy, cz])  # (4,4)
    keys = jnp.stack([qw2, qx2, qy2, qz2])
    q = cands[jnp.argmax(keys)]
    q = q / jnp.linalg.norm(q)
    return q * jnp.sign(jnp.where(q[0] == 0.0, 1.0, q[0]))


def quat_to_rot(q: jax.Array) -> jax.Array:
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se(3) exp: xi = (w[3], v[3]) -> (R, t) with t = V(w) @ v."""
    w, v = xi[:3], xi[3:]
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    b = jnp.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    c = jnp.where(
        use_taylor,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS * _EPS),
    )
    W = hat(w)
    V = jnp.eye(3, dtype=xi.dtype) + b * W + c * (W @ W)
    return so3_exp(w), V @ v


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    """Inverse of se3_exp: (R, t) -> xi = (w, v)."""
    w = so3_log(R)
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    W = hat(w)
    # V^{-1} = I - W/2 + (1/th^2)(1 - th*sin/(2(1-cos))) W^2
    half_theta = 0.5 * theta
    cot_term = jnp.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), 1e-20))
        / (theta2 + _EPS * _EPS),
    )
    Vinv = jnp.eye(3, dtype=R.dtype) - 0.5 * W + cot_term * (W @ W)
    return jnp.concatenate([w, Vinv @ t])


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): apply b first, then a."""
    return Ra @ Rb, Ra @ tb + ta


def inverse(R, t):
    Rt = R.T
    return Rt, -(Rt @ t)


def apply(R, t, X):
    """Transform world point(s) X (...,3) into camera frame."""
    return X @ R.T + t


def perturb(R: jax.Array, t: jax.Array, delta: jax.Array):
    """Left-multiplicative local update used by LM: delta=(dw[3], dt[3])."""
    dR = so3_exp(delta[:3])
    return dR @ R, t + delta[3:6]


def project_to_so3(M: jax.Array) -> jax.Array:
    """Nearest rotation to a 3x3 matrix (SVD orthogonalization, det=+1)."""
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    S = jnp.diag(jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d]))
    return U @ S @ Vt


def _inv3(M: jax.Array) -> jax.Array:
    """Closed-form 3x3 inverse via adjugate (branch-free, mul/add only)."""
    c0 = jnp.cross(M[:, 1], M[:, 2])
    c1 = jnp.cross(M[:, 2], M[:, 0])
    c2 = jnp.cross(M[:, 0], M[:, 1])
    adjT = jnp.stack([c0, c1, c2], axis=0)  # rows = cofactor columns
    det = jnp.dot(M[:, 0], c0)
    det = jnp.where(jnp.abs(det) < 1e-30, jnp.sign(det) * 1e-30 + 1e-30, det)
    return adjT / det


def project_to_so3_fast(M: jax.Array, iters: int = 5) -> jax.Array:
    """SVD-free nearest rotation: scaled Higham polar iteration.

    X <- (g X + (g X)^-T) / 2 with determinant scaling g = |det X|^(-1/3);
    quadratic convergence, all mul/adds (adjugate 3x3 inverse) — orders of
    magnitude faster than `jnp.linalg.svd` when vmapped over thousands of
    RANSAC hypotheses.  Needs det(M) != 0; reflections (det<0) are
    flipped first so the result has det=+1, matching project_to_so3 for
    inputs that are near a (scaled) rotation — exactly the RANSAC case.
    Degenerate inputs yield a finite garbage rotation that scores no inliers.
    """
    det = jnp.linalg.det(M)
    sign = jnp.where(det < 0, -1.0, 1.0).astype(M.dtype)
    X = M * sign

    def body(_, X):
        d = jnp.abs(jnp.linalg.det(X))
        g = jnp.power(jnp.maximum(d, 1e-30), -1.0 / 3.0)
        Xg = X * g
        return 0.5 * (Xg + _inv3(Xg).T)

    X = jax.lax.fori_loop(0, iters, body, X)
    return jnp.where(jnp.all(jnp.isfinite(X)), X, jnp.eye(3, dtype=M.dtype))


# Batched versions (leading axis N) — the forms the pipeline actually calls.
so3_exp_b = jax.vmap(so3_exp)
so3_log_b = jax.vmap(so3_log)
quat_to_rot_b = jax.vmap(quat_to_rot)
rot_to_quat_b = jax.vmap(rot_to_quat)
perturb_b = jax.vmap(perturb)
