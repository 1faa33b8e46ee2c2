"""Feature detection + description: nonlinear scale space, Hessian NMS, M-LDB.

Capability parity: the reference's AKAZE path (cv::AKAZE::detectAndCompute —
FED nonlinear diffusion, Hessian-determinant extrema, M-LDB binary
descriptors; SURVEY.md C2, §3.1 hot loop 1).

Design decisions (not a translation of the OpenCV kernel):
  * Full-resolution scale space (KAZE-style) instead of octave pyramids —
    every level is the same static shape, so the whole stack is one batched
    program with no resolution bookkeeping; memory traffic is the cost,
    static shapes that XLA fuses are the payoff.
  * Perona-Malik g2 diffusion with a precomputed (host-side, static) FED
    step schedule — the evolution is a `lax.scan` over fused 3x3 convs.
  * Detection = 3x3x3 (space x scale) NMS + global masked top-K: every image
    yields exactly K keypoint slots with a validity mask (static capacity,
    SURVEY §7.4).
  * Descriptors: rotated, scale-adapted grid samples of (L, Lx, Ly) ->
    channel-wise pairwise comparisons (M-LDB analog) packed into uint32
    words for Hamming matching, plus an L2-normalized float variant that
    rides the GEMM matcher.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Convolution helpers (NCHW, single channel)
# ---------------------------------------------------------------------------

def _conv2d(x: jax.Array, k: jax.Array, dilation: int = 1) -> jax.Array:
    """Same-padded 2D conv of (B,H,W) with kernel (kh,kw)."""
    kh, kw = k.shape
    pad_h = (kh - 1) * dilation // 2
    pad_w = (kw - 1) * dilation // 2
    return jax.lax.conv_general_dilated(
        x[:, None],
        k[None, None],
        window_strides=(1, 1),
        padding=[(pad_h, pad_h), (pad_w, pad_w)],
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[:, 0]


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur of (B,H,W)."""
    k = jnp.asarray(gaussian_kernel1d(sigma))
    x = _conv2d(x, k[None, :])
    return _conv2d(x, k[:, None])


_SCHARR_X = jnp.asarray(
    [[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]], jnp.float32
) / 32.0
_SCHARR_Y = jnp.asarray(
    [[-3.0, -10.0, -3.0], [0.0, 0.0, 0.0], [3.0, 10.0, 3.0]], jnp.float32
) / 32.0


def scharr(x: jax.Array, dilation: int = 1):
    return _conv2d(x, _SCHARR_X, dilation), _conv2d(x, _SCHARR_Y, dilation)


def _sh(x: jax.Array, dy: int, dx: int) -> jax.Array:
    """Periodic shift on the last two axes (any rank; wrap semantics)."""
    if dy:
        x = jnp.roll(x, -dy, axis=-2)
    if dx:
        x = jnp.roll(x, -dx, axis=-1)
    return x


def scharr_roll(x: jax.Array, dilation: int = 1):
    """Roll-based Scharr derivatives (periodic boundary).

    Same 3x3/32 stencil as `scharr` but with WRAP instead of zero padding
    (wrap contamination touches only a <=dilation border, inside `detect`'s
    border mask).  Works for any rank >= 2.
    """
    d = dilation
    E, W_ = _sh(x, 0, d), _sh(x, 0, -d)
    N, S = _sh(x, -d, 0), _sh(x, d, 0)
    NE, NW = _sh(x, -d, d), _sh(x, -d, -d)
    SE, SW = _sh(x, d, d), _sh(x, d, -d)
    gx = (3.0 * (NE + SE - NW - SW) + 10.0 * (E - W_)) / 32.0
    gy = (3.0 * (SE + SW - NE - NW) + 10.0 * (S - N)) / 32.0
    return gx, gy


# ---------------------------------------------------------------------------
# FED (fast explicit diffusion) schedule — host-side, static
# ---------------------------------------------------------------------------

def fed_tau_schedule(T: float, tau_max: float = 0.25) -> np.ndarray:
    """FED cycle step sizes covering total diffusion time T.

    Standard FED: n steps with tau_j = tau_max / (2 cos^2(pi (2j+1)/(4n+2)))
    sum to tau_max * n(n+1)/3; pick smallest n reaching T, then scale.
    """
    if T <= 0:
        return np.zeros(0, np.float32)
    n = 1
    while tau_max * n * (n + 1) / 3.0 < T:
        n += 1
    j = np.arange(n)
    tau = tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    tau = tau * (T / tau.sum())
    return tau.astype(np.float32)


def _pm_g2(grad2: jax.Array, k2: jax.Array) -> jax.Array:
    """Perona-Malik g2 conductivity: 1 / (1 + |grad|^2 / k^2)."""
    return 1.0 / (1.0 + grad2 / k2)


def _diffusion_step(L: jax.Array, k2: jax.Array, tau: jax.Array) -> jax.Array:
    """One explicit diffusion step with conductivity from current gradients.

    Uses the standard half-point-conductivity discretization on the 4-neighbor
    stencil (same scheme family as the reference's FED solver), with
    periodic (roll) boundaries.
    """
    Lx, Ly = scharr_roll(L)
    g = _pm_g2(Lx * Lx + Ly * Ly, k2)

    gN = jnp.roll(g, 1, axis=1)
    gS = jnp.roll(g, -1, axis=1)
    gW = jnp.roll(g, 1, axis=2)
    gE = jnp.roll(g, -1, axis=2)
    LN = jnp.roll(L, 1, axis=1)
    LS = jnp.roll(L, -1, axis=1)
    LW = jnp.roll(L, 1, axis=2)
    LE = jnp.roll(L, -1, axis=2)

    flux = (
        0.5 * (g + gN) * (LN - L)
        + 0.5 * (g + gS) * (LS - L)
        + 0.5 * (g + gW) * (LW - L)
        + 0.5 * (g + gE) * (LE - L)
    )
    return L + tau * flux


def contrast_k2(L: jax.Array, percentile: float = 70.0) -> jax.Array:
    """Per-image contrast parameter^2 from the gradient-magnitude percentile."""
    Lx, Ly = scharr_roll(L)
    mag = jnp.sqrt(Lx * Lx + Ly * Ly)
    k = jnp.percentile(mag.reshape(mag.shape[0], -1), percentile, axis=1)
    k = jnp.maximum(k, 1e-3)
    return (k * k)[:, None, None]


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------

class ScaleSpaceConfig(NamedTuple):
    """Integer scale levels: derivative aperture == sigma exactly.

    Scale-adapted derivatives are taken with Scharr stencils dilated by
    d = sigma (integers), which makes the det-Hessian response naturally
    normalized across levels (the (sigma/d)^4 correction is exactly 1) —
    fractional sigmas with rounded apertures biased alternate levels by up
    to 2.4x and mis-assigned scales between views.
    """

    sigma_levels: tuple = (2, 3, 4, 5, 6)

    @property
    def n_levels(self) -> int:
        return len(self.sigma_levels)

    @property
    def sigmas(self) -> np.ndarray:
        return np.asarray(self.sigma_levels, np.float32)


def build_scale_space(images: jax.Array, cfg: ScaleSpaceConfig):
    """(B,H,W) -> levels (B,L,H,W) of nonlinearly diffused images.

    ONE `lax.scan` over the concatenated FED schedule; each step body also
    (conditionally) snapshots the current image into its level slot.  The
    earlier per-level multi-scan variant compiled the conv graph once per
    level and took ~25 MINUTES of XLA compile for VGA inputs; this form
    traces one step body and compiles in seconds at identical steady-state
    throughput.
    """
    L0 = gaussian_blur(images, float(cfg.sigmas[0]))
    k2 = contrast_k2(L0)
    sigmas = cfg.sigmas
    times = 0.5 * sigmas**2

    # host-side static schedule: per-step tau + the level slot each step closes
    taus_all, snap_level = [], []
    for i in range(1, cfg.n_levels):
        taus = fed_tau_schedule(float(times[i] - times[i - 1]))
        taus_all.extend(taus.tolist())
        snap_level.extend([-1] * (len(taus) - 1) + [i])
    taus_arr = jnp.asarray(np.asarray(taus_all, np.float32))
    snap_arr = jnp.asarray(np.asarray(snap_level, np.int32))

    B, H, W = images.shape
    buf0 = jnp.zeros((cfg.n_levels, B, H, W), images.dtype).at[0].set(L0)

    def step(carry, inp):
        L, buf = carry
        tau, snap = inp
        L = _diffusion_step(L, k2, tau)
        # snap == -1 writes to slot -1 == last slot WITH the wrong value only
        # transiently; guard with where on the gathered row instead
        row = jnp.where(snap >= 0, L, buf[snap])
        buf = buf.at[snap].set(row)
        return (L, buf), None

    (_, buf), _ = jax.lax.scan(step, (L0, buf0), (taus_arr, snap_arr))
    return jnp.moveaxis(buf, 0, 1)  # (B,L,H,W)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

class Keypoints(NamedTuple):
    uv: jax.Array        # (B,K,2) subpixel x,y in pixels
    level: jax.Array     # (B,K) int32 scale-space level
    sigma: jax.Array     # (B,K) scale
    angle: jax.Array     # (B,K) orientation (radians)
    response: jax.Array  # (B,K)
    mask: jax.Array      # (B,K) bool valid


def hessian_response(levels: jax.Array, cfg: ScaleSpaceConfig) -> jax.Array:
    """Scale-normalized determinant-of-Hessian response per level (B,L,H,W).

    Scale-adapted stencils: Scharr dilated by d = sigma measures structure AT
    the level's scale, and with d == sigma exactly the usual (sigma/d)^4
    normalization is identity — responses are directly comparable across
    levels, which is what the 3x3x3 NMS and global top-K assume.
    """
    out = []
    B, L, H, W = levels.shape
    for i in range(L):
        d = int(cfg.sigma_levels[i])
        Li = levels[:, i]
        Lx, Ly = scharr_roll(Li, dilation=d)
        Lxx, Lxy = scharr_roll(Lx, dilation=d)
        _, Lyy = scharr_roll(Ly, dilation=d)
        # aperture d == sigma: response is scale-normalized as-is
        out.append(Lxx * Lyy - Lxy * Lxy)
    return jnp.stack(out, axis=1)


def _maxpool3x3(x: jax.Array) -> jax.Array:
    """(B,L,H,W) -> same-shape 3x3 spatial max."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 1, 1), "SAME"
    )


def detect(levels: jax.Array, resp: jax.Array, cfg: ScaleSpaceConfig, *,
           max_keypoints: int = 512, threshold: float = 1e-5, border: int = 10,
           with_orientation: bool = True) -> Keypoints:
    B, L, H, W = resp.shape
    pooled = _maxpool3x3(resp)
    is_max = (resp >= pooled) & (resp > threshold)
    # scale NMS: strictly greater than same pixel in neighbor levels
    up = jnp.concatenate([resp[:, 1:], jnp.full_like(resp[:, :1], -jnp.inf)], axis=1)
    dn = jnp.concatenate([jnp.full_like(resp[:, :1], -jnp.inf), resp[:, :-1]], axis=1)
    is_max &= (resp >= up) & (resp >= dn)
    # border mask
    ys = jnp.arange(H)
    xs = jnp.arange(W)
    bmask = (
        ((ys >= border) & (ys < H - border))[:, None]
        & ((xs >= border) & (xs < W - border))[None, :]
    )
    is_max &= bmask[None, None]

    masked = jnp.where(is_max, resp, -jnp.inf)
    # Hierarchical top-K instead of one top_k over the full (L*H*W)
    # response: NMS + the radius-3 suppression below guarantee
    # at most one *surviving* keypoint per (L,2,2) block (any two candidates
    # inside a block are <3 px apart, so the weaker one dies either way), so
    # max-reduce blocks first (20x smaller top_k), then recover the exact
    # in-block argmax with a tiny gather.
    Hp, Wp = H + (H % 2), W + (W % 2)
    if (Hp, Wp) != (H, W):
        masked_p = jnp.pad(masked, ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W)),
                           constant_values=-jnp.inf)
    else:
        masked_p = masked
    reduced = jax.lax.reduce_window(
        masked_p, -jnp.inf, jax.lax.max, (1, L, 2, 2), (1, L, 2, 2), "VALID"
    )  # (B,1,Hp/2,Wp/2)
    RW = Wp // 2
    # tiny images can have fewer reduce blocks than the keypoint capacity
    k_red = min(max_keypoints, (Hp // 2) * RW)
    vals, ridx = jax.lax.top_k(reduced.reshape(B, -1), k_red)
    if k_red < max_keypoints:
        pad = max_keypoints - k_red
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        ridx = jnp.pad(ridx, ((0, 0), (0, pad)))
    mask = jnp.isfinite(vals) & (vals > threshold)
    ry, rx = ridx // RW, ridx % RW
    # gather the (L,2,2) source block of every winner, argmax within
    lv_g = jnp.arange(L)[:, None, None]
    dy_g = jnp.arange(2)[None, :, None]
    dx_g = jnp.arange(2)[None, None, :]
    block = masked_p[
        jnp.arange(B)[:, None, None, None, None],
        lv_g[None, None],
        (2 * ry)[:, :, None, None, None] + dy_g[None, None],
        (2 * rx)[:, :, None, None, None] + dx_g[None, None],
    ]  # (B,K,L,2,2)
    amax = jnp.argmax(block.reshape(B, max_keypoints, -1), axis=-1)
    lvl = amax // 4
    iy = 2 * ry + (amax % 4) // 2
    ix = 2 * rx + amax % 2

    # Subpixel refinement: 2D quadratic fit on the response at the level.
    def refine_one(r_lhw, lvl_k, iy_k, ix_k):
        def grab(dy, dx):
            return r_lhw[lvl_k, iy_k + dy, ix_k + dx]

        dx = 0.5 * (grab(0, 1) - grab(0, -1))
        dy = 0.5 * (grab(1, 0) - grab(-1, 0))
        dxx = grab(0, 1) + grab(0, -1) - 2.0 * grab(0, 0)
        dyy = grab(1, 0) + grab(-1, 0) - 2.0 * grab(0, 0)
        dxy = 0.25 * (grab(1, 1) - grab(1, -1) - grab(-1, 1) + grab(-1, -1))
        det = dxx * dyy - dxy * dxy
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        ox = -(dyy * dx - dxy * dy) / det
        oy = -(dxx * dy - dxy * dx) / det
        ox = jnp.clip(ox, -0.5, 0.5)
        oy = jnp.clip(oy, -0.5, 0.5)
        return ox, oy

    ox, oy = jax.vmap(jax.vmap(refine_one, in_axes=(None, 0, 0, 0)))(resp, lvl, iy, ix)
    uv = jnp.stack([ix.astype(jnp.float32) + ox, iy.astype(jnp.float32) + oy], axis=-1)

    # Cross-level radius suppression: the per-level NMS cannot see that the
    # same blob fires at several scale levels one pixel apart; such duplicates
    # make every keypoint its own second-best match and gut the Lowe ratio
    # test.  Kill any keypoint with a strictly stronger (or equal-and-earlier)
    # detection within `suppress_radius` px, across all levels.
    suppress_radius = 3.0
    d2 = jnp.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, axis=-1)  # (B,K,K)
    order = jnp.arange(uv.shape[1])
    stronger = (vals[:, None, :] > vals[:, :, None]) | (
        (vals[:, None, :] == vals[:, :, None]) & (order[None, None, :] < order[None, :, None])
    )
    dup = jnp.any(
        stronger & (d2 < suppress_radius**2) & mask[:, None, :], axis=-1
    )
    mask = mask & ~dup

    sigma = jnp.asarray(cfg.sigmas)[lvl]
    if with_orientation:
        angle = _orientation(levels, lvl, iy, ix, sigma)
    else:
        angle = jnp.zeros_like(sigma)  # upright mode (gravity-aligned rigs)
    return Keypoints(uv=uv, level=lvl, sigma=sigma, angle=angle,
                     response=jnp.where(mask, vals, 0.0), mask=mask)


def _orientation(levels: jax.Array, lvl, iy, ix, sigma, grid_n: int = 13,
                 support_sigmas: float = 9.0):
    """Gradient-centroid orientation from a sigma-SCALED sampling window.

    Samples a grid_n x grid_n grid spanning +-support_sigmas/2 * sigma around
    the keypoint (bilinear), gaussian-weights the central-difference gradients
    and takes atan2 of the vector sum.  Scaling the window with sigma makes
    the orientation consistent when the same feature is detected at slightly
    different levels in different views (AKAZE's dominant-orientation analog,
    branch-free).
    """
    B, L, H, W = levels.shape
    g = jnp.linspace(-0.5, 0.5, grid_n)
    gxx, gyy = jnp.meshgrid(g, g)
    wgt = jnp.exp(-0.5 * ((gxx**2 + gyy**2) / 0.16))  # gaussian over the window

    def per_image(lv_lhw, lvl_k, iy_k, ix_k, sig_k):
        img = lv_lhw[lvl_k]
        span = support_sigmas * sig_k
        x = ix_k + gxx * span
        y = iy_k + gyy * span
        # Sample the window once; gradients = finite differences within it
        # (axis-aligned window), 4x fewer gathers than per-point probing.
        w_img = _bilinear(img, x, y)
        gx = jnp.gradient(w_img, axis=1)
        gy = jnp.gradient(w_img, axis=0)
        sx = jnp.sum(gx * wgt)
        sy = jnp.sum(gy * wgt)
        return jnp.arctan2(sy, sx)

    return jax.vmap(jax.vmap(per_image, in_axes=(None, 0, 0, 0, 0)))(
        levels, lvl, iy, ix, sigma
    )


# ---------------------------------------------------------------------------
# Description (M-LDB analog)
# ---------------------------------------------------------------------------

_GRIDS = (2, 3, 4)  # cell partitions; channels (mean, dx, dy) each
N_CELLS = sum(g * g for g in _GRIDS)                # 29
N_FLOAT_DIM = 128                                   # padded float descriptor
N_BITS = sum(3 * (g * g) * (g * g - 1) // 2 for g in _GRIDS)  # 486
N_WORDS = (N_BITS + 31) // 32                       # 16 uint32 words

_PATCH = 24  # samples per side of the canonical patch


def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def describe(levels: jax.Array, kp: Keypoints):
    """Compute descriptors for all keypoints.

    Returns (desc_float (B,K,N_FLOAT_DIM) f32 L2-normalized,
             desc_bits (B,K,N_WORDS) uint32).
    """
    B, L, H, W = levels.shape
    g = jnp.linspace(-0.5, 0.5, _PATCH)
    gx, gy = jnp.meshgrid(g, g)  # canonical grid in [-0.5,0.5]^2
    grid = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)  # (P2,2)

    def one_kp(lv_lhw, uv, lvl, sigma, angle):
        img = lv_lhw[lvl]
        patch_scale = 20.0 * sigma  # patch spans ~20 sigma (AKAZE-like support)
        ca, sa = jnp.cos(angle), jnp.sin(angle)
        R = jnp.asarray([[ca, -sa], [sa, ca]])
        pts = (grid * patch_scale) @ R.T + uv  # (P2,2) image coords
        vals = _bilinear(img, pts[:, 0], pts[:, 1]).reshape(_PATCH, _PATCH)
        # Gradients in the rotated frame == finite differences along the
        # sampled patch's own axes (the grid IS the rotated frame), so no
        # extra bilinear passes (5x fewer gathers).
        # Constant scale factor is irrelevant: groups are standardized below.
        dxr = jnp.gradient(vals, axis=1)
        dyr = jnp.gradient(vals, axis=0)

        cells = []
        for gdim in _GRIDS:
            cs = _PATCH // gdim
            for ch in (vals, dxr, dyr):
                m = ch[: gdim * cs, : gdim * cs].reshape(gdim, cs, gdim, cs).mean(axis=(1, 3))
                cells.append(m.ravel())
        # layout: [g2:mean,dx,dy | g3:mean,dx,dy | g4:...] each (g*g,)
        return jnp.concatenate(cells)  # (3*29,) = 87

    feats = jax.vmap(
        jax.vmap(one_kp, in_axes=(None, 0, 0, 0, 0))
    )(levels, kp.uv, kp.level, kp.sigma, kp.angle)  # (B,K,87)

    return finalize_float(feats, kp.mask), finalize_bits(feats, kp.mask)


def finalize_float(raw: jax.Array, mask: jax.Array) -> jax.Array:
    """Float descriptor from raw cell features (B,K,>=87): per-(grid,channel)
    group standardization (subtract the group mean, unit-normalize the
    group) before the global L2 norm.  Raw cell values share a large
    common-mode component (every keypoint has a bright/dark center), which
    otherwise dominates the inner product and makes impostors score higher
    than true matches."""
    groups = []
    off = 0
    for gdim in _GRIDS:
        n = gdim * gdim
        for _ch in range(3):
            v = raw[..., off:off + n]
            off += n
            v = v - jnp.mean(v, axis=-1, keepdims=True)
            v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
            groups.append(v)
    f = jnp.concatenate(groups, axis=-1)
    f = f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-8)
    f = jnp.pad(f, ((0, 0), (0, 0), (0, N_FLOAT_DIM - f.shape[-1])))
    return jnp.where(mask[..., None], f, 0.0)


def finalize_bits(raw: jax.Array, mask: jax.Array) -> jax.Array:
    """Binary M-LDB descriptor from raw cell features: pairwise comparisons
    within each grid+channel group, packed (B,K,N_WORDS) uint32."""
    bits = []
    off = 0
    for gdim in _GRIDS:
        n = gdim * gdim
        for _ch in range(3):
            v = raw[..., off:off + n]
            off += n
            iu, ju = np.triu_indices(n, k=1)
            bits.append(v[..., iu] > v[..., ju])
    b = jnp.concatenate(bits, axis=-1)  # (B,K,486) bool
    b = jnp.pad(b, ((0, 0), (0, 0), (0, N_WORDS * 32 - b.shape[-1])))
    w = b.reshape(*b.shape[:-1], N_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(w << shifts, axis=-1).astype(jnp.uint32)
    return jnp.where(mask[..., None], packed, 0)


# The upright sampler sees the scale space zero-extended to at least
# _UPRIGHT_PAD rows and columns (rows to a multiple of 8, columns to a
# multiple of 128): samples past the bottom/right edge read zeros, samples
# past the top/left edge clamp.  Kept as the descriptor's definition so maps
# and queries stay compatible.
_UPRIGHT_PAD = 256


def _cells_from_patch(patch: jax.Array) -> jax.Array:
    """(PATCH,PATCH) -> (87,) cell features [mean,dx,dy per grid]."""
    # in-patch gradients (axis-aligned == upright frame)
    dx = jnp.gradient(patch, axis=1)
    dy = jnp.gradient(patch, axis=0)
    outs = []
    for g in _GRIDS:
        cs = _PATCH // g
        for ch in (patch, dx, dy):
            outs.append(ch[: g * cs, : g * cs].reshape(g, cs, g, cs)
                        .mean(axis=(1, 3)).ravel())
    # layout must match describe: per grid, [mean, dx, dy]
    return jnp.concatenate(outs)


def describe_upright(levels: jax.Array, uv: jax.Array, level: jax.Array,
                     sigma: jax.Array, mask: jax.Array) -> jax.Array:
    """Raw upright cell features (B,K,87) for all keypoints of a batch: an
    axis-aligned PATCH x PATCH bilinear resample spanning 20 sigma, then
    2x2/3x3/4x4 cell means of (value, dx, dy).  Finish with
    ``finalize_float`` / ``finalize_bits``."""
    B, L, H, W = levels.shape
    Hp = max(((H + 7) // 8) * 8, _UPRIGHT_PAD)
    Wp = max(((W + 127) // 128) * 128, _UPRIGHT_PAD)
    if (Hp, Wp) != (H, W):
        levels = jnp.pad(levels, ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W)))
    spacing = 20.0 * sigma / (_PATCH - 1)     # span 20 sigma over PATCH samples
    k = jnp.arange(_PATCH, dtype=jnp.float32) - (_PATCH - 1) / 2.0

    def one(lv, uv1, lvl1, sp1):
        gx, gy = jnp.meshgrid(uv1[0] + k * sp1, uv1[1] + k * sp1)
        patch = _bilinear(lv[lvl1], gx.ravel(), gy.ravel())
        return _cells_from_patch(patch.reshape(_PATCH, _PATCH))

    feats = jax.vmap(jax.vmap(one, in_axes=(None, 0, 0, 0)))(
        levels, uv, level, spacing)
    return jnp.where(mask[..., None], feats, 0.0)


class Features(NamedTuple):
    kp: Keypoints
    desc: jax.Array       # (B,K,N_FLOAT_DIM) float
    desc_bits: jax.Array  # (B,K,N_WORDS) uint32


def _extract_octave(images: jax.Array, cfg: ScaleSpaceConfig,
                    max_keypoints: int, threshold: float,
                    oriented: bool) -> Features:
    """Single-octave extraction: scale space, detection, description."""
    levels = build_scale_space(images, cfg)
    resp = hessian_response(levels, cfg)
    kp = detect(levels, resp, cfg, max_keypoints=max_keypoints,
                threshold=threshold, with_orientation=oriented)
    if oriented:
        desc_float, desc_bits = describe(levels, kp)
    else:
        raw = describe_upright(levels, kp.uv, kp.level, kp.sigma, kp.mask)
        desc_float = finalize_float(raw, kp.mask)
        desc_bits = finalize_bits(raw, kp.mask)
    return Features(kp=kp, desc=desc_float, desc_bits=desc_bits)


def _downsample2(images: jax.Array) -> jax.Array:
    """(B,H,W) -> (B,H//2,W//2) 2x2 average pool (odd tails dropped)."""
    B, H, W = images.shape
    h, w = (H // 2) * 2, (W // 2) * 2
    x = images[:, :h, :w].reshape(B, h // 2, 2, w // 2, 2)
    return jnp.mean(x, axis=(2, 4))


@partial(jax.jit, static_argnames=("cfg", "max_keypoints", "threshold",
                                   "oriented", "n_octaves"))
def detect_and_describe(images: jax.Array, cfg: ScaleSpaceConfig = ScaleSpaceConfig(), *,
                        max_keypoints: int = 512, threshold: float = 1e-5,
                        oriented: bool = False,
                        n_octaves: int = 1) -> Features:
    """Full extraction: (B,H,W) f32 in [0,1] -> Features with static K capacity.

    oriented=False (default): upright descriptors (``describe_upright``) —
    the right mode for gravity-aligned indoor rigs.
    oriented=True: rotation-invariant gather path (dominant-orientation +
    rotated patch sampling).

    n_octaves > 1 adds 2x-downsampled octaves (the reference's AKAZE spans
    4 octaves; one octave of sigma 2-6 only covers a 3x scale band, so
    queries at a substantially different distance than the mapping walk
    miss).  Each octave is its own static-shape program over the SAME
    single-scan FED machinery; keypoint budget halves per octave, merged
    candidates fight one global top-K with cross-octave radius
    suppression.  kp.sigma/uv are full-resolution units; kp.level encodes
    octave * n_levels + level.
    """
    if n_octaves <= 1:
        return _extract_octave(images, cfg, max_keypoints, threshold,
                               oriented)
    parts = []
    img_o = images
    for o in range(n_octaves):
        if o:
            img_o = _downsample2(img_o)
        k_o = max(64, max_keypoints >> o)
        parts.append(_extract_octave(img_o, cfg, k_o, threshold, oriented))
    return merge_octave_features(parts, cfg.n_levels, max_keypoints)


def merge_octave_features(parts: list, n_levels: int,
                          max_keypoints: int) -> Features:
    """Merge per-octave Features (parts[o] extracted at 1/2^o resolution)
    into one full-resolution set: rescale uv/sigma, suppress cross-octave
    duplicates, global top-K by response.  Shared by the AKAZE-analog and
    SIFT octave paths."""
    scaled = []
    for o, f in enumerate(parts):
        s = float(1 << o)
        kp = f.kp._replace(
            # avg-pool cell i covers full-res [s*i, s*i+s): center s*i+(s-1)/2
            uv=f.kp.uv * s + (s - 1.0) / 2.0,
            sigma=f.kp.sigma * s,
            level=f.kp.level + o * n_levels,
        )
        scaled.append(Features(kp=kp, desc=f.desc, desc_bits=f.desc_bits))
    cat = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1), *scaled)
    # cross-octave duplicate suppression: the SAME blob (similar effective
    # sigma, e.g. octave-0 level sigma 6 vs octave-1 level sigma 3*2) fires
    # in adjacent octaves one pixel apart; kill the weaker.  Distinct-scale
    # features at the same location are different features (different
    # support) and both stay — only near-equal sigmas are duplicates.
    # Deliberately SINGLE-PASS and non-transitive: C can be suppressed by a
    # B that is itself suppressed by A.  In a chain of near-equal-sigma
    # neighbors that over-suppresses (vs. iterating until only survivors
    # suppress), but duplicates here come in PAIRS (one blob, two adjacent
    # octaves), chains of 3+ require three octaves firing on one blob
    # within 1.5 sigma, and losing a borderline member of such a cluster
    # costs nothing downstream (the survivor carries the track).  Accepted
    # approximation — one pass keeps the merge a single fused (B,Kt,Kt) op.
    uv, resp0, mask = cat.kp.uv, cat.kp.response, cat.kp.mask
    B, Kt = resp0.shape
    d2 = jnp.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, axis=-1)
    sig_i = cat.kp.sigma[:, :, None]
    sig_j = cat.kp.sigma[:, None, :]
    same_scale = (jnp.maximum(sig_i, sig_j)
                  < 1.6 * jnp.minimum(sig_i, sig_j))
    rad = 1.5 * jnp.minimum(sig_i, sig_j)
    order = jnp.arange(Kt)
    stronger = (resp0[:, None, :] > resp0[:, :, None]) | (
        (resp0[:, None, :] == resp0[:, :, None])
        & (order[None, None, :] < order[None, :, None]))
    dup = jnp.any(stronger & same_scale & (d2 < rad * rad)
                  & mask[:, None, :], axis=-1)
    mask = mask & ~dup
    # Rank-interleaved selection, NOT a global top-K by response: det-Hessian
    # responses are far stronger at fine scales on detailed imagery, so a
    # response top-K starves the coarse octaves of budget — measured: a
    # close-up query (3.5x the mapping scale) extracted with 3 octaves still
    # had sigma p90 = 6 (all octave-0) and localized with 1 inlier.  Each
    # part arrives response-sorted (lax.top_k order), so within-octave rank
    # is its static slot index; selecting the smallest rank*2^octave keys
    # gives octave o a guaranteed ~K/2^o share (the pyramid's area ratio)
    # while unused coarse budget spills back to fine octaves.
    rank_key = np.concatenate(
        [np.arange(p.kp.uv.shape[1], dtype=np.float32) * (1 << o)
         for o, p in enumerate(parts)])
    key_sel = jnp.where(mask, rank_key[None, :], np.float32(1e9))
    _, sel = jax.lax.top_k(-key_sel, max_keypoints)         # (B,K)

    def take(x):
        return jnp.take_along_axis(
            x, sel.reshape(B, max_keypoints, *([1] * (x.ndim - 2))), axis=1)

    kp = Keypoints(uv=take(uv), level=take(cat.kp.level),
                   sigma=take(cat.kp.sigma), angle=take(cat.kp.angle),
                   response=take(resp0),
                   mask=take(mask.astype(jnp.int32)).astype(bool))
    return Features(kp=kp, desc=take(cat.desc), desc_bits=take(cat.desc_bits))
