"""SIFT-family extractor: DoG pyramid detection + gradient-histogram descriptor.

Capability parity: the reference supports SIFT as the selectable alternative
to AKAZE ("SIFT/AKAZE feature extraction", BASELINE.json; OpenMVG's
``SIFT_Image_describer``).  This is NOT a port of VLFeat/OpenMVG SIFT — it is
the same capability rebuilt for batched accelerators:

  * Gaussian pyramid + difference-of-Gaussians at a FLAT resolution (no
    octave downsampling): every level is a (B,H,W) plane so the whole
    pyramid is one batched separable-conv pass — XLA fuses it; dynamic
    per-octave shapes would force recompiles and defeat batching.
  * Extrema detection reuses the blocked top-k NMS machinery from
    ``features.detect`` (|DoG| response, so minima and maxima both fire),
    with the standard edge rejection (Hessian trace^2/det ratio).
  * The 4x4x8 descriptor is computed with STATIC soft-binning weights: the
    16x16 sample grid is fixed in the patch frame, so the spatial bilinear
    cell weights are a constant (256,16) matrix; orientation soft-binning
    is a closed-form (256,8) triangular kernel; the descriptor is one
    einsum ``sc,so,s->co`` per keypoint, vmapped — no scatter, no loops.

Output is the same ``Features`` record as the AKAZE-analog extractor, so
matching / SfM / localization are extractor-agnostic.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .features import (Features, Keypoints, _bilinear, _maxpool3x3,
                       _orientation, detect, gaussian_blur)

# flat pyramid: sigma_i = SIGMA0 * STEP^i
SIGMA0 = 1.6
STEP = 2 ** 0.5
N_LEVELS = 6          # DoG levels = N_LEVELS - 1
EDGE_R = 10.0         # SIFT edge-rejection curvature ratio
N_CELLS = 4           # 4x4 spatial cells
N_ORI = 8             # orientation bins
PATCH_N = 16          # 16x16 samples
DESC_DIM = N_CELLS * N_CELLS * N_ORI  # = 128


class SiftScales(NamedTuple):
    """Duck-typed stand-in for ScaleSpaceConfig inside features.detect."""

    sigma_list: tuple

    @property
    def sigmas(self) -> np.ndarray:
        return np.asarray(self.sigma_list, np.float32)

    @property
    def n_levels(self) -> int:
        return len(self.sigma_list)


def _dog_scales() -> SiftScales:
    # sigma of DoG level i ~ geometric mean of the two gaussians
    s = [float(SIGMA0 * STEP ** i) for i in range(N_LEVELS)]
    return SiftScales(tuple(np.sqrt(s[i] * s[i + 1]) for i in range(N_LEVELS - 1)))


def build_dog(images: jax.Array):
    """(B,H,W) -> (gauss levels (B,L,H,W), |DoG| response (B,L-1,H,W), DoG)."""
    levels = []
    prev_sigma = 0.0
    L = images
    for i in range(N_LEVELS):
        sigma = SIGMA0 * STEP ** i
        inc = float(np.sqrt(max(sigma * sigma - prev_sigma * prev_sigma, 1e-6)))
        L = gaussian_blur(L, inc)
        prev_sigma = sigma
        levels.append(L)
    G = jnp.stack(levels, axis=1)               # (B,L,H,W)
    dog = G[:, 1:] - G[:, :-1]                  # (B,L-1,H,W)
    return G, dog


def _edge_mask(dog: jax.Array) -> jax.Array:
    """SIFT edge rejection on each DoG plane: tr^2/det < (r+1)^2/r."""
    Dxx = jnp.roll(dog, -1, -1) + jnp.roll(dog, 1, -1) - 2 * dog
    Dyy = jnp.roll(dog, -1, -2) + jnp.roll(dog, 1, -2) - 2 * dog
    Dxy = 0.25 * (
        jnp.roll(jnp.roll(dog, -1, -1), -1, -2)
        - jnp.roll(jnp.roll(dog, 1, -1), -1, -2)
        - jnp.roll(jnp.roll(dog, -1, -1), 1, -2)
        + jnp.roll(jnp.roll(dog, 1, -1), 1, -2)
    )
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    thresh = (EDGE_R + 1.0) ** 2 / EDGE_R
    return (det > 0) & (tr * tr < thresh * det)


def detect_sift(images: jax.Array, *, max_keypoints: int = 512,
                threshold: float = 0.015, oriented: bool = False):
    """DoG extrema -> Keypoints (+ the gaussian levels for description)."""
    G, dog = build_dog(images)
    scales = _dog_scales()
    resp = jnp.where(_edge_mask(dog), jnp.abs(dog), 0.0)
    # reuse the blocked-top-k NMS detector; subpixel refine runs on |DoG|
    kp = detect(G[:, :-1], resp, scales, max_keypoints=max_keypoints,
                threshold=threshold, with_orientation=False)
    if oriented:
        angle = _orientation(G[:, :-1], kp.level,
                             jnp.round(kp.uv[..., 1]).astype(jnp.int32),
                             jnp.round(kp.uv[..., 0]).astype(jnp.int32),
                             kp.sigma)
        kp = kp._replace(angle=angle)
    return kp, G


def _static_spatial_weights() -> np.ndarray:
    """(256,16) bilinear soft-assignment of the fixed 16x16 grid to 4x4 cells."""
    # sample positions in cell units [0,4): centers at (i+0.5)/4*4
    pos = (np.arange(PATCH_N) + 0.5) * N_CELLS / PATCH_N  # in [0,4)
    w = np.zeros((PATCH_N, N_CELLS), np.float32)
    for i, p in enumerate(pos):
        c = p - 0.5  # cell-center coordinate
        c0 = int(np.floor(c))
        f = c - c0
        if 0 <= c0 < N_CELLS:
            w[i, c0] += 1.0 - f
        if 0 <= c0 + 1 < N_CELLS:
            w[i, c0 + 1] += f
    # outer product over y,x -> (256, 16)
    W = np.einsum("ya,xb->yxab", w, w).reshape(PATCH_N * PATCH_N,
                                               N_CELLS * N_CELLS)
    return W.astype(np.float32)


_W_SPATIAL = _static_spatial_weights()


def describe_sift(G: jax.Array, kp: Keypoints):
    """4x4x8 gradient-histogram descriptors; (B,K,128) L2-normalized."""
    B, L, H, W = G.shape
    g = jnp.linspace(-0.5, 0.5, PATCH_N)
    gx, gy = jnp.meshgrid(g, g)
    grid = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)       # (S,2)
    gweight = jnp.exp(-0.5 * (gx ** 2 + gy ** 2) / 0.25 ** 2).ravel()
    Wsp = jnp.asarray(_W_SPATIAL)                             # (S,16)

    def one_kp(lv, uv, lvl, sigma, angle):
        img = lv[lvl]
        span = 12.0 * sigma
        ca, sa = jnp.cos(angle), jnp.sin(angle)
        Rm = jnp.asarray([[ca, -sa], [sa, ca]])
        pts = (grid * span) @ Rm.T + uv                       # (S,2)
        vals = _bilinear(img, pts[:, 0], pts[:, 1]).reshape(PATCH_N, PATCH_N)
        dx = jnp.gradient(vals, axis=1).ravel()               # patch-frame grads
        dy = jnp.gradient(vals, axis=0).ravel()
        mag = jnp.sqrt(dx * dx + dy * dy + 1e-12) * gweight
        theta = jnp.arctan2(dy, dx)                           # [-pi, pi]
        # triangular soft binning over 8 circular bins
        bin_pos = (theta + jnp.pi) * (N_ORI / (2.0 * jnp.pi))  # [0,8]
        centers = jnp.arange(N_ORI) + 0.5
        d = jnp.abs(bin_pos[:, None] - centers[None, :])
        d = jnp.minimum(d, N_ORI - d)                          # circular
        Wori = jnp.maximum(0.0, 1.0 - d)                       # (S,8)
        desc = jnp.einsum("sc,so,s->co", Wsp, Wori, mag)       # (16,8)
        v = desc.ravel()
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-8)
        v = jnp.minimum(v, 0.2)                                # SIFT clip
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-8)

    desc = jax.vmap(jax.vmap(one_kp, in_axes=(None, 0, 0, 0, 0)))(
        G[:, :-1], kp.uv, kp.level, kp.sigma, kp.angle)        # (B,K,128)
    desc = jnp.where(kp.mask[..., None], desc, 0.0)
    return desc


def _binarize(desc: jax.Array, mask: jax.Array) -> jax.Array:
    """LSH-style sign bits vs per-descriptor mean -> (B,K,4) uint32 words."""
    bits = desc > jnp.mean(desc, axis=-1, keepdims=True)
    w = bits.reshape(*bits.shape[:-1], 4, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(w << shifts, axis=-1).astype(jnp.uint32)
    return jnp.where(mask[..., None], words, 0)


@partial(jax.jit, static_argnames=("max_keypoints", "threshold", "oriented"))
def _extract_sift_octave(images, max_keypoints, threshold, oriented):
    kp, G = detect_sift(images, max_keypoints=max_keypoints,
                        threshold=threshold, oriented=oriented)
    desc = describe_sift(G, kp)
    bits = _binarize(desc, kp.mask)
    # pad bits to the shared word count (16) so Features is layout-compatible
    from .features import N_WORDS

    pad = N_WORDS - bits.shape[-1]
    if pad > 0:
        bits = jnp.pad(bits, ((0, 0), (0, 0), (0, pad)))
    return Features(kp=kp, desc=desc, desc_bits=bits)


def detect_and_describe_sift(images: jax.Array, *, max_keypoints: int = 512,
                             threshold: float = 0.015,
                             oriented: bool = False,
                             n_octaves: int = 1) -> Features:
    """Full SIFT-family extraction; drop-in alternative to the AKAZE analog.

    threshold is the |DoG| contrast threshold on [0,1] images (OpenCV's
    0.04/n_sublevels analog).  Pad desc to the shared N_FLOAT_DIM=128 —
    SIFT is exactly 128-d, so no padding is needed.

    n_octaves > 1: 2x-downsampled octaves merged exactly like the
    AKAZE-analog path (features.merge_octave_features) — the flat 6-level
    pyramid spans sigma 1.6-9 (~3x scale band) per octave.
    """
    if n_octaves <= 1:
        return _extract_sift_octave(images, max_keypoints, threshold,
                                    oriented)
    from .features import _downsample2, merge_octave_features

    parts = []
    img_o = images
    for o in range(n_octaves):
        if o:
            img_o = _downsample2(img_o)
        k_o = max(64, max_keypoints >> o)
        parts.append(_extract_sift_octave(img_o, k_o, threshold, oriented))
    return merge_octave_features(parts, _dog_scales().n_levels,
                                 max_keypoints)
