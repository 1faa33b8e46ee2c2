"""Top-2 descriptor matching without the similarity matrix: a Hopper kernel.

Both matchers need, for every query descriptor, the best and second-best
similarity over a candidate set and the index of the best:

- full-pool localization: B*K query rows against every landmark of the map
  (10^5 and more), and
- pairwise matching in the map build: each image's K rows against its
  partner's K rows, for every pair.

The plain version writes the (rows, candidates) f32 similarity to device
memory and reads it back for ``top_k``: 13 GB each way for 32x1024 queries
against 100,352 landmarks, where the bf16 GEMM itself is ~1 ms.  The kernel
keeps each similarity tile in registers and moves only the descriptors.

Kernel (Pallas through Triton):

- the grid runs over (pair, query-row block, landmark split); each block
  reads its own pair's image indices, so one kernel serves both matchers;
- inside a block a loop walks the candidate tiles: one bf16 x bf16 -> f32
  ``dot`` per tile, then an ELEMENTWISE running (best, second, tile-of-best)
  per (row, column-slot) — no cross-lane reduction inside the loop;
- one reduction over the column slots at the end gives the row's top-2;
- blocks carry nothing between them (Hopper runs them in parallel, in no
  order); a split over the candidate axis gives small query sets enough
  blocks, and its partial top-2s merge exactly afterwards;
- sizes are padded to powers of two; padded and masked candidates score
  ``NEG`` through an additive column bias.

Ties: within one column slot the earlier tile wins; across slots the lowest
slot wins, which is not always the lowest index.  Exact float ties between
distinct descriptors do not occur in practice; callers that care compare
indices only where s1 - s2 exceeds the bf16 noise.

``top2`` and ``match_float_streaming`` dispatch through ``backend``: the
kernel on the GPU, the chunked plain version (``top2_scan``) on the CPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.masking import NEG_INF, round_up
from . import backend

NEG = NEG_INF
# Enough blocks to keep every SM of an H100 (132) busy several times over.
_TARGET_BLOCKS = 512


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _top2_kernel(pairs_ref, q_ref, pool_ref, bias_ref, s1_ref, i1_ref, s2_ref,
                 *, block_q: int, block_p: int, tiles: int):
    r = pl.program_id(1)
    split = pl.program_id(2)
    a = pairs_ref[0]
    b = pairs_ref[1]
    q = plgpu.load(q_ref.at[a, pl.ds(r * block_q, block_q), :])
    shape = (block_q, block_p)

    def body(j, carry):
        best, second, jbest = carry
        cols = pl.ds(j * block_p, block_p)
        t = plgpu.load(pool_ref.at[b, cols, :])
        bias = plgpu.load(bias_ref.at[b, cols])
        # precision is explicit: the library default ("highest") must not
        # reach a bf16 dot
        sim = jax.lax.dot_general(
            q, t, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32) + bias[None, :]
        second = jnp.maximum(second, jnp.minimum(best, sim))
        jbest = jnp.where(sim > best, j, jbest)
        return jnp.maximum(best, sim), second, jbest

    j0 = split * tiles
    best, second, jbest = jax.lax.fori_loop(
        j0, j0 + tiles, body,
        (jnp.full(shape, NEG, jnp.float32), jnp.full(shape, NEG, jnp.float32),
         jnp.zeros(shape, jnp.int32)))
    slot = jnp.argmax(best, axis=1)
    win = jax.lax.broadcasted_iota(jnp.int32, shape, 1) == slot[:, None]
    s1_ref[...] = jnp.max(best, axis=1)
    s2_ref[...] = jnp.max(jnp.where(win, second, best), axis=1)
    i1_ref[...] = jnp.max(jnp.where(win, jbest, 0), axis=1) * block_p + slot


def _merge_splits(s1, i1, s2):
    """Exact top-2 from per-split partial top-2s (leading split axis)."""
    w = jnp.argmax(s1, axis=0)
    take = lambda x: jnp.take_along_axis(x, w[None], axis=0)[0]
    split = jnp.arange(s1.shape[0]).reshape((-1,) + (1,) * (s1.ndim - 1))
    losers = jnp.where(split == w[None], NEG, s1)
    return (jnp.max(s1, axis=0), take(i1),
            jnp.maximum(take(s2), jnp.max(losers, axis=0)))


@partial(jax.jit, static_argnames=("block_q", "block_p", "split", "num_warps",
                                   "num_stages", "interpret"))
def top2_kernel(q, pool, pool_mask, pairs, *, block_q: int = 64,
                block_p: int = 64, split: int | None = None,
                num_warps: int = 4, num_stages: int = 2,
                interpret: bool = False):
    """Per pair (a, b): top-2 of every row of ``q[a]`` against the rows of
    ``pool[b]`` where ``pool_mask[b]``.

    Args:
      q: (A, Kq, D) query descriptors; pool: (Bn, Kp, D) candidates;
      pool_mask: (Bn, Kp) bool; pairs: (Np, 2) int32 (image a, image b).
    Returns (s1, i1, s2), each (Np, Kq): best similarity, its index into
    ``pool[b]``, second-best similarity.  A row with no valid candidate
    gets s1 = s2 = NEG.
    """
    _, Kq, D = q.shape
    _, Kp, _ = pool.shape
    Np = pairs.shape[0]
    dp = max(16, _next_pow2(D))
    kq = round_up(max(Kq, block_q), block_q)
    n_tiles = -(-Kp // block_p)
    if split is None:
        blocks = Np * (kq // block_q)
        split = min(n_tiles, _next_pow2(max(1, _TARGET_BLOCKS // blocks)))
    tiles = -(-n_tiles // split)
    kp = tiles * split * block_p
    q16 = jnp.pad(q.astype(jnp.bfloat16), ((0, 0), (0, kq - Kq), (0, dp - D)))
    p16 = jnp.pad(pool.astype(jnp.bfloat16),
                  ((0, 0), (0, kp - Kp), (0, dp - D)))
    bias = jnp.pad(jnp.where(pool_mask, 0.0, NEG).astype(jnp.float32),
                   ((0, 0), (0, kp - Kp)), constant_values=NEG)
    pairs = pairs.astype(jnp.int32)
    whole = lambda x: pl.BlockSpec(x.shape, lambda p, r, s: (0,) * x.ndim)
    out_spec = pl.BlockSpec((None, None, block_q), lambda p, r, s: (s, p, r))
    # inside shard_map the outputs vary over the mesh axes the inputs vary on
    vma = frozenset().union(*(jax.typeof(x).vma for x in (pairs, q16, p16,
                                                            bias)))
    out = lambda dt: jax.ShapeDtypeStruct((split, Np, kq), dt, vma=vma)
    s1, i1, s2 = pl.pallas_call(
        partial(_top2_kernel, block_q=block_q, block_p=block_p, tiles=tiles),
        grid=(Np, kq // block_q, split),
        in_specs=[pl.BlockSpec((None, 2), lambda p, r, s: (p, 0)),
                  whole(q16), whole(p16), whole(bias)],
        out_specs=[out_spec] * 3,
        out_shape=[out(jnp.float32), out(jnp.int32), out(jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="sfmx_top2",
    )(pairs, q16, p16, bias)
    s1, i1, s2 = _merge_splits(s1, i1, s2) if split > 1 else (s1[0], i1[0],
                                                              s2[0])
    return s1[:, :Kq], i1[:, :Kq], s2[:, :Kq]


# ---------------------------------------------------------------------------
# Plain versions (XLA)
# ---------------------------------------------------------------------------

def _sim(q, pool):
    return jnp.dot(q.astype(jnp.bfloat16), pool.astype(jnp.bfloat16).T,
                   precision=jax.lax.Precision.DEFAULT,
                   preferred_element_type=jnp.float32)


@jax.jit
def top2_reference(q, pool, pool_mask):
    """Dense bf16 GEMM + ``top_k``: writes the whole (Q, P) similarity."""
    sim = jnp.where(pool_mask[None, :], _sim(q, pool), NEG)
    v, i = jax.lax.top_k(sim, 2)
    return v[:, 0], i[:, 0], v[:, 1]


@partial(jax.jit, static_argnames=("chunk",))
def top2_scan(q, pool, pool_mask, *, chunk: int = 8192):
    """``lax.scan`` over candidate chunks with a running top-2: device
    memory O(Q x chunk), independent of the pool size."""
    P, D = pool.shape
    chunk = min(chunk, round_up(P, 8))
    pp = round_up(P, chunk)
    pool = jnp.pad(pool, ((0, pp - P), (0, 0))).reshape(-1, chunk, D)
    mask = jnp.pad(pool_mask, (0, pp - P)).reshape(-1, chunk)

    def tile_top2(tile, m, off):
        v, i = jax.lax.top_k(jnp.where(m[None, :], _sim(q, tile), NEG), 2)
        return v[:, 0], i[:, 0] + off, v[:, 1]

    def step(carry, xs):
        s1, i1, s2 = carry
        t1, ti, t2 = tile_top2(*xs)
        return (jnp.maximum(s1, t1), jnp.where(t1 > s1, ti, i1),
                jnp.maximum(jnp.minimum(s1, t1), jnp.maximum(s2, t2))), None

    offs = jnp.arange(pool.shape[0], dtype=jnp.int32) * chunk
    # the first chunk seeds the carry, so it varies over the same mesh axes
    # as the data when this runs inside shard_map
    init = tile_top2(pool[0], mask[0], offs[0])
    (s1, i1, s2), _ = jax.lax.scan(step, init, (pool[1:], mask[1:], offs[1:]))
    return s1, i1, s2


def top2(q, pool, pool_mask):
    """Top-2 of every row of ``q`` (Q, D) over ``pool`` (P, D) where
    ``pool_mask``: the kernel on the GPU, ``top2_scan`` on the CPU."""
    if backend.use_kernels():
        s1, i1, s2 = top2_kernel(q[None], pool[None], pool_mask[None],
                                 jnp.zeros((1, 2), jnp.int32))
        return s1[0], i1[0], s2[0]
    return top2_scan(q, pool, pool_mask)


def match_float_streaming(desc_a, desc_b, mask_a, mask_b, *,
                          ratio: float = 0.8):
    """Ratio-test matching of every A row against the whole pool B, without
    the (Ka, Kb) similarity and without a cross-check pass."""
    from .matching import MatchResult, ratio_accept

    s1, i1, s2 = top2(desc_a, desc_b, mask_b)
    return MatchResult(idx=i1, valid=ratio_accept(s1, s2, ratio) & mask_a,
                       score=s1)
