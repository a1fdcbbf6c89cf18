"""Grid MHSA core for tiny grids: the CUDA kernels ``csrc/grid_mhsa_th.cu`` and
``csrc/grid_mhsa.cu`` (forward and backward) and their plain PyTorch
versions. They stand for two TPU kernels of
``outgridvit_tpu/ops/grid_attention_pallas_t.py`` that compute the same math
in different VMEM layouts: ``grid_mhsa_pallas_t`` (#1, variant ``"t"``, every
grid of N <= 16) and the head-chunked ``grid_mhsa_pallas_th`` (#3, variant
``"th"``, the wide-C N=16 grids of the 64px configs and the default Model
A). The variant names the JAX kernel; dtype and shape pick the CUDA one,
before the launch (:func:`grid_mhsa_entry`):

- every bf16 launch at 1 <= N <= 16 with a head width that is a multiple
  of 8 up to 64, of either tag, runs ``csrc/grid_mhsa_th.cu`` (one warp per
  head of 16 // N adjacent grids on ``mma.sync`` tiles, block-diagonally
  masked below N = 16; launch plan :func:`grid_mhsa_th_plan`, asked of the
  kernel's layout header). A bf16 ``"th"`` launch it does not take raises;
- fp32 launches (the parity path), and a bf16 ``"t"`` launch at a head
  width it does not take, run ``csrc/grid_mhsa.cu`` (one block per grid,
  fp32 staging).

Launches are counted per variant (``grid_mhsa.by_variant``) and per C entry
point (``grid_mhsa.by_entry``).

Forward, per grid and head: ``softmax(q.k^T * hd^-1/2) v`` with the q.k sum
in fp32 scaled after the sum, an fp32 softmax with max subtraction, and the
P.V sum in fp32 cast once (the kernels' rounding points). The backward
recomputes the probabilities from qkv and casts dq, dk and dv once
(:func:`grid_mhsa_backward_reference`).

``grid_mhsa_reference(..., round_probs=True)`` is the other rounding point,
used by every JAX path for grids of N > 16 tokens (the XLA path,
``models/blocks.py:394``, and the block-packed kernels' ``_attn_tile``):
the probabilities are normalized by division and cast to the compute dtype
before P.V.

The block-packed TPU kernel ``outgridvit_tpu/ops/grid_attention_pallas.py:
grid_mhsa_pallas`` (#6) computes that forward; its backward recomputes the
probabilities by division and keeps them in fp32
(:func:`grid_mhsa_packed_backward_reference`). The JAX model runs it for
grids of 16 < N < 64 tokens, and for grids of N >= 64 that the fused branch
(#5) cannot hold, at any N. It packs ``32 // N`` grids of N < 16 tokens
block-diagonally under a -1e30 mask, a layout device only: ``exp`` of a
masked logit is exactly 0 in fp32. Its Hopper kernels
(:func:`grid_mhsa_packed`, :func:`grid_mhsa_packed_backward`) pack nothing
and take 1 <= N <= 4096, in four C sources by N and dtype:

- 1 <= N <= 63, bf16: ``csrc/grid_mhsa_packed_mma.cu`` (one warp per grid
  and head on ``mma.sync`` tiles, launch plan :func:`grid_mhsa_packed_plan`);
- 1 <= N <= 63, fp32 (the parity path): ``csrc/grid_mhsa_packed.cu`` (one
  block per grid, fp32 staging);
- 64 <= N <= 256 in bf16, 64 <= N <= 4096 in fp32: ``csrc/grid_mhsa_long.cu``
  (one block per grid and head that streams the key tiles in exact passes,
  bf16 on ``mma.sync`` tiles, launch plan :func:`grid_mhsa_long_plan`);
- 257 <= N <= 4096, bf16: ``csrc/grid_mhsa_tiles.cu`` (a head's query rows
  cut into blocks that stream the keys in chunks through a ring of shared
  buffers, the same passes; the backward a query-row kernel, then a key-row
  kernel, through an fp32 scratch of each query row's D; launch plan
  :func:`grid_mhsa_tiles_plan`, asked of the kernels' layout header).
  Asked to (``save_stats``), its forward also keeps each query row's max,
  sum and 1 / sum, an fp32 ``[G * heads, 3, covered]``, which its backward
  needs: its query kernel walks the keys twice, not four times
  (:func:`grid_mhsa_tiles_stats_reference` is the plain version).

The bf16 kernels and the long one take a head width that is a multiple of 8
up to 64 and raise on any other, as on N > 4096. Launches are counted per C
entry point (``grid_mhsa_packed.by_entry``).

:func:`grid_mhsa_autograd` and :func:`grid_mhsa_packed_autograd` are the
differentiable cores the model calls: ``torch.autograd.Function``s that
save qkv, and #6 under grad past 256 tokens in bf16 also the forward's row
statistics. That departs from JAX's residuals (``_fwd_vjp`` saves only qkv),
not from its arithmetic: the statistics are those the backward would
recompute, bit for bit. A forward without grad keeps none.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache, partial
from typing import NamedTuple

import torch

from outgridvit_tpu_torch.ops import kernel_build

MAX_TOKENS = 16  # the JAX dispatch runs this kernel for N <= 16
PACKED_MAX_TOKENS = 63  # and #6 for 16 < N < 64 (and N >= 64 past #5)
LONG_MAX_TOKENS = 256  # csrc/grid_mhsa_long.cu takes 64 <= N <= 256 in bf16
# and 64 <= N <= 4096 in fp32; csrc/grid_mhsa_tiles.cu 257 <= N <= 4096 in
# bf16 (csrc/grid_mhsa_tiles_layout.h:kMaxN)
TILES_MAX_TOKENS = 4096
VARIANTS = ("t", "th")  # grid_mhsa_pallas_t (#1), grid_mhsa_pallas_th (#3)


# ---- the tensor-core kernel's launch plan (csrc/grid_mhsa_th.cu) ----------

# one H100 SM: shared memory (each block reserves 1 KB more), registers,
# threads and blocks; the most one block may ask for; the SMs of an H100 SXM
SM_SMEM, SM_BLOCK_RESERVED = 228 * 1024, 1024
SM_REGS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
BLOCK_SMEM, SMS = 227 * 1024, 132


def blocks_per_sm(warps: int, smem: int, regs: int) -> int:
    """Blocks of ``warps`` warps, ``smem`` shared bytes and ``regs``
    registers a thread that one H100 SM holds at once."""
    return min(SM_REGS // (regs * 32 * warps),
               SM_SMEM // (smem + SM_BLOCK_RESERVED),
               SM_THREADS // (32 * warps), SM_BLOCKS)


class ThPlan(NamedTuple):
    """How ``ogvt_grid_mhsa_th[_bwd]`` cuts one call: ``warps`` per block,
    each one unit (one head of ``grids_per_unit`` adjacent grids,
    ``grids_per_block`` grids' worth a block), ``blocks`` in all;
    ``smem_bytes`` of a block (``tiles`` staged ``[16, hd]`` bf16 tiles a
    warp, rows ``row_bytes`` apart); and what one SM holds at the kernel's
    register cap ``regs``: ``blocks_per_sm`` blocks, ``grids_in_flight``
    grids' worth of units. Everything but the counts comes from
    ``csrc/grid_mhsa_th_layout.h``."""
    warps: int
    blocks: int
    grids_per_block: float
    tiles: int
    row_bytes: int
    smem_bytes: int
    regs: int
    blocks_per_sm: int
    grids_in_flight: float
    grids_per_unit: int


def th_row_bytes(hd: int) -> int:
    """Row stride of a staged bf16 tile of #6's kernels: hd / 8 16-byte
    units made odd, so the 8 rows one ldmatrix reads fall in 8 distinct
    bank groups."""
    return 16 * ((hd // 8) | 1)


@lru_cache(maxsize=None)
def _th_layout(N: int, C: int, heads: int, backward: bool):
    """``csrc/grid_mhsa_th_layout.h``'s layout for the shape (warps, shared
    bytes, register cap, grids a unit, tiles a warp, row bytes), or None
    where the kernel does not take it."""
    out = (ctypes.c_int * 6)()
    if kernel_build.load_layouts().ogvt_grid_mhsa_th_layout(
            N, C, heads, int(backward), out):
        return None
    return tuple(out)


def th_takes(N: int, C: int, heads: int) -> bool:
    """Whether ``csrc/grid_mhsa_th.cu`` takes grids of N tokens, C channels
    and ``heads`` heads (1 <= N <= 16, a head width that is a multiple of 8
    up to 64), as its layout header says."""
    return _th_layout(N, C, heads, False) is not None


@lru_cache(maxsize=None)
def grid_mhsa_th_plan(G: int, N: int, C: int, heads: int,
                      backward: bool) -> ThPlan:
    """The tensor-core kernel's launch plan for qkv ``[G, N, 3C]`` in bf16,
    or a ValueError naming the shape it does not take (N outside 1..16, a
    head width that is not a multiple of 8 in [8, 64]). Cached: the wrapper
    asks at every launch."""
    if G < 0 or heads <= 0 or C % heads:
        raise ValueError(f"grid_mhsa_th: G={G}, N={N}, C={C}, heads={heads}")
    layout = _th_layout(N, C, heads, backward)
    if layout is None:
        raise ValueError(
            f"grid_mhsa_th: N={N}, C={C}, heads={heads} (hd={C // heads}); "
            f"the kernel takes 1 <= N <= {MAX_TOKENS} and hd a multiple of 8 "
            "up to 64")
    warps, smem, regs, per, tiles, row = layout
    per_sm = blocks_per_sm(warps, smem, regs)
    units = -(-G // per) * heads
    return ThPlan(warps, -(-units // warps), warps * per / heads, tiles, row,
                  smem, regs, per_sm, per_sm * warps * per / heads, per)


# ---- #6's bf16 kernel's launch plan (csrc/grid_mhsa_packed_mma.cuh) -------

PACKED_WARPS = 4     # the most warps a block, one (grid, head) unit each
PACKED_MAX_HD = 64   # widest head (the accumulators' registers)
PACKED_ACC_TILE = 32 * 16  # one m16n8 fp32 accumulator tile, a float4 a lane


class PackedPlan(NamedTuple):
    """How ``ogvt_grid_mhsa_packed_mma[_bwd]`` cuts one call: ``warps`` per
    block, each one (grid, head) unit, ``blocks`` in all; ``row_tiles`` m16
    tiles of query rows and ``key_tiles`` n8 tiles of keys staged, rows
    ``row_bytes`` apart, ``smem_bytes`` a block (the backward's with its
    dv and dk accumulators); and, at the kernel's register cap ``regs``,
    what one SM holds (``blocks_per_sm`` blocks, ``units_per_sm`` units)
    and the ``waves`` of units the card's SMs take for the call."""
    warps: int
    blocks: int
    row_tiles: int
    key_tiles: int
    row_bytes: int
    smem_bytes: int
    regs: int
    blocks_per_sm: int
    units_per_sm: int
    waves: float


def packed_regs(key_tiles: int, nt: int, per_warp: int,
                backward: bool) -> int:
    """The register cap of the kernel instantiation for ``key_tiles`` n8
    tiles of keys, hd = 8 * ``nt`` and ``per_warp`` shared bytes a warp:
    ``__launch_bounds__(128, sm_blocks)`` of
    csrc/grid_mhsa_packed_mma.cuh, the blocks of 4 warps one SM holds by
    shared memory and by the fp32 values a lane keeps live, fitted so that
    ptxas spills at none (change the two together)."""
    if backward:
        live = 16 * -(-key_tiles // 2) + 8 * nt
        by_regs = 6 if live <= 40 else 4 if live <= 72 else 3
    else:
        live = 4 * key_tiles + 4 * nt + (8 if nt == 1 else 0)
        by_regs = 8 if live <= 32 else 6 if live <= 48 else 5
    by_smem = SM_SMEM // (PACKED_WARPS * per_warp + SM_BLOCK_RESERVED)
    blocks = max(1, min(by_smem, by_regs))
    return min(255, SM_REGS // (32 * PACKED_WARPS * blocks) // 8 * 8)


@lru_cache(maxsize=None)
def grid_mhsa_packed_plan(G: int, N: int, C: int, heads: int,
                          backward: bool) -> PackedPlan:
    """#6's bf16 kernel's launch plan for qkv ``[G, N, 3C]``, or a
    ValueError naming the shape it does not take (N outside 1..63, a head
    width that is not a multiple of 8 in [8, 64]). Of 1 to 4 warps a block,
    the one that keeps the most units on an SM (the most warps on a tie).
    Cached: the wrapper asks at every launch."""
    if G < 0 or heads <= 0 or C % heads:
        raise ValueError(
            f"grid_mhsa_packed: G={G}, N={N}, C={C}, heads={heads}")
    hd = C // heads
    if not 1 <= N <= PACKED_MAX_TOKENS or hd % 8 or \
            not 8 <= hd <= PACKED_MAX_HD:
        raise ValueError(
            f"grid_mhsa_packed: N={N}, C={C}, heads={heads} (hd={hd}); the "
            f"bf16 kernel takes 1 <= N <= {PACKED_MAX_TOKENS} and hd a "
            f"multiple of 8 up to {PACKED_MAX_HD}")
    kt8 = -(-N // 8)
    mt, nt, row = -(-kt8 // 2), hd // 8, th_row_bytes(hd)
    # q (and dO) rows, k and v rows; the backward's fp32 dv and dk
    per_warp = (((2 if backward else 1) * 16 * mt + 16 * kt8) * row
                + (2 * mt * nt * PACKED_ACC_TILE if backward else 0))
    regs = packed_regs(kt8, nt, per_warp, backward)
    best = None
    for warps in range(PACKED_WARPS, 0, -1):
        if warps * per_warp > BLOCK_SMEM:
            continue
        per_sm = blocks_per_sm(warps, warps * per_warp, regs)
        if best is None or per_sm * warps > best[1] * best[0]:
            best = (warps, per_sm)
    warps, per_sm = best
    units = G * heads
    return PackedPlan(warps, -(-units // warps), mt, kt8, row,
                      warps * per_warp, regs, per_sm, per_sm * warps,
                      units / (per_sm * warps * SMS))


# ---- #6's kernel for 64 <= N <= 256 (csrc/grid_mhsa_long.cu) -------------

LONG_MAX_HD = 64     # widest head (the accumulators' registers)
LONG_F32_WARPS = 4   # an fp32 block: 128 threads, two a row
# the kernels' register caps: bf16 __launch_bounds__(512, 2), 64 registers,
# for the forward at hd <= 32 and the backward at hd <= 16, (512, 1) above
# (csrc/grid_mhsa_long.cu:sm_blocks; change the two together); fp32 (128)
LONG_REGS = {"bfloat16": 64, "bfloat16_wide": 128, "float32": 255}


class LongPlan(NamedTuple):
    """How ``ogvt_grid_mhsa_long[_bwd]`` cuts one call: one block per
    (grid, head) unit, ``blocks`` in all, of ``warps`` warps (bf16: one per
    m16 tile of query rows, ``rows`` rows of q, k and v staged, ``row_bytes``
    apart; fp32: 4, two threads a row, nothing staged); ``smem_bytes`` a
    block (bf16: the staged tiles, and the backward's dO and dq tiles and
    four fp32 statistics a row; fp32: the backward's three); and, at
    the kernel's register cap ``regs``, the ``blocks_per_sm`` one SM holds
    at least."""
    warps: int
    blocks: int
    rows: int
    row_bytes: int
    smem_bytes: int
    regs: int
    blocks_per_sm: int


@lru_cache(maxsize=None)
def grid_mhsa_long_plan(G: int, N: int, C: int, heads: int, backward: bool,
                        dtype: str = "bfloat16") -> LongPlan:
    """#6's kernel for long grids, its launch plan for qkv ``[G, N, 3C]`` of
    ``dtype`` ("bfloat16" or "float32"), or a ValueError naming the shape it
    does not take (N outside 64..256 in bf16, 64..4096 in fp32; a head width
    that is not a multiple of 8 in [8, 64]). Cached: the wrapper asks at
    every launch."""
    if G < 0 or heads <= 0 or C % heads:
        raise ValueError(f"grid_mhsa_long: G={G}, N={N}, C={C}, "
                         f"heads={heads}")
    hd = C // heads
    top = TILES_MAX_TOKENS if dtype == "float32" else LONG_MAX_TOKENS
    if not PACKED_MAX_TOKENS < N <= top or hd % 8 or \
            not 8 <= hd <= LONG_MAX_HD:
        raise ValueError(
            f"grid_mhsa_long: N={N}, C={C}, heads={heads} (hd={hd}); the "
            f"kernel takes {PACKED_MAX_TOKENS + 1} <= N <= {top} in {dtype} "
            f"and hd a multiple of 8 up to {LONG_MAX_HD} (ROADMAP.md §2)")
    if dtype == "bfloat16":
        warps = -(-N // 16)
        rows, row = 16 * warps, th_row_bytes(hd)
        smem = (5 if backward else 3) * rows * row + \
            (4 * 4 * rows if backward else 0)
    elif dtype == "float32":
        warps, rows, row = LONG_F32_WARPS, 0, 0
        smem = 3 * 4 * N if backward else 0
    else:
        raise ValueError(f"grid_mhsa_long: dtype {dtype!r} is not bfloat16 "
                         "or float32")
    wide = hd > (16 if backward else 32)
    regs = LONG_REGS["bfloat16_wide" if dtype == "bfloat16" and wide
                     else dtype]
    return LongPlan(warps, G * heads, rows, row, smem, regs,
                    blocks_per_sm(warps, smem, regs))


# ---- #6's bf16 kernels for N > 256 (csrc/grid_mhsa_tiles.cu) --------------

class TilesPlan(NamedTuple):
    """How ``ogvt_grid_mhsa_tiles[_bwd]`` cuts one call: each (grid, head)
    unit's rows in ``parts`` blocks of ``warps`` warps (one per m16 tile of
    the block's own rows: query rows forward and in the backward's query
    kernel, key rows in its key kernel), ``rows`` a block and ``covered``
    (>= N) a unit, ``blocks`` a kernel in all; the other side's rows stream
    in chunks of ``chunk`` rows through ``stages`` shared buffers, staged
    rows ``row_bytes`` apart; ``smem_bytes`` a block of the forward or of
    the backward's query kernel, ``smem_key`` of its key kernel (0
    forward); ``scratch_floats``, the backward's fp32 scratch of the call
    (D, 1 a covered row a unit; 0 forward); ``saved_floats``, the fp32
    statistics the forward keeps under grad and the backward reads (3 a
    covered row a unit); and, at the kernels' register caps ``regs`` /
    ``regs_key``, the blocks one SM holds (``blocks_per_sm`` /
    ``blocks_per_sm_key``). Everything but the counts comes from
    ``csrc/grid_mhsa_tiles_layout.h``."""
    parts: int
    warps: int
    blocks: int
    rows: int
    covered: int
    chunk: int
    stages: int
    row_bytes: int
    smem_bytes: int
    smem_key: int
    scratch_floats: int
    saved_floats: int
    regs: int
    regs_key: int
    blocks_per_sm: int
    blocks_per_sm_key: int


@lru_cache(maxsize=None)
def _tiles_layout(N: int, C: int, heads: int, backward: bool):
    """``csrc/grid_mhsa_tiles_layout.h``'s layout for the shape (blocks a
    unit, warps, the two kernels' shared bytes and register caps, chunk
    rows, ring buffers, row bytes, scratch floats and saved statistics'
    floats a unit), or None where the kernels do not take it."""
    out = (ctypes.c_int * 11)()
    if kernel_build.load_layouts().ogvt_grid_mhsa_tiles_layout(
            N, C, heads, int(backward), out):
        return None
    return tuple(out)


@lru_cache(maxsize=None)
def grid_mhsa_tiles_plan(G: int, N: int, C: int, heads: int,
                         backward: bool) -> TilesPlan:
    """#6's bf16 kernels for grids of N > 256, their launch plan for qkv
    ``[G, N, 3C]``, or a ValueError naming the shape they do not take (N
    outside 257..4096, a head width that is not a multiple of 8 in [8,
    64]). Cached: the wrapper asks at every launch."""
    if G < 0 or heads <= 0 or C % heads:
        raise ValueError(f"grid_mhsa_tiles: G={G}, N={N}, C={C}, "
                         f"heads={heads}")
    layout = _tiles_layout(N, C, heads, backward)
    if layout is None:
        raise ValueError(
            f"grid_mhsa_tiles: N={N}, C={C}, heads={heads} (hd={C // heads}); "
            f"the bf16 kernels take {LONG_MAX_TOKENS + 1} <= N <= "
            f"{TILES_MAX_TOKENS} and hd a multiple of 8 up to {LONG_MAX_HD} "
            "(ROADMAP.md §2)")
    parts, warps, smem, smem_key, regs, regs_key, chunk, stages, row, \
        scratch, saved = layout
    rows = 16 * warps
    return TilesPlan(
        parts, warps, G * heads * parts, rows, rows * parts, chunk, stages,
        row, smem, smem_key, G * heads * scratch, G * heads * saved, regs,
        regs_key,
        blocks_per_sm(warps, smem, regs),
        blocks_per_sm(warps, smem_key, regs_key) if backward else 0)


def grid_mhsa_variant(N: int, C: int) -> str:
    """The JAX kernel a grid shape stands for: the head-chunked ``"th"`` for
    the wide-C N=16 grids whose full-C TPU blocks overflow VMEM (the 64px
    configs' stages 1-3, C >= 128; ``grid_attention_pallas_t.py:349-352``),
    ``"t"`` otherwise."""
    return "th" if N >= MAX_TOKENS and C >= 128 else "t"


def _check(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [G, N, 3C]; got {tuple(qkv.shape)}")
    G, N, C3 = qkv.shape
    if C3 % 3 or heads <= 0 or (C3 // 3) % heads:
        raise ValueError(
            f"qkv last dim {C3} must be 3*C with C divisible by heads={heads}")
    return G, N, C3 // 3


def _row_stats(q, k, hd):
    """exp(logit - max) of the scaled logits ``[G, heads, N, N]``, each
    row's max and the sum of its exps (``[G, heads, N, 1]``), fp32."""
    logits = torch.einsum("gnhd,gmhd->ghnm", q, k) * hd**-0.5
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    return e, m, e.sum(-1, keepdim=True)


def _probs(q, k, hd, divide=False, stats=None):
    """The fp32 probabilities, from the rows' statistics as
    :func:`_row_stats` computes them, or as given: ``stats`` in
    :func:`grid_mhsa_tiles_stats_reference`'s layout."""
    if stats is None:
        e, _, s = _row_stats(q, k, hd)
    else:
        G, N, heads = q.shape[:3]
        m, s = (stats[:, i, :N].reshape(G, heads, N, 1) for i in (0, 1))
        e = torch.exp(torch.einsum("gnhd,gmhd->ghnm", q, k) * hd**-0.5 - m)
    return e / s if divide else e * (1.0 / s)


def grid_mhsa_reference(qkv: torch.Tensor, heads: int,
                        round_probs: bool = False,
                        probs=None) -> torch.Tensor:
    """Plain PyTorch version: qkv [G, N, 3C] -> [G, N, C]. ``round_probs``
    divides by the softmax sum and casts the probabilities to qkv's dtype
    before P.V (the JAX rounding point for N > 16); without it they stay
    fp32 (kernels #1 and #3). ``probs``, a function applied to the fp32
    probabilities ``[G, heads, N, N]`` before their cast (a dropout), is
    the JAX XLA path's ``attn_drop`` (``round_probs`` only)."""
    G, N, C = _check(qkv, heads)
    hd = C // heads
    q, k, v = qkv.float().reshape(G, N, 3, heads, hd).unbind(2)
    a = _probs(q, k, hd, divide=round_probs)
    if probs is not None:
        a = probs(a)
    if round_probs:
        a = a.to(qkv.dtype).float()
    out = torch.einsum("ghnm,gmhd->gnhd", a, v)
    return out.to(qkv.dtype).reshape(G, N, C)


def grid_mhsa_backward_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                 heads: int, divide: bool = False,
                                 stats=None) -> torch.Tensor:
    """Plain PyTorch version of the backward: (qkv [G, N, 3C], dout
    [G, N, C]) -> dqkv [G, N, 3C], with the rounding points of the Pallas
    ``_bwd_kernel``: fp32 q, k, v and dO; recomputed fp32 probabilities a
    (normalized by division with ``divide``, as #6 does; from the rows'
    max and sum in ``stats`` where given, else recomputed);
    ``dp = dO.v^T``; ``ds = a * (dp - sum_m dp*a)``; dq and dk multiplied by
    the scale before the single cast, dv cast once."""
    G, N, C = _check(qkv, heads)
    hd = C // heads
    scale = hd**-0.5
    q, k, v = qkv.float().reshape(G, N, 3, heads, hd).unbind(2)
    g = dout.float().reshape(G, N, heads, hd)
    a = _probs(q, k, hd, divide, stats)
    dp = torch.einsum("gnhd,gmhd->ghnm", g, v)
    ds = a * (dp - (dp * a).sum(-1, keepdim=True))
    dq = torch.einsum("ghnm,gmhd->gnhd", ds, k) * scale
    dk = torch.einsum("ghnm,gnhd->gmhd", ds, q) * scale
    dv = torch.einsum("ghnm,gnhd->gmhd", a, g)
    return torch.stack([dq, dk, dv], 2).to(qkv.dtype).reshape(G, N, 3 * C)


def grid_mhsa_packed_reference(qkv: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch version of #6's forward (``grid_attention_pallas.py:
    _attn_tile``): ``grid_mhsa_reference(..., round_probs=True)``."""
    return grid_mhsa_reference(qkv, heads, round_probs=True)


def grid_mhsa_packed_backward_reference(qkv: torch.Tensor,
                                        dout: torch.Tensor, heads: int,
                                        stats=None) -> torch.Tensor:
    """Plain PyTorch version of #6's backward (``grid_attention_pallas.py:
    _bwd_kernel``): :func:`grid_mhsa_backward_reference` with the
    probabilities recomputed by division and kept in fp32 (dv sees the
    unrounded a, unlike autograd of the forward); from the forward's row
    statistics ``stats`` where given (:func:`grid_mhsa_tiles_stats_reference`
    gives them bitwise as this function recomputes them)."""
    return grid_mhsa_backward_reference(qkv, dout, heads, divide=True,
                                        stats=stats)


def grid_mhsa_tiles_stats_reference(qkv: torch.Tensor,
                                    heads: int) -> torch.Tensor:
    """Plain PyTorch version of the row statistics #6's forward past 256
    tokens keeps for its backward: qkv [G, N, 3C] -> fp32 ``[G * heads, 3,
    covered]`` (``covered``: :func:`grid_mhsa_tiles_plan`'s rows a unit)
    holding each query row's max of the scaled logits, the sum of exp(logit
    - max) and 1 / sum, as :func:`grid_mhsa_packed_backward_reference`
    computes them; rows past N are the kernel's zero q rows' (0, N, 1 /
    N)."""
    G, N, C = _check(qkv, heads)
    hd = C // heads
    covered = grid_mhsa_tiles_plan(G, N, C, heads, False).covered
    q, k, _ = qkv.float().reshape(G, N, 3, heads, hd).unbind(2)
    _, m, s = _row_stats(q, k, hd)
    out = torch.empty(G * heads, 3, covered, dtype=torch.float32,
                      device=qkv.device)
    out[:, 0, :N] = m.reshape(G * heads, N)
    out[:, 1, :N] = s.reshape(G * heads, N)
    out[:, 0, N:], out[:, 1, N:] = 0.0, float(N)
    out[:, 2] = 1.0 / out[:, 1]
    return out


def _check_launch(name: str, qkv: torch.Tensor, heads: int, smem_floats,
                  variant=None, max_tokens: int = MAX_TOKENS,
                  beyond: str = ""):
    G, N, C = _check(qkv, heads)
    if variant is not None:
        kernel_build.check_variant(name, variant, VARIANTS)
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {qkv.dtype} is not float32/bfloat16")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if not 1 <= N <= max_tokens:
        raise ValueError(
            f"{name}: N={N} tokens per grid; the kernel takes "
            f"1..{max_tokens}{beyond}")
    if smem_floats is not None and smem_floats(N, C) * 4 > BLOCK_SMEM:
        raise ValueError(f"{name}: grid of N={N}, C={C}, heads={heads} "
                         "exceeds shared memory")
    return G, N, C


def _check_dout(name, qkv, dout, G, N, C):
    if (dout.shape != (G, N, C) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous()):
        raise ValueError(
            f"{name}: dout is {tuple(dout.shape)} {dout.dtype} "
            f"on {dout.device}; expected contiguous {(G, N, C)} {qkv.dtype} "
            f"on {qkv.device}")


ENTRIES = ("ogvt_grid_mhsa_th", "ogvt_grid_mhsa")
BACKWARD_ENTRIES = ("ogvt_grid_mhsa_th_bwd", "ogvt_grid_mhsa_bwd")


def grid_mhsa_entry(N: int, C: int, heads: int, dtype: torch.dtype,
                    variant: str, backward: bool = False) -> str:
    """The C entry point a launch of these shapes takes, decided by dtype,
    shape and tag alone: ``csrc/grid_mhsa_th.cu``'s for a bf16 ``"th"``
    launch (whose plan raises on a shape the kernel does not take) and for
    every bf16 launch it takes (:func:`th_takes`); ``csrc/grid_mhsa.cu``'s
    for fp32 and for a bf16 ``"t"`` launch it does not take."""
    th = dtype == torch.bfloat16 and (variant == "th"
                                      or th_takes(N, C, heads))
    return (ENTRIES if not backward else BACKWARD_ENTRIES)[0 if th else 1]


def _mma_plan(name: str, planner, qkv: torch.Tensor, heads: int,
              backward: bool, *others):
    """The plan of an ``mma.sync`` kernel (``planner``:
    :func:`grid_mhsa_th_plan` or :func:`grid_mhsa_packed_plan`) for qkv,
    its tensors (qkv and ``others``, (label, tensor) pairs) 16-byte aligned,
    or a ValueError."""
    G, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    plan = planner(G, N, C, heads, backward)
    for label, t in (("qkv", qkv), *others):
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} of shape {tuple(t.shape)} at "
                f"{t.data_ptr():#x} is not 16-byte aligned; the kernel "
                "copies 16 bytes at a time")
    return plan


def grid_mhsa(qkv: torch.Tensor, heads: int,
              variant: str = "t") -> torch.Tensor:
    """qkv [G, N, 3C] -> [G, N, C]. A CUDA tensor launches a kernel (or
    raises), the one :func:`grid_mhsa_entry` names; a CPU tensor takes
    :func:`grid_mhsa_reference`. ``variant`` names the JAX kernel the launch
    stands for (:data:`VARIANTS`). Under tracing it is the op
    ``ogvt::grid_mhsa`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("grid_mhsa")(qkv, heads, variant)
    if qkv.device.type == "cpu":
        return grid_mhsa_reference(qkv, heads)
    return _launch(None, qkv, heads, variant)


grid_mhsa.launches = 0
grid_mhsa.by_variant = Counter()
grid_mhsa.by_entry = Counter()


def grid_mhsa_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                       variant: str = "t") -> torch.Tensor:
    """(qkv [G, N, 3C], dout [G, N, C]) -> dqkv [G, N, 3C]. A CUDA tensor
    launches a kernel (or raises), chosen as in :func:`grid_mhsa`; a CPU
    tensor takes :func:`grid_mhsa_backward_reference`. ``variant`` as in
    :func:`grid_mhsa`."""
    if qkv.device.type == "cpu":
        return grid_mhsa_backward_reference(qkv, dout, heads)
    return _launch(None, qkv, heads, variant, dout)


grid_mhsa_backward.launches = 0
grid_mhsa_backward.by_variant = Counter()
grid_mhsa_backward.by_entry = Counter()


def _launch(entry, qkv: torch.Tensor, heads: int, variant: str = "t",
            dout=None) -> torch.Tensor:
    """:func:`grid_mhsa` (or, given ``dout``, :func:`grid_mhsa_backward`)
    on the card through the C entry point ``entry`` (one of
    :data:`ENTRIES` / :data:`BACKWARD_ENTRIES`), or
    :func:`grid_mhsa_entry`'s where it is None. A named entry is for
    comparing the two kernels on the same inputs (``chip_smoke.py``'s A/B,
    the card tests). Counted on the wrapper of its direction."""
    backward = dout is not None
    name = "grid_mhsa_backward" if backward else "grid_mhsa"
    G, N, C = _check(qkv, heads)
    entries = BACKWARD_ENTRIES if backward else ENTRIES
    if entry is None:
        entry = grid_mhsa_entry(N, C, heads, qkv.dtype, variant, backward)
    elif entry not in entries:
        raise ValueError(f"{name}: entry {entry!r} is not one of {entries}")
    th = entry == entries[0]
    fp32_smem = ((lambda N, C: N * 4 * C + 2 * heads * N * N) if backward
                 else (lambda N, C: N * 3 * C + heads * N * N))
    _check_launch(name, qkv, heads, None if th else fp32_smem, variant)
    others = ()
    if backward:
        _check_dout(name, qkv, dout, G, N, C)
        others = (("dout", dout),)
    plan = (_mma_plan(name, grid_mhsa_th_plan, qkv, heads, backward, *others)
            if th else None)
    out = (torch.empty_like(qkv) if backward else
           torch.empty((G, N, C), dtype=qkv.dtype, device=qkv.device))
    ins = (qkv.data_ptr(),) + ((dout.data_ptr(),) if backward else ())
    lib = kernel_build.load()
    scale = ctypes.c_float((C // heads) ** -0.5)
    dtype = kernel_build.DTYPE_CODES[qkv.dtype]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = ((plan.warps, plan.smem_bytes) if th else ())
        err = getattr(lib, entry)(*ins, out.data_ptr(), G, N, C, heads,
                                  scale, *launch, dtype, stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    kernel_build.count_launch(grid_mhsa_backward if backward else grid_mhsa,
                              variant, entry)
    return out


class _GridMHSA(torch.autograd.Function):
    """Recompute style, as ``_fwd_vjp``/``_bwd_vjp``: saves only qkv."""

    @staticmethod
    def forward(ctx, qkv, heads, use_kernels, variant):
        ctx.save_for_backward(qkv)
        ctx.cfg = (heads, use_kernels, variant)
        if use_kernels:
            return grid_mhsa(qkv, heads, variant)
        return grid_mhsa_reference(qkv, heads)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        heads, use_kernels, variant = ctx.cfg
        if use_kernels:
            dqkv = grid_mhsa_backward(qkv, dout.contiguous(), heads, variant)
        else:
            dqkv = grid_mhsa_backward_reference(qkv, dout.contiguous(), heads)
        return dqkv, None, None, None


def grid_mhsa_autograd(qkv: torch.Tensor, heads: int, use_kernels: bool,
                       variant: str = "t") -> torch.Tensor:
    """Differentiable grid MHSA core: the kernels (:func:`grid_mhsa`,
    :func:`grid_mhsa_backward`) with ``use_kernels``, else the plain
    versions, both ways."""
    return _GridMHSA.apply(qkv, heads, use_kernels, variant)


def packed_smem_floats(N: int, C: int, heads: int, backward: bool) -> int:
    """Shared-memory floats of one block of ``csrc/grid_mhsa_packed.cu``
    (the fp32 launches): one head's q, k, v (and dO) rows and its [N, N]
    probabilities (and ds), rows padded by one float."""
    hd = C // heads
    if backward:
        return 4 * N * (hd + 1) + 2 * N * (N + 1)
    return 3 * N * (hd + 1) + N * (N + 1)


def grid_mhsa_packed_entry(N: int, dtype: torch.dtype,
                           backward: bool = False) -> str:
    """The C entry point a #6 launch of grids of N tokens in ``dtype``
    takes, by N and dtype alone: ``csrc/grid_mhsa_tiles.cu``'s for bf16
    past 256 tokens, ``csrc/grid_mhsa_long.cu``'s from 64 tokens on (fp32
    past 256 too), below that ``csrc/grid_mhsa_packed_mma.cu``'s in bf16
    and ``csrc/grid_mhsa_packed.cu``'s in fp32."""
    bf16 = dtype == torch.bfloat16
    entry = ("ogvt_grid_mhsa_tiles" if bf16 and N > LONG_MAX_TOKENS
             else "ogvt_grid_mhsa_long" if N > PACKED_MAX_TOKENS
             else "ogvt_grid_mhsa_packed_mma" if bf16
             else "ogvt_grid_mhsa_packed")
    return entry + ("_bwd" if backward else "")


def _packed_launch(name: str, qkv: torch.Tensor, heads: int, backward: bool,
                   *others):
    """(G, N, C, entry, plan) of a #6 launch: the C entry point
    (:func:`grid_mhsa_packed_entry`) and its launch plan (None for the fp32
    kernel of N <= 63, whose block must fit shared memory); or a
    ValueError."""
    entry = grid_mhsa_packed_entry(_check(qkv, heads)[1], qkv.dtype,
                                   backward)
    base = entry.removesuffix("_bwd")
    G, N, C = _check_launch(
        name, qkv, heads,
        (lambda N, C: packed_smem_floats(N, C, heads, backward))
        if base == "ogvt_grid_mhsa_packed" else None,
        max_tokens=TILES_MAX_TOKENS, beyond=" (ROADMAP.md §2)")
    if backward:
        _check_dout(name, qkv, others[0][1], G, N, C)
    if base == "ogvt_grid_mhsa_packed":
        return G, N, C, entry, None
    planner = {"ogvt_grid_mhsa_tiles": grid_mhsa_tiles_plan,
               "ogvt_grid_mhsa_packed_mma": grid_mhsa_packed_plan}.get(
        base, partial(grid_mhsa_long_plan,
                      dtype=str(qkv.dtype).removeprefix("torch.")))
    return G, N, C, entry, _mma_plan(name, planner, qkv, heads, backward,
                                     *others)


def keeps_stats(N: int, dtype: torch.dtype) -> bool:
    """Whether #6's forward on grids of N tokens in ``dtype`` keeps row
    statistics for its backward (``save_stats``): where it takes
    ``csrc/grid_mhsa_tiles.cu``, bf16 past 256 tokens."""
    return grid_mhsa_packed_entry(N, dtype) == "ogvt_grid_mhsa_tiles"


def grid_mhsa_packed(qkv: torch.Tensor, heads: int, save_stats: bool = False):
    """#6's forward, qkv [G, N, 3C] -> [G, N, C]: probabilities divided by
    their sum and cast to qkv's dtype before P.V. A CUDA tensor launches a
    kernel (or raises): for N <= 63 ``csrc/grid_mhsa_packed_mma.cu`` in
    bf16, ``csrc/grid_mhsa_packed.cu`` in fp32; for 64 <= N <= 256 (fp32:
    up to 4096) ``csrc/grid_mhsa_long.cu``; for 257 <= N <= 4096 in bf16
    ``csrc/grid_mhsa_tiles.cu``; a CPU tensor takes
    :func:`grid_mhsa_packed_reference`. With ``save_stats`` it returns (out,
    stats): the row statistics the backward takes where the launch keeps
    them (:func:`keeps_stats`; on the CPU
    :func:`grid_mhsa_tiles_stats_reference`), else None. Under tracing it is
    the op ``ogvt::grid_mhsa_packed`` (``ops/library.py``), which keeps
    none."""
    if kernel_build.tracing():
        if save_stats:
            raise ValueError("grid_mhsa_packed: the traced op keeps no row "
                             "statistics")
        return kernel_build.traced_op("grid_mhsa_packed")(qkv, heads)
    if qkv.device.type == "cpu":
        out = grid_mhsa_packed_reference(qkv, heads)
        if not save_stats:
            return out
        keep = keeps_stats(_check(qkv, heads)[1], qkv.dtype)
        return out, (grid_mhsa_tiles_stats_reference(qkv, heads) if keep
                     else None)
    return _launch_packed(qkv, heads, save_stats)


def _launch_packed(qkv: torch.Tensor, heads: int, save_stats: bool = False):
    """:func:`grid_mhsa_packed` on the card."""
    G, N, C, entry, plan = _packed_launch("grid_mhsa_packed", qkv, heads,
                                          False)
    out = torch.empty((G, N, C), dtype=qkv.dtype, device=qkv.device)
    stats = None
    if save_stats and isinstance(plan, TilesPlan):
        stats = torch.empty((G * heads, 3, plan.covered), dtype=torch.float32,
                            device=qkv.device)
    lib = kernel_build.load()
    scale = ctypes.c_float((C // heads) ** -0.5)
    dtype = kernel_build.DTYPE_CODES[qkv.dtype]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is None:
            err = lib.ogvt_grid_mhsa_packed(
                qkv.data_ptr(), out.data_ptr(), G, N, C, heads, scale, dtype,
                stream)
        elif isinstance(plan, TilesPlan):
            err = lib.ogvt_grid_mhsa_tiles(
                qkv.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(), G, N, C, heads,
                scale, plan.parts, plan.warps, plan.smem_bytes, stream)
        else:
            err = getattr(lib, entry)(
                qkv.data_ptr(), out.data_ptr(), G, N, C, heads, scale,
                plan.warps, plan.smem_bytes, dtype, stream)
    kernel_build.check(err, f"grid_mhsa_packed launch ({entry})")
    kernel_build.count_launch(grid_mhsa_packed, None, entry)
    return (out, stats) if save_stats else out


grid_mhsa_packed.launches = 0
grid_mhsa_packed.by_entry = Counter()


def _check_stats(qkv: torch.Tensor, stats, G, heads, plan):
    """The forward's row statistics a ``csrc/grid_mhsa_tiles.cu`` backward
    reads, or a ValueError: the launch needs them, contiguous fp32 ``[G *
    heads, 3, covered]`` on qkv's device."""
    want = (G * heads, 3, plan.covered)
    if stats is None:
        raise ValueError(
            "grid_mhsa_packed_backward: a bf16 launch past "
            f"{LONG_MAX_TOKENS} tokens needs the forward's row statistics "
            "(grid_mhsa_packed(..., save_stats=True))")
    if (tuple(stats.shape) != want or stats.dtype != torch.float32
            or stats.device != qkv.device or not stats.is_contiguous()):
        raise ValueError(
            f"grid_mhsa_packed_backward: stats is {tuple(stats.shape)} "
            f"{stats.dtype} on {stats.device}; expected contiguous {want} "
            f"torch.float32 on {qkv.device}")


def grid_mhsa_packed_backward(qkv: torch.Tensor, dout: torch.Tensor,
                              heads: int, stats=None) -> torch.Tensor:
    """#6's backward, (qkv [G, N, 3C], dout [G, N, C]) -> dqkv [G, N, 3C].
    A CUDA tensor launches a kernel (or raises), chosen as in
    :func:`grid_mhsa_packed`: for N > 256 in bf16 two kernels in one call
    that read the forward's row statistics ``stats`` (required there, and
    only there) and write D to an fp32 scratch they allocate; a CPU tensor
    takes :func:`grid_mhsa_packed_backward_reference` (from ``stats`` where
    given)."""
    if qkv.device.type == "cpu":
        return grid_mhsa_packed_backward_reference(qkv, dout, heads, stats)
    G, N, C, entry, plan = _packed_launch(
        "grid_mhsa_packed_backward", qkv, heads, True, ("dout", dout))
    tiles = isinstance(plan, TilesPlan)
    if tiles:
        _check_stats(qkv, stats, G, heads, plan)
    elif stats is not None:
        raise ValueError(
            f"grid_mhsa_packed_backward: {entry} takes no row statistics "
            f"(N={N}, {qkv.dtype})")
    dqkv = torch.empty_like(qkv)
    lib = kernel_build.load()
    scale = ctypes.c_float((C // heads) ** -0.5)
    dtype = kernel_build.DTYPE_CODES[qkv.dtype]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is None:
            err = lib.ogvt_grid_mhsa_packed_bwd(
                qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), G, N, C,
                heads, scale, dtype, stream)
        elif tiles:
            dsum = torch.empty(plan.scratch_floats, dtype=torch.float32,
                               device=qkv.device)
            err = lib.ogvt_grid_mhsa_tiles_bwd(
                qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                stats.data_ptr(), dsum.data_ptr(), G, N, C, heads, scale,
                plan.parts, plan.warps, plan.smem_bytes, plan.smem_key,
                stream)
        else:
            err = getattr(lib, entry)(
                qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), G, N, C,
                heads, scale, plan.warps, plan.smem_bytes, dtype, stream)
    kernel_build.check(err, f"grid_mhsa_packed_backward launch ({entry})")
    kernel_build.count_launch(grid_mhsa_packed_backward, None, entry)
    return dqkv


grid_mhsa_packed_backward.launches = 0
grid_mhsa_packed_backward.by_entry = Counter()


class _GridMHSAPacked(torch.autograd.Function):
    """#6 as ``_fwd_vjp``/``_bwd_vjp``: saves qkv, and with ``keep`` (autograd
    records) the forward's row statistics where the launch keeps them
    (:func:`keeps_stats`)."""

    @staticmethod
    def forward(ctx, qkv, heads, use_kernels, keep):
        ctx.cfg = (heads, use_kernels)
        if use_kernels and keep:
            out, stats = grid_mhsa_packed(qkv, heads, save_stats=True)
        else:
            fn = grid_mhsa_packed if use_kernels else \
                grid_mhsa_packed_reference
            out, stats = fn(qkv, heads), None
        ctx.save_for_backward(qkv, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, stats = ctx.saved_tensors
        heads, use_kernels = ctx.cfg
        if use_kernels:
            dqkv = grid_mhsa_packed_backward(qkv, dout.contiguous(), heads,
                                             stats)
        else:
            dqkv = grid_mhsa_packed_backward_reference(qkv, dout.contiguous(),
                                                       heads)
        return dqkv, None, None, None


def grid_mhsa_packed_autograd(qkv: torch.Tensor, heads: int,
                              use_kernels: bool) -> torch.Tensor:
    """Differentiable #6 core: the kernels (:func:`grid_mhsa_packed`,
    :func:`grid_mhsa_packed_backward`) with ``use_kernels``, else their
    plain versions, both ways. The forward keeps its row statistics only
    where autograd records a backward (grad enabled, qkv requiring it, not
    tracing)."""
    keep = (torch.is_grad_enabled() and qkv.requires_grad
            and not kernel_build.tracing())
    return _GridMHSAPacked.apply(qkv, heads, use_kernels, keep)
