"""Depthwise 3x3 convolution, stride 1, zero padding 1, no bias, NHWC: the
CUDA kernels ``csrc/dwconv.cu`` (forward and backward) and their plain
PyTorch versions. Twin of both TPU entry points of the family:

- ``outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:dwconv3x3_t`` (#10,
  ``OUTGRIDVIT_DW_T``): a kernel forward and a kernel backward;
- ``outgridvit_tpu/ops/experimental/dwconv_bwd_pallas.py:dwconv3x3`` (#11,
  ``OUTGRIDVIT_DW_BWD``): XLA's conv forward, then a one-pass kernel
  backward.

The two backwards compute the same function (dx and dw) in two TPU layouts,
so one CUDA kernel serves both; its launches are tagged with the JAX kernel
they stand for (``dwconv3x3_backward.by_variant``: ``"t"`` #10, ``"bwd"``
#11).

Layouts: x and dy ``[B, H, W, C]``; ``w9 [9, C]``, the taps row-major
(``t = 3*(dy+1) + (dx+1)``, ``_OFFS`` of both JAX files): the JAX kernel
``[3, 3, 1, C]`` reshaped, or the port's ``[C, 1, 3, 3]`` weight as
``reshape(C, 9).t()``.

Rounding points (the module casts the weight to the compute dtype first,
``outgridvit_tpu/models/layers.py:354, 361``):

- forward (#10 ``_fwd_kernel`` :81-92): x and w read as fp32, the 9 taps
  summed in fp32 in order, each product rounded apart, one cast;
- backward (#10 ``_bwd_kernel`` :95-126, #11 ``_bwd_kernel`` :77-107): dx =
  sum_t w[t] * dy[p - off_t] the same way, cast to x's dtype; dw[t, c] =
  sum_p x[p + off_t] * dy[p] in fp32, cast once to w9's dtype
  (``dwconv_pallas_t.py:238``, ``dwconv_bwd_pallas.py:223``). In bf16 the
  fp32 parameter's gradient passes through that one rounding; the cast of
  the weight back to fp32 in autograd is exact. Borders read zero.

:func:`dwconv3x3_autograd` is the differentiable op the model calls.
"""

from __future__ import annotations

import math
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from outgridvit_tpu_torch.ops import kernel_build

# (dy, dx) of tap t, row-major
OFFS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
VARIANTS = ("t", "bwd")  # dwconv3x3_t (#10), dwconv_bwd_pallas.dwconv3x3 (#11)


def _check(x: torch.Tensor, w9: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C]; got {tuple(x.shape)}")
    if tuple(w9.shape) != (9, x.shape[-1]):
        raise ValueError(f"w9 must be [9, C={x.shape[-1]}]; got "
                         f"{tuple(w9.shape)}")


def _shifted(t32: torch.Tensor):
    """The zero-padded fp32 map and its 9 shifted [B, H, W, C] views,
    ``view_t[p] = t[p + off_t]``."""
    B, H, W, _ = t32.shape
    tp = F.pad(t32, (0, 0, 1, 1, 1, 1))
    return [tp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for dy, dx in OFFS]


def dwconv3x3_reference(x, w9):
    """Plain PyTorch version of #10's forward: ``round(sum_t x[p + off_t] *
    w9[t])`` in fp32, the taps in order."""
    _check(x, w9)
    w32 = w9.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t, xs in enumerate(_shifted(x.float())):
        acc = acc + xs * w32[t]
    return acc.to(x.dtype)


def dwconv3x3_xla(x, w9):
    """The forward of #11: the grouped conv (XLA's ``conv_general_dilated``
    with ``feature_group_count=C`` in the JAX package), in x's dtype."""
    _check(x, w9)
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w9.t().reshape(C, 1, 3, 3).to(x.dtype),
                 padding=1, groups=C)
    return y.permute(0, 2, 3, 1)


def dwconv3x3_backward_reference(x, w9, dy):
    """Plain PyTorch version of the backward of #10 and #11, written out:
    ``(dx, dw)``; dx in x's dtype, dw [9, C] in w9's."""
    _check(x, w9)
    w32 = w9.float()
    dy32 = dy.float()
    # dx[p] = sum_t w[t] * dy[p - off_t]: the view of the flipped tap
    views = _shifted(dy32)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(9):
        dx = dx + views[8 - t] * w32[t]
    dw = torch.stack([(xs * dy32).sum((0, 1, 2))
                      for xs in _shifted(x.float())])
    return dx.to(x.dtype), dw.to(w9.dtype)


# ---- the launch plans -----------------------------------------------------

THREADS = 256                # threads per block (csrc/dwconv.cu: kThreads)
CV = 2                       # channels per thread (kCV)
MAX_ROWS = 16                # the tallest band
SMS = 132                    # streaming multiprocessors of an H100 SXM
BWD_SMEM_BUDGET = 110 * 1024  # both tile buffers: two blocks fit on an SM
BWD_TARGET_BLOCKS = 2 * SMS  # one wave: two blocks on each SM
BWD_PARTIALS_SHARE = 0.10    # dw partials, written + read, vs x, dy, dx
SMEM_PER_SM = 233_472        # an H100 SM's shared memory, 1 KiB of it
                             # reserved per block
FWD_SMEM_BUDGET = 110 * 1024  # both tile buffers: two blocks fit on an SM
FWD_BLOCKS_PER_SM = 3        # at most, by registers (~80 a thread)
FWD_MIN_TW = 8               # the narrowest band tried where W allows


class FwdPlan(NamedTuple):
    """How ``ogvt_dwconv3x3`` cuts one call. A band is ``rows`` output rows
    of one image by ``tw`` columns (the last band of an image may be
    shorter, and the last of a row of bands narrower); a stage is ``bands``
    consecutive bands, staged together in shared memory; block ``(chunk,
    part)`` owns ``chunk`` channels and the part-th run of stages."""
    rows: int
    tw: int
    chunk: int
    bands: int
    parts: int
    chunks: int
    stages: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.chunks * self.parts


class BwdPlan(NamedTuple):
    """How ``ogvt_dwconv3x3_bwd`` cuts one call: as :class:`FwdPlan` with
    bands that span the width, and each block writes one fp32 dw partial
    (or dw itself when ``parts`` is 1)."""
    rows: int
    chunk: int
    bands: int
    parts: int
    chunks: int
    stages: int
    smem_bytes: int
    workspace_floats: int

    @property
    def blocks(self) -> int:
        return self.chunks * self.parts


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_smem_bytes(tw: int, rows: int, chunk: int, bands: int,
                   itemsize: int) -> int:
    """Shared memory of one forward block: two stage buffers, each
    ``bands`` halo tiles of x ``[rows + 2, tw + 2, chunk]``."""
    return 2 * bands * (rows + 2) * (tw + 2) * chunk * itemsize


def bwd_smem_bytes(W: int, rows: int, chunk: int, bands: int,
                   itemsize: int) -> int:
    """Shared memory of one backward block: two stage buffers, each
    ``bands`` halo tiles of dy ``[rows + 2, W + 2, chunk]`` and tiles of x
    ``[rows, W, chunk]``; at least the block's dw sums ``[threads, 9, CV]``
    fp32, which reuse it after the last stage."""
    tiles = 2 * bands * ((rows + 2) * (W + 2) + rows * W) * chunk * itemsize
    return max(tiles, THREADS * 9 * CV * 4)


def _piece_eff(nbytes: int) -> float:
    """The plan's model of the device-memory efficiency of a block reading
    ``nbytes`` of each pixel (strided by the pixel): it grows with the
    piece's width, steeply up to 128 bytes and a little past it (fitted,
    with the other terms of :func:`dwconv3x3_forward_plan`, to a sweep of
    the forward's plans on an H100)."""
    if nbytes >= 128:
        return min(1.0, 0.85 + 0.05 * math.log2(min(nbytes, 512) / 128))
    return 0.85 - 0.11 * math.log2(128 / nbytes)


@lru_cache(maxsize=None)
def dwconv3x3_forward_plan(B: int, H: int, W: int, C: int,
                           itemsize: int) -> FwdPlan:
    """The forward kernel's launch plan for x ``[B, H, W, C]`` of
    ``itemsize``-byte elements. Searched over the channel chunk (a power of
    two of CV-channel groups, at least 64 bytes of a pixel where C allows),
    the band width (W cut into equal tiles, down to FWD_MIN_TW), the band
    height (balanced, at most MAX_ROWS) and the bands per stage, with two
    buffers within FWD_SMEM_BUDGET; blocks fill one wave of as many blocks
    an SM as shared memory and FWD_BLOCKS_PER_SM allow. Keeps the plan with
    at least SMS blocks where the (band, chunk) tiles allow that many, then
    the highest product of: the chunk's device-memory efficiency
    (:func:`_piece_eff`), the halo (rows and columns a band reads twice,
    against the bytes of x and y), the walk's start-up down each column
    (about a row), a stage's fixed cost (about two rows a thread), idle
    threads, padded channels and columns, and the blocks' share of two an
    SM. Fitted to a sweep of plans on an H100 at the shipped shapes. Raises,
    naming the shape, where no tile fits. Cached: the wrapper asks for it at
    every launch."""
    if min(B, H, W, C) < 1:
        raise ValueError(f"dwconv3x3: empty shape {(B, H, W, C)}")
    groups = _cdiv(C, CV)
    gmax = min(THREADS, 1 << (groups - 1).bit_length())
    gmin = min(gmax, max(1, 64 // (CV * itemsize)))
    widths = sorted({W} | {_cdiv(W, n) for n in range(2, W + 1)
                           if _cdiv(W, n - 1) > FWD_MIN_TW})
    heights = sorted({_cdiv(H, _cdiv(H, r))
                      for r in range(1, min(H, MAX_ROWS) + 1)})
    best, best_key = None, None
    g = gmin
    while g <= gmax:
        chunk = g * CV
        chunks = _cdiv(C, chunk)
        piece = _piece_eff(chunk * itemsize) * C / (chunks * chunk)
        for tw in widths:
            for rows in heights:
                nsub = B * _cdiv(H, rows) * _cdiv(W, tw)
                if nsub >= 1 << 31:  # bands are ints in the kernel
                    continue
                units = B * H * W * C / (rows * tw * chunk)
                # halo rows and columns a band reads twice (unless it spans
                # the image that way), and the walk's start-up
                reads = ((rows + 2 * (rows < H)) * (tw + 2 * (tw < W))
                         / (rows * tw))
                eff = (piece * 2 / (1 + reads) * rows / (rows + 1)
                       * W / (_cdiv(W, tw) * tw))
                bands = 1
                while bands <= nsub and (bands == 1
                                         or bands * tw * g <= 4 * THREADS):
                    smem = fwd_smem_bytes(tw, rows, chunk, bands, itemsize)
                    if smem > FWD_SMEM_BUDGET:
                        break
                    per_sm = min(FWD_BLOCKS_PER_SM,
                                 SMEM_PER_SM // (smem + 1024))
                    items = bands * tw * g
                    passes = _cdiv(items, THREADS)
                    work = passes * (rows + 1)
                    stages = _cdiv(nsub, bands)
                    parts = min(stages, max(1, per_sm * SMS // chunks))
                    blocks = chunks * parts
                    score = (eff * items / (THREADS * passes) * work
                             / (work + 2) * min(1.0, blocks / (2 * SMS)))
                    key = (blocks >= SMS or units < SMS, round(score, 4),
                           -bands)
                    if best_key is None or key > best_key:
                        best_key = key
                        best = FwdPlan(rows, tw, chunk, bands, parts, chunks,
                                       stages, smem)
                    bands += 1
        g *= 2
    if best is None:
        raise ValueError(f"dwconv3x3: no tile of x {(B, H, W, C)} "
                         f"({itemsize}-byte elements) fits {FWD_SMEM_BUDGET} "
                         "bytes of shared memory in fewer than 2**31 bands")
    return best


@lru_cache(maxsize=None)
def dwconv3x3_backward_plan(B: int, H: int, W: int, C: int,
                            itemsize: int) -> BwdPlan:
    """The backward kernel's launch plan for x ``[B, H, W, C]`` of
    ``itemsize``-byte elements. Searched over the channel chunk (a power of
    two of CV-channel groups, at least 64 bytes of a pixel where C
    allows), the band height (balanced, at most MAX_ROWS, the tallest whose
    two buffers fit BWD_SMEM_BUDGET) and the bands per stage; it keeps the
    plan with at least 132 blocks where the (band, chunk) tiles allow that
    many, then the least wasted work (idle threads, padded channels, halo
    rows of dy read twice) at the occupancy it reaches. Blocks per chunk
    fill at most BWD_TARGET_BLOCKS in all (one wave: at ~104 registers a
    thread two blocks fit an SM, and a block more would start a second
    wave), capped further so the dw partials' bytes stay
    within BWD_PARTIALS_SHARE of x, dy and dx; one block per chunk writes
    dw directly. Cached: the wrapper asks for it at every launch."""
    if min(B, H, W, C) < 1:
        raise ValueError(f"empty shape {(B, H, W, C)}")
    groups = _cdiv(C, CV)
    gmax = min(THREADS, 1 << (groups - 1).bit_length())
    gmin = min(gmax, max(1, 64 // (CV * itemsize)))
    launch_bytes = 3 * B * H * W * C * itemsize
    max_parts = int(BWD_PARTIALS_SHARE * launch_bytes) // (72 * C)
    best, best_key = None, None
    g = gmin
    while g <= gmax:
        chunk = g * CV
        chunks = _cdiv(C, chunk)
        for rmax in range(min(H, MAX_ROWS), 0, -1):
            rows = _cdiv(H, _cdiv(H, rmax))
            if bwd_smem_bytes(W, rows, chunk, 1, itemsize) <= BWD_SMEM_BUDGET:
                break
        else:
            g *= 2
            continue
        nsub = B * _cdiv(H, rows)
        units = B * H * W * C / (rows * W * chunk)
        # dy's halo rows come from device memory twice unless a band is a
        # whole image (its halo is the zero padding)
        byte_eff = 1.0 if rows == H else 3 / (2 + (rows + 2) / rows)
        bands = 1
        while (bands <= nsub and bwd_smem_bytes(W, rows, chunk, bands,
                                                itemsize) <= BWD_SMEM_BUDGET
               and (bands == 1 or bands * W * g <= 4 * THREADS)):
            items = bands * W * g
            stages = _cdiv(nsub, bands)
            parts = min(stages, max(1, BWD_TARGET_BLOCKS // chunks))
            if parts > 1 and parts > max_parts:
                parts = max(1, max_parts)
            blocks = chunks * parts
            eff = (C / (chunks * chunk)) * byte_eff * items / (
                THREADS * _cdiv(items, THREADS))
            key = (blocks >= 132 or units < 132,
                   round(eff * min(1.0, blocks / BWD_TARGET_BLOCKS), 3),
                   -bands)
            if best_key is None or key > best_key:
                smem = bwd_smem_bytes(W, rows, chunk, bands, itemsize)
                best_key = key
                best = BwdPlan(rows, chunk, bands, parts, chunks, stages, smem,
                               9 * C * parts if parts > 1 else 0)
            bands += 1
        g *= 2
    if best is None:
        raise ValueError(f"dwconv3x3_backward: no tile of a {W}-wide map "
                         f"fits {BWD_SMEM_BUDGET} bytes of shared memory")
    return best


# ---- the CUDA kernels -----------------------------------------------------

def _vecio(C: int, *tensors) -> bool:
    """Whether C and every pointer allow the kernels' 16-byte copies."""
    vec = 16 // tensors[0].element_size()
    return C % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_launch(name, x, w9, dy=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    _check(x, w9)
    want = {"w9": w9} if dy is None else {"w9": w9, "dy": dy}
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"{name}: dy is {tuple(dy.shape)}; expected "
                         f"{tuple(x.shape)}")
    for tname, t in want.items():
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}; "
                             f"expected {x.dtype} on {x.device}")
    if not all(t.is_contiguous() for t in (x, *want.values())):
        raise ValueError(f"{name}: x, w9 and dy must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def dwconv3x3(x, w9):
    """#10 forward, [B, H, W, C] -> [B, H, W, C]. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes :func:`dwconv3x3_reference`.
    Under tracing it is the op ``ogvt::dwconv3x3`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("dwconv3x3")(x, w9)
    if x.device.type == "cpu":
        return dwconv3x3_reference(x, w9)
    return _launch_forward(x, w9)


def _launch_forward(x, w9):
    """:func:`dwconv3x3` on the card."""
    _check_launch("dwconv3x3", x, w9)
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    plan = dwconv3x3_forward_plan(B, H, W, C, x.element_size())
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        err = lib.ogvt_dwconv3x3(
            x.data_ptr(), w9.data_ptr(), y.data_ptr(), B, H, W, C, plan.rows,
            plan.tw, plan.chunk, plan.bands, plan.parts, plan.smem_bytes,
            int(_vecio(C, x, y)), kernel_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "dwconv3x3 launch")
    dwconv3x3.launches += 1
    return y


dwconv3x3.launches = 0


def dwconv3x3_backward(x, w9, dy, variant: str = "t"):
    """Backward of #10 and #11: ``(dx, dw)``. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes
    :func:`dwconv3x3_backward_reference`. ``variant`` names the JAX kernel
    the launch stands for (:data:`VARIANTS`). Deterministic: two calls give
    bitwise-equal grads."""
    kernel_build.check_variant("dwconv3x3_backward", variant, VARIANTS)
    if x.device.type == "cpu":
        return dwconv3x3_backward_reference(x, w9, dy)
    _check_launch("dwconv3x3_backward", x, w9, dy)
    B, H, W, C = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w9)
    plan = dwconv3x3_backward_plan(B, H, W, C, x.element_size())
    vecio = _vecio(C, x, dy, dx)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                     device=x.device)
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        err = lib.ogvt_dwconv3x3_bwd(
            x.data_ptr(), w9.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), B, H, W, C, plan.rows, plan.chunk,
            plan.bands, plan.parts, plan.smem_bytes, int(vecio),
            kernel_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "dwconv3x3_backward launch")
    kernel_build.count_launch(dwconv3x3_backward, variant)
    return dx, dw


dwconv3x3_backward.launches = 0
dwconv3x3_backward.by_variant = Counter()


class _DWConv3x3(torch.autograd.Function):
    """Mode ``"t"`` (#10): the kernel forward; ``"bwd"`` (#11): the grouped
    conv forward. The kernel backward in both, from the saved x and w9."""

    @staticmethod
    def forward(ctx, x, w9, mode, use_kernels):
        ctx.save_for_backward(x, w9)
        ctx.mode, ctx.use_kernels = mode, use_kernels
        if mode == "bwd":
            return dwconv3x3_xla(x, w9)
        return (dwconv3x3 if use_kernels else dwconv3x3_reference)(x, w9)

    @staticmethod
    def backward(ctx, g):
        x, w9 = ctx.saved_tensors
        g = g.contiguous()
        if ctx.use_kernels:
            dx, dw = dwconv3x3_backward(x, w9, g, ctx.mode)
        else:
            dx, dw = dwconv3x3_backward_reference(x, w9, g)
        return dx, dw, None, None


def dwconv3x3_autograd(x, w9, mode: str = "t", use_kernels: bool = False):
    """Differentiable depthwise 3x3 in mode ``"t"`` (#10) or ``"bwd"``
    (#11): the CUDA kernels with ``use_kernels``, else their plain versions
    (the forward of ``"bwd"`` is the grouped conv either way)."""
    kernel_build.check_variant("dwconv3x3_autograd", mode, VARIANTS)
    return _DWConv3x3.apply(x, w9, mode, use_kernels)
