"""Fused outlook value path for K=3, stride 1: the CUDA kernels
``csrc/outlook_agg.cu`` (forward and backward) and their plain PyTorch
versions. Twin of ``outgridvit_tpu/ops/experimental/outlook_agg_pallas.py``:

- ``outlook_attention_proj_pallas`` (TPU kernel #7): ``out =
  aggregate(v, a).wp + bp`` (:func:`outlook_agg_proj`);
- ``outlook_branch_pallas`` (#8): ``out = aggregate(x.wv + bv, a).wp + bp``
  with the value projection folded in, so v never reaches device memory
  (:func:`outlook_branch`).

Layouts are the JAX ones: v / x ``[B, H, W, C]`` / ``[B, H, W, Cin]``; ``a``
``[B, H, W, heads*9]``, the softmaxed tap weights at index ``h*9 + t`` with
the taps row-major (``t = 3*(dy+1) + (dx+1)``, ``_OFFS`` of
``ops/experimental/dwconv_bwd_pallas.py:38``); ``wv [Cin, C]``, ``wp [C,
C]``; biases ``[C]``. The aggregate reads zero outside the image: zero v,
not ``bv`` (``_halo_border_mask``, ``outlook_agg_pallas.py:579``).

Rounding points (``round()`` is the cast to the compute dtype), as in the
Pallas kernels:

- forward (``_fwd_kernel``, ``_fwdv_kernel``): the aggregate is summed in
  fp32 over the taps in order, each tap a separately rounded product, and
  cast once: ``y = round(agg)``; ``out = round(y.wp + bp)`` summed in fp32.
  With the fold, ``v = x.wv + bv`` stays fp32 and is never rounded.
- backward (``_proj_grads``, ``_bwd_taps``, ``_bwdv_kernel``): ``y`` is
  recomputed; ``dyag = g.wp^T`` stays fp32; ``dv[q] = sum_t (dyag *
  w_t)[q - off_t]`` and ``da[p, h*9+t] = sum_{c in head h} v[p + off_t, c]
  * dyag[p, c]`` from it and the fp32 tap weights. dWp = y^T.g and dbp =
  sum g are fp32 sums over every pixel, cast to the weight's dtype. With
  the fold, dx = round(dv).wv^T and dWv = x^T.round(dv), but dbv = sum of
  the unrounded dv. dv is rounded once, as in the whole-image Pallas
  kernels (the row-chunked ones round the halo rows' part apart).

:func:`outlook_agg_proj_autograd` and :func:`outlook_branch_autograd` are
the differentiable ops the model calls: ``torch.autograd.Function``\\ s in
recompute style that save only their inputs (``_fwd_vjp`` :509,
``_fwdv_vjp`` :819).

The forward has two kernels, picked by dtype and shape before launch
(:func:`forward_entry`): a bf16 launch that :func:`outlook_agg_forward_plan`
takes (C and Cin multiples of 16, a head width that is a multiple of 4, a
tile of whole image rows that fits one block with Wp, and Wv with the fold,
resident: every shipped outlooker of C <= 192 with the fold, C <= 256
without) runs ``csrc/outlook_agg_fwd_mma.cu`` (``ogvt_outlook_agg_fwd_mma``:
x.Wv and y.Wp on ``mma.sync`` tiles, the backward's staging and taps); fp32
launches and the bf16 shapes the plan refuses run the FMA kernel of
``csrc/outlook_agg.cu`` (``ogvt_outlook_agg``). Launches are counted per C
entry point (``outlook_agg_proj.by_entry``, ``outlook_branch.by_entry``).

The backward has two kernels, picked the same way
(:func:`backward_entry`): a bf16 launch that
:func:`outlook_agg_backward_plan` takes (C and Cin multiples of 16, a head
width that is a multiple of 4, a tile of whole image rows that fits one
block: every shipped outlooker of C <= 128) runs
``csrc/outlook_agg_bwd_mma.cu`` (``ogvt_outlook_agg_bwd_mma``: its five
products on ``mma.sync`` tiles, one pass a tile, the halo rows' dyag
recomputed); fp32 launches and the bf16 shapes the plan refuses run the
FMA kernels of ``csrc/outlook_agg.cu`` (``ogvt_outlook_agg_bwd``).
Launches are counted per C entry point
(``outlook_agg_proj_backward.by_entry``,
``outlook_branch_backward.by_entry``). Both plans ask the kernels' one
layout header, ``csrc/outlook_agg_mma_layout.h``, through :func:`_layout`.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from functools import lru_cache
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.kernel_build import (
    SMS,
    check_aligned16,
    sm_blocks,
)

TAPS = 9  # K = 3
# (dy, dx) of tap t, row-major
OFFS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_MAX_SMEM = 227 * 1024
_TILE_PIXELS = 128  # rows per block: as many as keep a tile <= 128 pixels


def _heads(v: torch.Tensor, a: torch.Tensor) -> int:
    if v.dim() != 4:
        raise ValueError(f"v must be [B, H, W, C]; got {tuple(v.shape)}")
    if a.dim() != 4 or a.shape[:3] != v.shape[:3] or a.shape[-1] % TAPS:
        raise ValueError(
            f"a must be [B, H, W, heads*9] beside {tuple(v.shape)}; got "
            f"{tuple(a.shape)}")
    return a.shape[-1] // TAPS


def _check_heads(C: int, heads: int) -> None:
    if heads <= 0 or C % heads:
        raise ValueError(f"C={C} must be divisible by heads={heads}")


def _aggregate(v32: torch.Tensor, a: torch.Tensor, heads: int):
    """fp32 ``y[p] = sum_t v[p + off_t] * a[p, h*9+t]`` (zero outside the
    image), the taps in order."""
    B, H, W, C = v32.shape
    vp = F.pad(v32, (0, 0, 1, 1, 1, 1)).reshape(B, H + 2, W + 2, heads, -1)
    a5 = a.float().reshape(B, H, W, heads, TAPS)
    acc = torch.zeros_like(vp[:, 1:H + 1, 1:W + 1])
    for t, (dy, dx) in enumerate(OFFS):
        acc = acc + vp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] * \
            a5[..., t, None]
    return acc.reshape(B, H, W, C)


def _project(y: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, dt):
    return (y.float() @ wp.float() + bp.float()).to(dt)


def outlook_agg_proj_reference(v, a, wp, bp):
    """Plain PyTorch version of #7: ``round(round(aggregate(v, a)).wp +
    bp)``, [B, H, W, C] -> [B, H, W, C]."""
    heads = _heads(v, a)
    _check_heads(v.shape[-1], heads)
    y = _aggregate(v.float(), a, heads).to(v.dtype)
    return _project(y, wp, bp, v.dtype)


def outlook_branch_reference(x, a, wv, bv, wp, bp):
    """Plain PyTorch version of #8: the fp32 ``v = x.wv + bv``, then #7's
    math; [B, H, W, Cin] -> [B, H, W, C]."""
    heads = _heads(x, a)
    _check_heads(wv.shape[-1], heads)
    v32 = x.float() @ wv.float() + bv.float()
    y = _aggregate(v32, a, heads).to(x.dtype)
    return _project(y, wp, bp, x.dtype)


def _backward_core(v32, a, wp, g, dt):
    """Shared backward of #7 and #8 from the fp32 values: ``(dv fp32, da,
    dwp, dbp)``, the last three in the dtypes of ``a`` and ``wp``."""
    B, H, W, C = v32.shape
    heads = a.shape[-1] // TAPS
    y = _aggregate(v32, a, heads).to(dt).float().reshape(-1, C)
    g32 = g.float().reshape(-1, C)
    dwp = y.t() @ g32
    dbp = g32.sum(0)
    dyag = (g32 @ wp.float().t()).reshape(B, H, W, heads, -1)
    vp = F.pad(v32, (0, 0, 1, 1, 1, 1)).reshape(B, H + 2, W + 2, heads, -1)
    a5 = a.float().reshape(B, H, W, heads, TAPS)
    dv = torch.zeros_like(dyag)
    da = torch.empty_like(a5)
    for t, (dy, dx) in enumerate(OFFS):
        da[..., t] = (vp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      * dyag).sum(-1)
        # dv[q] += (dyag * w_t)[q - off_t], zero where q - off_t is outside
        z = F.pad(dyag * a5[..., t, None], (0, 0, 0, 0, 1, 1, 1, 1))
        dv = dv + z[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
    return (dv.reshape(B, H, W, C), da.reshape(a.shape).to(a.dtype),
            dwp.to(wp.dtype), dbp.to(wp.dtype))


def outlook_agg_proj_backward_reference(v, a, wp, g):
    """Plain PyTorch version of #7's backward, written out (not autograd),
    for the output gradient ``g``: ``(dv, da, dwp, dbp)``."""
    _check_heads(v.shape[-1], _heads(v, a))
    dv, da, dwp, dbp = _backward_core(v.float(), a, wp, g, v.dtype)
    return dv.to(v.dtype), da, dwp, dbp


def outlook_branch_backward_reference(x, a, wv, bv, wp, g):
    """Plain PyTorch version of #8's backward, written out: ``(dx, da, dwv,
    dbv, dwp, dbp)``; dx and dwv from the rounded dv, dbv from the fp32
    one."""
    _check_heads(wv.shape[-1], _heads(x, a))
    Cin, C = wv.shape
    v32 = x.float() @ wv.float() + bv.float()
    dv, da, dwp, dbp = _backward_core(v32, a, wp, g, x.dtype)
    dv32 = dv.reshape(-1, C)
    dvd = dv32.to(x.dtype).float()
    dx = (dvd @ wv.float().t()).to(x.dtype).reshape(x.shape)
    dwv = x.float().reshape(-1, Cin).t() @ dvd
    return (dx, da, dwv.to(wv.dtype), dv32.sum(0).to(bv.dtype), dwp, dbp)


# ---- the CUDA kernels -----------------------------------------------------

def smem_bytes(rows: int, W: int, Cin: int, C: int, heads: int,
               fold: bool) -> int:
    """Dynamic shared memory of the largest of the three kernels for a tile
    of ``rows`` image rows (fp32, rows padded by one float): mirrors
    ``fwd_smem_floats`` / ``bwd_proj_smem_floats`` / ``bwd_dv_smem_floats``
    of csrc/outlook_agg.cu."""
    ext, S = (rows + 2) * W, rows * W
    lc, la, li = C + 1, TAPS * heads + 1, Cin + 1
    x_ext = ext * li if fold else 0
    fwd = ext * lc + max(x_ext, S * la + S * lc)
    bwd_proj = ext * lc + max(x_ext, S * la + 3 * S * lc)
    bwd_dv = ext * lc + ext * la + (S * lc + S * li if fold else 0)
    return 4 * max(fwd, bwd_proj, bwd_dv)


def tile_rows(H: int, W: int, Cin: int, C: int, heads: int,
              fold: bool) -> int:
    """Image rows per block: the most that keep a tile within
    ``_TILE_PIXELS`` pixels and every kernel within shared memory; 0 when
    even one row does not fit."""
    rows = max(1, min(H, _TILE_PIXELS // W))
    while rows > 1 and smem_bytes(rows, W, Cin, C, heads, fold) > _MAX_SMEM:
        rows -= 1
    return rows if smem_bytes(rows, W, Cin, C, heads, fold) <= _MAX_SMEM \
        else 0


def _check_launch(name, x, a, wv, bv, wp, bp, g=None):
    """Validate what the kernels take; returns (B, H, W, Cin, C, heads,
    rows). ``wv``/``bv`` are None without the fold; ``bp`` is None in the
    backward and ``g`` None in the forward."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    heads = _heads(x, a)
    B, H, W, Cin = x.shape
    C = wp.shape[0]
    _check_heads(C, heads)
    want = {"a": (a, (B, H, W, TAPS * heads)), "wp": (wp, (C, C))}
    if wv is not None:
        want.update(wv=(wv, (Cin, C)), bv=(bv, (C,)))
    elif Cin != C:
        raise ValueError(f"{name}: v has C={Cin}, wp is {tuple(wp.shape)}")
    if bp is not None:
        want["bp"] = (bp, (C,))
    if g is not None:
        want["g"] = (g, (B, H, W, C))
    for tname, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(
                f"{name}: {tname} is {tuple(t.shape)} {t.dtype}; expected "
                f"{shape} {x.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: {tname} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    rows = tile_rows(H, W, Cin, C, heads, wv is not None)
    if rows == 0:
        raise ValueError(f"{name}: one image row of W={W}, C={C} exceeds "
                         "shared memory")
    return B, H, W, Cin, C, heads, rows


# ---- the tensor-core backward's launch plan -------------------------------

class OutlookBwdPlan(NamedTuple):
    """How ``ogvt_outlook_agg_bwd_mma`` cuts one call: tiles of ``rows``
    whole image rows of one image (``tiles`` of them), each staged with a
    halo row above and below; the channels in chunks of ``chunk`` (a
    multiple of the head width); ``blocks`` persistent blocks of
    ``threads`` threads and ``smem`` shared bytes walk the tiles,
    ``blocks_per_sm`` an SM at the register cap ``regs``; a warp holds
    ``slots`` m16n16 tiles of each weight gradient (the kernel's template).
    ``ws_floats``: the blocks' fp32 partials."""
    rows: int
    chunk: int
    tiles: int
    blocks: int
    threads: int
    smem: int
    regs: int
    blocks_per_sm: int
    slots: int
    ws_floats: int


def _layout(W: int, Cin: int, C: int, heads: int, rows: int, chunk: int,
            fold: bool, forward: bool = False) -> Optional[tuple]:
    """The kernel's own answer (``csrc/outlook_agg_mma_layout.cpp``) for one
    layout: the backward's (threads, shared bytes, register cap, dW tiles a
    warp), with ``forward`` the forward's (threads, shared bytes, register
    cap); None where the kernel does not take it."""
    lib = kernel_build.load_layouts()
    fn, n = ((lib.ogvt_outlook_agg_fwd_mma_layout, 3) if forward
             else (lib.ogvt_outlook_agg_bwd_mma_layout, 4))
    out = (ctypes.c_int * n)()
    return None if fn(W, Cin, C, heads, rows, chunk, int(fold), out) \
        else tuple(out)


def partial_floats(Cin: int, C: int, fold: bool) -> int:
    """Floats of one block's fp32 partial: dWp, dbp and, with the fold,
    dWv, dbv (``outlook_agg_mma_layout.h:partial_floats``)."""
    return C * C + C + (Cin * C + C if fold else 0)


def _refusal(B: int, H: int, W: int, Cin: int, C: int,
             heads: int) -> Optional[str]:
    """Why neither tensor-core kernel takes these shapes whatever the
    layout, or None."""
    if B < 1 or H < 1 or W < 1:
        return "an empty input"
    if C < 16 or Cin < 16 or C % 16 or Cin % 16:
        return "C and Cin must be multiples of 16"
    if heads < 1 or C % heads or (C // heads) % 4:
        return (f"the head width C / heads = {C} / {heads} must be a "
                "multiple of 4")
    return None


@lru_cache(maxsize=None)
def _fit_backward(B: int, H: int, W: int, Cin: int, C: int, heads: int,
                  fold: bool) -> Union[OutlookBwdPlan, str]:
    """The plan for these bf16 shapes, or why there is none (a str). Of the
    layouts the kernel takes (``_layout``), the one with the least work a
    block: waves of tiles over the card's resident blocks times R + 1 for
    tiles of R rows (the two halo rows enter two of the five products, the
    taps walk only the tile's rows); then the widest chunk, then the
    tallest tile."""
    why = _refusal(B, H, W, Cin, C, heads)
    if why:
        return why
    step = math.lcm(C // heads, 16)
    best = None
    for chunk in range(C, 0, -step):
        if C % chunk:
            continue
        for rows in range(1, H + 1):
            got = _layout(W, Cin, C, heads, rows, chunk, fold)
            if got is None:
                break  # a taller tile needs more shared memory
            threads, smem, regs, slots = got
            per_sm = sm_blocks(threads, smem, regs)
            tiles = B * -(-H // rows)
            waves = -(-tiles // (SMS * per_sm))
            key = (waves * (rows + 1), -chunk, -rows)
            if best is None or key < best[0]:
                best = (key, OutlookBwdPlan(
                    rows, chunk, tiles, min(tiles, SMS * per_sm), threads,
                    smem, regs, per_sm, slots, 0))
    if best is None:
        return ("no tile of one image row fits one block's shared memory "
                "with the weight gradients in at most 4 m16n16 tiles a warp")
    plan = best[1]
    return plan._replace(
        ws_floats=plan.blocks * partial_floats(Cin, C, fold))


def outlook_agg_backward_plan(B: int, H: int, W: int, Cin: int, C: int,
                              heads: int, fold: bool,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> OutlookBwdPlan:
    """The tensor-core backward's launch plan for x ``[B, H, W, Cin]`` (v
    without the ``fold``, Cin == C), C output channels and ``heads`` heads,
    or a ValueError naming the shape it does not take: fp32 (the FMA
    kernel's), C or Cin not a multiple of 16, a head width that is not a
    multiple of 4, and shapes
    whose tile of one image row does not fit an H100 block's shared memory
    or whose weight gradients need more than 4 m16n16 tiles a warp, as the
    kernel's own layout says (``_layout``). Cached: the wrapper asks at
    every launch."""
    where = (f"outlook backward (mma): B={B}, H={H}, W={W}, Cin={Cin}, "
             f"C={C}, heads={heads}, fold={bool(fold)}, {dtype}")
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    plan = _fit_backward(B, H, W, Cin, C, heads, bool(fold))
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


BACKWARD_ENTRIES = ("ogvt_outlook_agg_bwd_mma", "ogvt_outlook_agg_bwd")


def backward_entry(B: int, H: int, W: int, Cin: int, C: int, heads: int,
                   fold: bool, dtype: torch.dtype) -> str:
    """The C entry point a backward launch of these shapes takes:
    ``ogvt_outlook_agg_bwd_mma`` where :func:`outlook_agg_backward_plan`
    takes the shape, else the FMA kernel's ``ogvt_outlook_agg_bwd``.
    Decided by dtype and shape alone."""
    if dtype == torch.bfloat16 and not isinstance(
            _fit_backward(B, H, W, Cin, C, heads, bool(fold)), str):
        return BACKWARD_ENTRIES[0]
    return BACKWARD_ENTRIES[1]


def _launch_backward(entry: Optional[str], name, x, a, wv, bv, wp, g):
    """The backward on the card through the C entry point ``entry`` (one of
    :data:`BACKWARD_ENTRIES`), or :func:`backward_entry`'s where it is
    None. A named entry is for comparing the two kernels on the same inputs
    (``chip_smoke.py``'s A/B, the card tests)."""
    B, H, W, Cin, C, heads, rows = _check_launch(name, x, a, wv, bv, wp,
                                                 None, g)
    fold = wv is not None
    if entry is None:
        entry = backward_entry(B, H, W, Cin, C, heads, fold, x.dtype)
    elif entry not in BACKWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{BACKWARD_ENTRIES}")
    mma = entry == BACKWARD_ENTRIES[0]
    lib = kernel_build.load()
    if mma:
        plan = outlook_agg_backward_plan(B, H, W, Cin, C, heads, fold,
                                         x.dtype)
        check_aligned16(name, x=x, wp=wp, g=g,
                        **({"wv": wv} if fold else {}))
        n_ws = lib.ogvt_outlook_agg_bwd_mma_workspace(Cin, C, int(fold),
                                                      plan.blocks)
    else:
        n_ws = lib.ogvt_outlook_agg_bwd_workspace(B, H, W, Cin, C, heads,
                                                  rows, int(fold))
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dwv = torch.empty_like(wv) if fold else None
    dbv = torch.empty_like(bv) if fold else None
    dwp, dbp = torch.empty_like(wp), torch.empty((C,), dtype=wp.dtype,
                                                 device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    ptrs = (x.data_ptr(), a.data_ptr(), ptr(wv), ptr(bv), wp.data_ptr(),
            g.data_ptr(), dx.data_ptr(), da.data_ptr(), ptr(dwv), ptr(dbv),
            dwp.data_ptr(), dbp.data_ptr(), ws.data_ptr(), B, H, W, Cin, C,
            heads)
    code = kernel_build.DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mma:
            err = lib.ogvt_outlook_agg_bwd_mma(
                *ptrs, plan.rows, plan.chunk, int(fold), code, plan.blocks,
                plan.smem, stream)
        else:
            err = lib.ogvt_outlook_agg_bwd(*ptrs, rows, int(fold), code,
                                           stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    kernel_build.count_launch(
        outlook_branch_backward if fold else outlook_agg_proj_backward, None,
        entry)
    return (dx, da, dwv, dbv, dwp, dbp) if fold else (dx, da, dwp, dbp)


# ---- the tensor-core forward's launch plan --------------------------------

class OutlookFwdPlan(NamedTuple):
    """How ``ogvt_outlook_agg_fwd_mma`` cuts one call: tiles of ``rows``
    whole image rows of one image (``tiles`` of them), each staged with a
    halo row above and below; v in chunks of ``chunk`` channels (a multiple
    of the head width); ``blocks`` persistent blocks of ``threads`` threads
    and ``smem`` shared bytes walk the tiles, ``blocks_per_sm`` an SM at the
    register cap ``regs``."""
    rows: int
    chunk: int
    tiles: int
    blocks: int
    threads: int
    smem: int
    regs: int
    blocks_per_sm: int


def _fwd_plan(B: int, H: int, W: int, Cin: int, C: int, heads: int,
              fold: bool, rows: int, chunk: int) -> Optional[OutlookFwdPlan]:
    """The forward's plan at ``rows`` and ``chunk`` as the kernel's layout
    gives it (``_layout``), or None where the kernel does not take them:
    as many blocks as the card holds at once, at most one a tile."""
    got = _layout(W, Cin, C, heads, rows, chunk, fold, forward=True)
    if got is None:
        return None
    threads, smem, regs = got
    per_sm = sm_blocks(threads, smem, regs)
    tiles = B * -(-H // rows)
    return OutlookFwdPlan(rows, chunk, tiles, min(tiles, SMS * per_sm),
                          threads, smem, regs, per_sm)


def _fwd_cost(p: OutlookFwdPlan, fold: bool) -> int:
    """Work a block, in image rows: waves of tiles over the card's resident
    blocks times a tile's rows through the phases, the v product over the
    R + 2 staged rows with the fold, the taps and y.Wp over the R."""
    waves = -(-p.tiles // (SMS * p.blocks_per_sm))
    return waves * ((p.rows + 2 if fold else 0) + 2 * p.rows)


@lru_cache(maxsize=None)
def _fit_forward(B: int, H: int, W: int, Cin: int, C: int, heads: int,
                 fold: bool) -> Union[OutlookFwdPlan, str]:
    """The forward's plan for these bf16 shapes, or why there is none (a
    str): of the layouts the kernel takes, the least :func:`_fwd_cost`, then
    the tallest tile, then the widest chunk (a sweep of layouts on the
    card at the five ``OUTLOOK_SHAPES`` of C <= 128, both fold modes: the
    plan is the fastest there, and taller tiles beat wider chunks)."""
    why = _refusal(B, H, W, Cin, C, heads)
    if why:
        return why
    best = None
    for chunk in range(C, 0, -math.lcm(C // heads, 16)):
        if C % chunk:
            continue
        for rows in range(1, H + 1):
            p = _fwd_plan(B, H, W, Cin, C, heads, fold, rows, chunk)
            if p is None:
                break  # a taller tile needs more shared memory
            key = (_fwd_cost(p, fold), -rows, -chunk)
            if best is None or key < best[0]:
                best = (key, p)
    if best is None:
        return ("no tile of one image row fits one block's shared memory "
                "with Wp" + (" and Wv" if fold else "") + " resident")
    return best[1]


def outlook_agg_forward_plan(B: int, H: int, W: int, Cin: int, C: int,
                             heads: int, fold: bool,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> OutlookFwdPlan:
    """The tensor-core forward's launch plan for x ``[B, H, W, Cin]`` (v
    without the ``fold``, Cin == C), C output channels and ``heads`` heads,
    or a ValueError naming the shape it does not take: fp32 (the FMA
    kernel's), C or Cin not a multiple of 16, a head width that is not a
    multiple of 4, and shapes whose tile of one image row does not fit an
    H100 block's shared memory beside the resident weights, as the kernel's
    own layout says (``_layout``). Cached: the wrapper asks at every
    launch."""
    where = (f"outlook forward (mma): B={B}, H={H}, W={W}, Cin={Cin}, "
             f"C={C}, heads={heads}, fold={bool(fold)}, {dtype}")
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    plan = _fit_forward(B, H, W, Cin, C, heads, bool(fold))
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


FORWARD_ENTRIES = ("ogvt_outlook_agg_fwd_mma", "ogvt_outlook_agg")


def forward_entry(B: int, H: int, W: int, Cin: int, C: int, heads: int,
                  fold: bool, dtype: torch.dtype) -> str:
    """The C entry point a forward launch of these shapes takes:
    ``ogvt_outlook_agg_fwd_mma`` where :func:`outlook_agg_forward_plan`
    takes the shape, else the FMA kernel's ``ogvt_outlook_agg``. Decided by
    dtype and shape alone, before the launch."""
    if dtype == torch.bfloat16 and not isinstance(
            _fit_forward(B, H, W, Cin, C, heads, bool(fold)), str):
        return FORWARD_ENTRIES[0]
    return FORWARD_ENTRIES[1]


def _launch_forward(entry: Optional[str], name, x, a, wv, bv, wp, bp,
                    plan: Optional[OutlookFwdPlan] = None):
    """The forward on the card through the C entry point ``entry`` (one of
    :data:`FORWARD_ENTRIES`), or :func:`forward_entry`'s where it is None.
    A named entry, or a ``plan`` other than
    :func:`outlook_agg_forward_plan`'s (any of :func:`_fwd_plan`), is for
    comparing kernels and layouts on the same inputs (``chip_smoke.py``'s
    A/B, the card tests)."""
    B, H, W, Cin, C, heads, rows = _check_launch(name, x, a, wv, bv, wp, bp)
    fold = wv is not None
    if entry is None:
        entry = forward_entry(B, H, W, Cin, C, heads, fold, x.dtype)
    elif entry not in FORWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{FORWARD_ENTRIES}")
    mma = entry == FORWARD_ENTRIES[0]
    if mma:
        plan = plan or outlook_agg_forward_plan(B, H, W, Cin, C, heads, fold,
                                                x.dtype)
        check_aligned16(name, x=x, wp=wp, **({"wv": wv} if fold else {}))
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    ptrs = (x.data_ptr(), a.data_ptr(), ptr(wv), ptr(bv), wp.data_ptr(),
            bp.data_ptr(), out.data_ptr(), B, H, W, Cin, C, heads)
    code = kernel_build.DTYPE_CODES[x.dtype]
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mma:
            err = lib.ogvt_outlook_agg_fwd_mma(
                *ptrs, plan.rows, plan.chunk, int(fold), code, plan.blocks,
                plan.smem, stream)
        else:
            err = lib.ogvt_outlook_agg(*ptrs, rows, int(fold), code, stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    kernel_build.count_launch(outlook_branch if fold else outlook_agg_proj,
                              None, entry)
    return out


def outlook_agg_proj(v, a, wp, bp):
    """#7 forward, [B, H, W, C] -> [B, H, W, C]. A CUDA tensor launches a
    kernel (or raises): ``csrc/outlook_agg_fwd_mma.cu`` where
    :func:`forward_entry` says so (v and wp 16-byte aligned or a
    ValueError), else ``csrc/outlook_agg.cu``; a CPU tensor takes
    :func:`outlook_agg_proj_reference`. Under tracing it is the op
    ``ogvt::outlook_agg_proj`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("outlook_agg_proj")(v, a, wp, bp)
    if v.device.type == "cpu":
        return outlook_agg_proj_reference(v, a, wp, bp)
    return _launch_forward(None, "outlook_agg_proj", v, a, None, None, wp,
                           bp)


outlook_agg_proj.launches = 0
outlook_agg_proj.by_entry = Counter()


def outlook_agg_proj_backward(v, a, wp, g):
    """#7 backward: ``(dv, da, dwp, dbp)``. A CUDA tensor launches a kernel
    (or raises): ``csrc/outlook_agg_bwd_mma.cu`` where
    :func:`backward_entry` says so (x, wp and g 16-byte aligned or a
    ValueError), else ``csrc/outlook_agg.cu``; a CPU tensor takes
    :func:`outlook_agg_proj_backward_reference`. Deterministic: two calls
    give bitwise-equal grads."""
    if v.device.type == "cpu":
        return outlook_agg_proj_backward_reference(v, a, wp, g)
    return _launch_backward(None, "outlook_agg_proj_backward", v, a, None,
                            None, wp, g)


outlook_agg_proj_backward.launches = 0
outlook_agg_proj_backward.by_entry = Counter()


def outlook_branch(x, a, wv, bv, wp, bp):
    """#8 forward, [B, H, W, Cin] -> [B, H, W, C]. A CUDA tensor launches a
    kernel (or raises), as :func:`outlook_agg_proj` does (wv 16-byte
    aligned too); a CPU tensor takes :func:`outlook_branch_reference`.
    Under tracing it is the op ``ogvt::outlook_branch``
    (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("outlook_branch")(x, a, wv, bv, wp, bp)
    if x.device.type == "cpu":
        return outlook_branch_reference(x, a, wv, bv, wp, bp)
    return _launch_forward(None, "outlook_branch", x, a, wv, bv, wp, bp)


outlook_branch.launches = 0
outlook_branch.by_entry = Counter()


def outlook_branch_backward(x, a, wv, bv, wp, g):
    """#8 backward: ``(dx, da, dwv, dbv, dwp, dbp)``. A CUDA tensor launches
    a kernel (or raises), as :func:`outlook_agg_proj_backward` does (wv
    16-byte aligned too); a CPU tensor takes
    :func:`outlook_branch_backward_reference`. Deterministic."""
    if x.device.type == "cpu":
        return outlook_branch_backward_reference(x, a, wv, bv, wp, g)
    return _launch_backward(None, "outlook_branch_backward", x, a, wv, bv,
                            wp, g)


outlook_branch_backward.launches = 0
outlook_branch_backward.by_entry = Counter()


class _OutlookAggProj(torch.autograd.Function):
    """Recompute style, as ``_fwd_vjp``/``_bwd_vjp``: saves only v, a and
    wp."""

    @staticmethod
    def forward(ctx, v, a, wp, bp, use_kernels):
        ctx.save_for_backward(v, a, wp)
        ctx.use_kernels = use_kernels
        fn = outlook_agg_proj if use_kernels else outlook_agg_proj_reference
        return fn(v, a, wp, bp)

    @staticmethod
    def backward(ctx, g):
        fn = (outlook_agg_proj_backward if ctx.use_kernels
              else outlook_agg_proj_backward_reference)
        return (*fn(*ctx.saved_tensors, g.contiguous()), None)


class _OutlookBranch(torch.autograd.Function):
    """Recompute style, as ``_fwdv_vjp``/``_bwdv_vjp``: saves only x, a and
    the weights."""

    @staticmethod
    def forward(ctx, x, a, wv, bv, wp, bp, use_kernels):
        ctx.save_for_backward(x, a, wv, bv, wp)
        ctx.use_kernels = use_kernels
        fn = outlook_branch if use_kernels else outlook_branch_reference
        return fn(x, a, wv, bv, wp, bp)

    @staticmethod
    def backward(ctx, g):
        fn = (outlook_branch_backward if ctx.use_kernels
              else outlook_branch_backward_reference)
        return (*fn(*ctx.saved_tensors, g.contiguous()), None)


def outlook_agg_proj_autograd(v, a, wp, bp, use_kernels: bool = False):
    """Differentiable #7: the kernels with ``use_kernels``, else the plain
    versions, both ways."""
    return _OutlookAggProj.apply(v, a, wp, bp, use_kernels)


def outlook_branch_autograd(x, a, wv, bv, wp, bp, use_kernels: bool = False):
    """Differentiable #8: the kernels with ``use_kernels``, else the plain
    versions, both ways."""
    return _OutlookBranch.apply(x, a, wv, bv, wp, bp, use_kernels)
