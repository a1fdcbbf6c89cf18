"""Fused outlook attention, stride 1, any odd K: the softmax over each
head's K*K tap logits fused with the taps. Two CUDA kernels for the forward
and its plain PyTorch version; twin of
``outgridvit_tpu/ops/experimental/outlook_pallas.py:outlook_attention_pallas``
(TPU kernel #9, ``model.use_pallas: fused_outlook``).

The forward's kernel is picked by dtype and shape before the launch
(:func:`softmax_entry`): a bf16 launch at K = 3 with a head width that is a
multiple of 8 that :func:`outlook_softmax_plan` takes runs
``csrc/outlook_softmax_rows.cu`` (tiles of whole image rows staged by
``cp.async``, a thread a run of adjacent pixels of one 16-byte channel
chunk; its layout from ``csrc/outlook_softmax_layout.h``); fp32, other K and
the shapes the plan refuses run ``csrc/outlook_softmax.cu``. The two give
bitwise the same outputs. ``outlook_softmax_agg.by_entry`` counts the
launches of each.

Layouts are the JAX ones: v ``[B, H, W, C]``; logits ``[B, H, W,
heads*K*K]``, head-major, the taps row-major (``t = ky*K + kx``, offset
``(ky - K//2, kx - K//2)``); out like v.

Rounding points of the forward (``_fwd_kernel`` :68-86): v and the logits
are read as fp32; each head's softmax is ``exp(l - max) / sum exp`` in fp32,
the sum taken over the taps in order; the probabilities **stay fp32** (the
default path casts them to the compute dtype first); the taps are summed in
fp32 in order, each product rounded apart, and the result is cast once to
v's dtype. A tap outside the image adds nothing and is not renormalised
away: padding is zero v.

The backward is no kernel: the TPU kernel's is ``jax.vjp`` of
``_xla_forward`` (:176-195), a softmax in fp32 **cast to v's dtype**, then
the XLA aggregate. :func:`outlook_softmax_autograd` recomputes that forward
(:func:`outlook_softmax_xla`) under autograd in its backward, so in bf16 the
forward and the backward round the probabilities at different points, as
the JAX package does.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple, Optional, Union

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.kernel_build import (
    SMS,
    check_aligned16,
    sm_blocks,
)
from outgridvit_tpu_torch.ops.outlook import outlook_aggregate


def _check(v: torch.Tensor, logits: torch.Tensor, heads: int, k: int) -> None:
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"kernel size {k} must be odd and > 0")
    if v.dim() != 4:
        raise ValueError(f"v must be [B, H, W, C]; got {tuple(v.shape)}")
    if heads <= 0 or v.shape[-1] % heads:
        raise ValueError(f"C={v.shape[-1]} must be divisible by heads={heads}")
    if logits.dim() != 4 or logits.shape[:3] != v.shape[:3] or \
            logits.shape[-1] != heads * k * k:
        want = (*v.shape[:3], heads * k * k)
        raise ValueError(f"logits must be [B, H, W, heads*K*K] = {want}; "
                         f"got {tuple(logits.shape)}")


def softmax_taps(logits: torch.Tensor, heads: int, k: int) -> torch.Tensor:
    """fp32 ``exp(l - max) / sum exp`` over each head's K*K taps, the sum
    in tap order: [B, H, W, heads*K*K] -> [B, H, W, heads, K*K]."""
    B, H, W, _ = logits.shape
    lg = logits.float().reshape(B, H, W, heads, k * k)
    e = torch.exp(lg - lg.amax(-1, keepdim=True))
    s = e[..., 0]
    for t in range(1, k * k):
        s = s + e[..., t]
    return e / s[..., None]


def outlook_softmax_agg_reference(v, logits, heads: int, k: int = 3):
    """Plain PyTorch version of #9: ``round(aggregate(v, softmax_taps(
    logits)))`` with the probabilities and the sum in fp32, [B, H, W, C] ->
    [B, H, W, C]."""
    _check(v, logits, heads, k)
    a = softmax_taps(logits, heads, k)
    return outlook_aggregate(v.float(), a, kernel_size=k).to(v.dtype)


def outlook_softmax_xla(v, logits, heads: int, k: int = 3):
    """The forward the backward differentiates (``_xla_forward``): the fp32
    softmax cast to v's dtype, then :func:`outlook_aggregate` (accumulated
    in v's dtype)."""
    _check(v, logits, heads, k)
    B, H, W, _ = v.shape
    a = torch.softmax(logits.float().reshape(B, H, W, heads, k * k), dim=-1)
    return outlook_aggregate(v, a.to(v.dtype), kernel_size=k)


# ---- the CUDA kernels -----------------------------------------------------

_MAX_SMEM = 227 * 1024
_PIX = 32  # pixels per block (kPix in csrc/outlook_softmax.cu)
PIX_RUNS = (4, 2)  # pixels a thread of the row kernel may take


class OutlookSoftmaxPlan(NamedTuple):
    """How ``ogvt_outlook_softmax_rows`` cuts one call: tiles of ``rows``
    whole image rows of one image (``tiles`` of them), each staged with a
    halo row above and below; a thread takes a run of ``pix`` adjacent
    pixels of one 8-channel chunk; ``blocks`` persistent blocks of
    ``threads`` threads and ``smem`` shared bytes walk the tiles,
    ``blocks_per_sm`` an SM at the register cap ``regs``."""
    rows: int
    pix: int
    tiles: int
    blocks: int
    threads: int
    smem: int
    regs: int
    blocks_per_sm: int


def _layout(W: int, C: int, heads: int, rows: int,
            pix: int) -> Optional[tuple]:
    """The row kernel's own answer (``csrc/outlook_softmax_layout.cpp``)
    for one layout: (threads, shared bytes, register cap), or None where it
    does not take it."""
    out = (ctypes.c_int * 3)()
    lib = kernel_build.load_layouts()
    return None if lib.ogvt_outlook_softmax_rows_layout(
        W, C, heads, rows, pix, out) else tuple(out)


def _rows_plan(B: int, H: int, W: int, C: int, heads: int, rows: int,
               pix: int) -> Optional[OutlookSoftmaxPlan]:
    """The row kernel's plan at ``rows`` and ``pix`` as its layout gives
    it (:func:`_layout`), or None where it does not take them: as many
    blocks as the card holds at once, at most one a tile."""
    got = _layout(W, C, heads, rows, pix)
    if got is None:
        return None
    threads, smem, regs = got
    per_sm = sm_blocks(threads, smem, regs)
    tiles = B * -(-H // rows)
    return OutlookSoftmaxPlan(rows, pix, tiles, min(tiles, SMS * per_sm),
                              threads, smem, regs, per_sm)


def _rows_cost(p: OutlookSoftmaxPlan) -> int:
    """Work a block, in image rows: waves of tiles over the card's resident
    blocks times a tile's rows and one more for its halo and barriers."""
    return -(-p.tiles // (SMS * p.blocks_per_sm)) * (p.rows + 1)


def _refusal(B: int, H: int, W: int, C: int, heads: int,
             k: int) -> Optional[str]:
    """Why the row kernel takes no layout of these shapes, or None."""
    if k != 3:
        return f"the row kernel takes K = 3 only, not K = {k}"
    if B < 1 or H < 1 or W < 1:
        return "an empty input"
    if heads < 1 or C % heads or (C // heads) % 8:
        return (f"the head width C / heads = {C} / {heads} must be a "
                "multiple of 8")
    return None


@lru_cache(maxsize=None)
def _fit(B: int, H: int, W: int, C: int, heads: int,
         k: int) -> Union[OutlookSoftmaxPlan, str]:
    """The row kernel's plan for these bf16 shapes, or why there is none (a
    str): runs of 4 pixels (2 on rows narrower than 8); of the tile heights
    the kernel takes, the least :func:`_rows_cost`, then the shortest. (A
    sweep of every layout on the card at the ten shapes of
    ``outlook_softmax_sweep``: runs of 4 beat 2 by 3-6% where W >= 32 and
    lost by 3-6% at W = 8 and 16; runs of 8 were within 3% of 4; this
    plan's layout is within 3% of the fastest at every shape of W >= 16
    and within 0.6 us of it at the rest.)"""
    why = _refusal(B, H, W, C, heads, k)
    if why:
        return why
    pix = 4 if W >= 8 else 2
    best = None
    for rows in range(1, H + 1):
        p = _rows_plan(B, H, W, C, heads, rows, pix)
        if p is None:
            break  # a taller tile needs more shared memory
        key = (_rows_cost(p), rows)
        if best is None or key < best[0]:
            best = (key, p)
    if best is None:
        return "no tile of one image row fits one block's shared memory"
    return best[1]


def outlook_softmax_plan(B: int, H: int, W: int, C: int, heads: int,
                         k: int = 3, dtype: torch.dtype = torch.bfloat16
                         ) -> OutlookSoftmaxPlan:
    """The row kernel's launch plan for v ``[B, H, W, C]``, ``heads``
    heads and K = ``k``, or a ValueError naming what it does not take:
    fp32, K != 3, a head width that is not a multiple of 8, and shapes
    whose tile of one image row does not fit an H100 block's shared memory,
    as the kernel's own layout says (:func:`_layout`). Cached: the wrapper
    asks at every launch."""
    where = (f"outlook softmax (rows): B={B}, H={H}, W={W}, C={C}, "
             f"heads={heads}, K={k}, {dtype}")
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the row kernel takes bf16 only")
    plan = _fit(B, H, W, C, heads, k)
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


ENTRIES = ("ogvt_outlook_softmax_rows", "ogvt_outlook_softmax")


def softmax_entry(B: int, H: int, W: int, C: int, heads: int, k: int,
                  dtype: torch.dtype) -> str:
    """The C entry point a launch of these shapes takes:
    ``ogvt_outlook_softmax_rows`` where :func:`outlook_softmax_plan` takes
    the shape, else ``ogvt_outlook_softmax`` (``csrc/outlook_softmax.cu``).
    Decided by dtype and shape alone, before the launch."""
    if dtype == torch.bfloat16 and not isinstance(
            _fit(B, H, W, C, heads, k), str):
        return ENTRIES[0]
    return ENTRIES[1]


def _launch(entry: Optional[str], v, logits, heads: int, k: int = 3,
            plan: Optional[OutlookSoftmaxPlan] = None):
    """#9 forward on the card through the C entry point ``entry`` (one of
    :data:`ENTRIES`), or :func:`softmax_entry`'s where it is None. A named
    entry, or a ``plan`` other than :func:`outlook_softmax_plan`'s (any of
    :func:`_rows_plan`), is for comparing kernels and layouts on the same
    inputs (``chip_smoke.py``'s A/B, the card tests)."""
    name = "outlook_softmax_agg"
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    if v.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {v.dtype} is not float32/bfloat16")
    _check(v, logits, heads, k)
    if logits.dtype != v.dtype or logits.device != v.device:
        raise ValueError(f"{name}: logits are {logits.dtype} on "
                         f"{logits.device}; expected {v.dtype} on {v.device}")
    if not (v.is_contiguous() and logits.is_contiguous()):
        raise ValueError(f"{name}: v and logits must be contiguous")
    B, H, W, C = v.shape
    if entry is None:
        entry = softmax_entry(B, H, W, C, heads, k, v.dtype)
    elif entry not in ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of {ENTRIES}")
    rows = entry == ENTRIES[0]
    if rows:
        plan = plan or outlook_softmax_plan(B, H, W, C, heads, k, v.dtype)
        check_aligned16(name, v=v)
    elif 4 * _PIX * heads * k * k > _MAX_SMEM:
        raise ValueError(f"{name}: {heads} heads of {k}x{k} taps exceed "
                         "shared memory")
    out = torch.empty_like(v)
    lib = kernel_build.load()
    ptrs = (v.data_ptr(), logits.data_ptr(), out.data_ptr(), B, H, W, C,
            heads)
    code = kernel_build.DTYPE_CODES[v.dtype]
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rows:
            err = lib.ogvt_outlook_softmax_rows(
                *ptrs, plan.rows, plan.pix, code, plan.blocks, plan.smem,
                stream)
        else:
            err = lib.ogvt_outlook_softmax(*ptrs, k, code, stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    kernel_build.count_launch(outlook_softmax_agg, None, entry)
    return out


def outlook_softmax_agg(v, logits, heads: int, k: int = 3):
    """#9 forward, [B, H, W, C] -> [B, H, W, C]. A CUDA tensor launches a
    kernel (or raises): ``csrc/outlook_softmax_rows.cu`` where
    :func:`softmax_entry` says so (v 16-byte aligned or a ValueError), else
    ``csrc/outlook_softmax.cu``; a CPU tensor takes
    :func:`outlook_softmax_agg_reference`. Under tracing it is the op
    ``ogvt::outlook_softmax_agg`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("outlook_softmax_agg")(v, logits,
                                                             heads, k)
    if v.device.type == "cpu":
        return outlook_softmax_agg_reference(v, logits, heads, k)
    return _launch(None, v, logits, heads, k)


outlook_softmax_agg.launches = 0
outlook_softmax_agg.by_entry = Counter()


class _OutlookSoftmax(torch.autograd.Function):
    """Forward: the kernel (or its plain version); backward: autograd of
    :func:`outlook_softmax_xla`, recomputed from the saved v and logits
    (``_bwd_vjp``)."""

    @staticmethod
    def forward(ctx, v, logits, heads, k, use_kernels):
        ctx.save_for_backward(v, logits)
        ctx.heads, ctx.k = heads, k
        fn = outlook_softmax_agg if use_kernels else \
            outlook_softmax_agg_reference
        return fn(v, logits, heads, k)

    @staticmethod
    def backward(ctx, g):
        v, logits = (t.detach().requires_grad_(True)
                     for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = outlook_softmax_xla(v, logits, ctx.heads, ctx.k)
            dv, dl = torch.autograd.grad(y, (v, logits), g)
        return dv, dl, None, None, None


def outlook_softmax_autograd(v, logits, heads: int, k: int = 3,
                             use_kernels: bool = False):
    """Differentiable #9: the kernel forward with ``use_kernels``, else its
    plain version; the backward of ``_xla_forward`` either way."""
    return _OutlookSoftmax.apply(v, logits, heads, k, use_kernels)
