"""Fused pre-LN channel-MLP branch: its CUDA kernels and their plain
PyTorch versions. The kernels stand for two TPU kernels that compute the
same math and rounding points in different VMEM layouts:
``outgridvit_tpu/ops/mlp_branch_pallas_t.py:mlp_branch_pallas_t`` (#2,
variant ``"t"``) and the row-layout
``outgridvit_tpu/ops/mlp_branch_pallas.py:mlp_branch_pallas`` (#4, variant
``"row"``). The variant only tags the launch count (``mlp_branch.by_variant``).

Each direction has two kernels, picked by dtype and shape before launch: a
bf16 launch whose C and H are multiples of 16 (every shipped shape) runs a
tensor-core kernel, ``csrc/mlp_branch_mma.cu`` forward
(``ogvt_mlp_branch_mma``: fc1 and fc2 on ``mma.sync`` tiles, launch plan
:func:`mlp_branch_forward_plan`) and ``csrc/mlp_branch_bwd_mma.cu``
backward (``ogvt_mlp_branch_bwd_mma``: all five products, launch plan
:func:`mlp_branch_backward_plan`); fp32 launches, and the bf16 shapes those
plans refuse, run the fp32 FMA pipe's ``csrc/mlp_branch.cu``
(``ogvt_mlp_branch``) and ``csrc/mlp_branch_bwd.cu``
(``ogvt_mlp_branch_bwd``). Launches are counted per C entry point
(``mlp_branch.by_entry``, ``mlp_branch_backward.by_entry``). Both plans ask
the kernels' one layout, ``csrc/mlp_branch_mma_layout.h``, through
:func:`_layout`.

``y = fc2(act(fc1(LN(x))))`` per token with the kernel's rounding points:
LN with fp32 statistics cast to x.dtype; ``xn.w1`` summed in fp32, ``+ b1``,
cast; ``act`` in fp32, cast; ``a.w2`` summed in fp32, ``+ b2``, cast.
Weights are in the JAX layout: w1 [C, H], w2 [H, C]. The backward is
:func:`mlp_branch_backward_reference`'s math; :func:`mlp_branch_autograd`
is the differentiable branch the model calls (a ``torch.autograd.Function``
that saves only its inputs).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.activations import (
    activation_grad,
    make_activation,
)
from outgridvit_tpu_torch.ops.kernel_build import (
    SMS,
    check_aligned16,
    sm_blocks,
)

_ACT_CODES = {"gelu": 0, "silu": 1, "relu": 2}  # enum Act in csrc/act.cuh
_MAX_C = 4096
VARIANTS = ("t", "row")  # mlp_branch_pallas_t (#2), mlp_branch_pallas (#4)


def mlp_branch_variant(spatial: int, C: int) -> str:
    """The JAX kernel an NHWC map of ``spatial`` = H*W pixels and C channels
    stands for: the row layout for H*W >= 4096 and C <= 64
    (``outgridvit_tpu/models/layers.py:241``), the transposed one
    otherwise."""
    return "row" if spatial >= 4096 and C <= 64 else "t"


def layernorm_fp32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` numerics over the last axis: fp32 statistics,
    fast variance clamped at 0, ``(x-mu) * (rsqrt(var+eps)*scale) + bias``,
    cast back to x.dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return ((x32 - mu) * (torch.rsqrt(var + eps) * scale.float())
            + bias.float()).to(x.dtype)


def mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, act: str,
                         eps: float = 1e-5, apply_ln: bool = True):
    """Plain PyTorch version: x [..., C] -> [..., C]."""
    dt = x.dtype
    xn = layernorm_fp32(x, ln_scale, ln_bias, eps) if apply_ln else x
    h = (xn.float() @ w1.float() + b1.float()).to(dt)
    a = make_activation(act)(h.float()).to(dt)
    return (a.float() @ w2.float() + b2.float()).to(dt)


def mlp_branch_backward_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                                  act: str, eps: float = 1e-5,
                                  apply_ln: bool = True):
    """Plain PyTorch version of the backward, written out (not autograd),
    with the rounding points of the Pallas ``_bwd_kernel``:
    ``h32 = round(xn.w1 + b1)``, ``a = round(act(h32))``,
    ``dh = round(da * act'(h32))``, db1 summing the rounded dh, the LN
    backward in fp32 from xhat and rstd. Parameter grads are summed in fp32
    over all tokens and returned in their input's dtype. Returns
    ``(dx, dln_scale, dln_bias, dw1, db1, dw2, db2)``."""
    dt = x.dtype
    C = x.shape[-1]
    x32 = x.reshape(-1, C).float()
    dy32 = dy.reshape(-1, C).float()
    if apply_ln:
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu,
                          min=0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (x32 - mu) * rstd
        xn = ((x32 - mu) * (rstd * ln_scale.float()) + ln_bias.float()).to(dt)
    else:
        xn = x.reshape(-1, C)
    xn32 = xn.float()
    h32 = (xn32 @ w1.float() + b1.float()).to(dt).float()
    a = make_activation(act)(h32).to(dt).float()
    dw2 = a.t() @ dy32
    db2 = dy32.sum(0)
    dh = (dy32 @ w2.float().t() * activation_grad(act)(h32)).to(dt).float()
    dw1 = xn32.t() @ dh
    db1 = dh.sum(0)
    dxn = dh @ w1.float().t()
    if apply_ln:
        dls = (dxn * xhat).sum(0)
        dlb = dxn.sum(0)
        dxhat = dxn * ln_scale.float()
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    else:
        dls = dlb = torch.zeros(C, dtype=torch.float32, device=x.device)
        dx = dxn
    return (dx.to(dt).reshape(x.shape), dls.to(ln_scale.dtype),
            dlb.to(ln_bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(b2.dtype))


# ---- the bf16 tensor-core kernels' launch plans (csrc/mlp_branch_mma.cu,
# csrc/mlp_branch_bwd_mma.cu)

MMA_UNITS = (256, 128, 64, 32)  # hidden units a weights block may own
MMA_ROWS = (128, 64, 32)        # tokens a weights tile may take
MMA_MAX_TOKEN_BLOCKS = 1056  # the token partials summed in order
MMA_MAX_WORKSPACE = 16 << 20  # floats of weight partials (64 MB)


# the layout queries of csrc/mlp_branch_mma_layout.cpp and how many ints
# each answers
_LAYOUTS = {"forward": ("ogvt_mlp_branch_fwd_mma_layout", 5),
            "tokens": ("ogvt_mlp_branch_bwd_mma_tokens_layout", 5),
            "weights": ("ogvt_mlp_branch_bwd_mma_weights_layout", 4)}


def _layout(kind: str, *args: int) -> Optional[tuple]:
    """The kernels' own answer (``csrc/mlp_branch_mma_layout.cpp``) for one
    layout: ``kind`` "forward" (C, H, split, weight buffers, 0 for
    resident, activation code) gives (threads, shared bytes, register cap,
    tokens a tile, units a chunk); "tokens" (C, split, weight buffers) the
    same for the backward's tokens kernel; "weights" (C, units, rows,
    buffers) gives (threads, shared bytes, register cap, m16 tiles a warp);
    None where the kernel does not take it."""
    name, n = _LAYOUTS[kind]
    out = (ctypes.c_int * n)()
    fn = getattr(kernel_build.load_layouts(), name)
    return None if fn(*args, out) else tuple(out)


def _splits(tiles: int, slabs: int, slots: int, most: int) -> int:
    """Token splits of the weights kernel: the fewest that minimise its
    waves of ``slabs * splits`` blocks over the card's ``slots`` resident
    blocks times the tiles each block walks (at most ``most``, the
    workspace's cap)."""
    return min(range(1, min(tiles, most) + 1),
               key=lambda s: (-(-slabs * s // slots) * -(-tiles // s), s))


class MlpFwdPlan(NamedTuple):
    """How ``ogvt_mlp_branch_mma`` cuts one call: ``split`` warps share each
    16-row tile (C / split y columns each), so a tile is ``rows`` tokens;
    H is walked in chunks of ``chunk`` units, with w1 and w2 resident in
    shared memory (``buffers`` 0) or staged a chunk at a time in
    ``buffers`` buffers; ``blocks`` blocks of ``smem`` shared bytes each
    walk a contiguous run of ``tiles_per_block`` of the ``tiles`` tiles,
    at most ``blocks_per_sm`` an SM at the register cap ``regs``."""
    split: int
    rows: int
    chunk: int
    buffers: int
    tiles: int
    tiles_per_block: int
    blocks: int
    smem: int
    regs: int
    blocks_per_sm: int

    def args(self):
        """The plan's arguments of ``ogvt_mlp_branch_mma``, in order."""
        return (self.split, self.buffers, self.blocks, self.smem)


def _fwd_layouts(C: int, H: int, act: str = "gelu"):
    """(split, buffers, threads, shared bytes, register cap, rows, chunk)
    of every forward layout the kernel takes at C, H and ``act``."""
    out = []
    for split in (1, 2, 4, 8):
        for buffers in (0, 2, 1):
            got = _layout("forward", C, H, split, buffers, _ACT_CODES[act])
            if got is not None:
                out.append((split, buffers, *got))
    return out


def _fwd_plan(M: int, C: int, H: int, split: int, buffers: int,
              act: str = "gelu"):
    """The forward plan of one layout: about one wave of blocks, each a
    contiguous run of tiles (the last runs as long as the first but one)."""
    lay = _layout("forward", C, H, split, buffers, _ACT_CODES[act])
    if lay is None or M < 1:
        raise ValueError(f"mlp_branch (mma): M={M}, C={C}, H={H}: the kernel "
                         f"takes no layout of split {split}, buffers "
                         f"{buffers}")
    threads, smem, regs, rows, chunk = lay
    per_sm = sm_blocks(threads, smem, regs)
    tiles = -(-M // rows)
    per = -(-tiles // (SMS * per_sm))
    blocks = -(-tiles // per)
    return MlpFwdPlan(split, rows, chunk, buffers, tiles, -(-tiles // blocks),
                      blocks, smem, regs, per_sm)


# The forward plan's cost model, fitted to a sweep of every layout at the
# shipped MLP shapes (batch 64 and 128) on the card: a block's time for a
# token a split costs (more exchanges and fewer reuses of each B fragment
# as the split grows), a block alone on its SM against two (0.65), and
# the staging of the weights: resident and reused over tiles, resident
# for one tile (staged before the first product, not behind it), two
# buffers, one buffer.
_SPLIT_COST = {1: 1.0, 2: 1.05, 4: 1.5, 8: 1.8}
_ALONE = 0.65
_STAGING = {"resident": 1.0, "resident once": 1.1, 2: 1.05, 1: 1.1}


def _fwd_cost(p: MlpFwdPlan) -> float:
    """The modelled device time of a forward plan, in token-steps of its
    busiest block."""
    alone = -(-p.blocks // SMS) == 1
    staging = (p.buffers if p.buffers else "resident" if p.tiles_per_block > 1
               else "resident once")
    return (p.tiles_per_block * p.rows * _SPLIT_COST[p.split]
            * (_ALONE if alone else 1.0) * _STAGING[staging])


@lru_cache(maxsize=None)
def _fit_forward(M: int, C: int, H: int, act: str = "gelu"):
    """The forward plan for bf16 x ``[M, C]``, hidden width H and ``act``,
    or why there is none (a str): of the layouts the kernel takes, the one
    of the least :func:`_fwd_cost` (within 2.1% of the fastest layout at
    every shipped shape, 0.01% over all of them, in the sweep); then
    resident weights, two buffers, the smallest split."""
    best = None
    for split, buffers, *_ in _fwd_layouts(C, H, act):
        p = _fwd_plan(M, C, H, split, buffers, act)
        key = (_fwd_cost(p), (0, 2, 1).index(buffers), split)
        if best is None or key < best[0]:
            best = (key, p)
    if best is None:
        return ("the y columns do not split over 1, 2, 4 or 8 warps in "
                "multiples of 16 up to 128 within one block's shared memory")
    return best[1]


def mlp_branch_forward_plan(M: int, C: int, H: int,
                            dtype: torch.dtype = torch.bfloat16,
                            act: str = "gelu") -> MlpFwdPlan:
    """The tensor-core forward's launch plan for x ``[M, C]``, hidden width
    H and activation ``act`` (SiLU's register cap differs), or a
    ValueError naming the shape it does not take: fp32 (the
    FMA kernel's), C or H not a multiple of 16, M < 1, and C whose y columns
    fit no layout within an H100 block's shared memory, as the kernel's
    own layout says (:func:`_layout`). Cached: the wrapper asks at every
    launch."""
    where = f"mlp_branch (mma): M={M}, C={C}, H={H}, {dtype}"
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    if not _takes(M, C, H, dtype):
        raise ValueError(f"{where}: C and H must be multiples of 16, M >= 1")
    plan = _fit_forward(M, C, H, act)
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


def forward_entry(M: int, C: int, H: int, dtype: torch.dtype) -> str:
    """The C entry point a forward launch of these shapes takes:
    ``ogvt_mlp_branch_mma`` where :func:`mlp_branch_forward_plan` takes the
    shape (bf16, C and H multiples of 16, a layout that fits), else the FMA
    kernel's ``ogvt_mlp_branch``. Decided by dtype and shape alone."""
    if _takes(M, C, H, dtype) and not isinstance(_fit_forward(M, C, H), str):
        return "ogvt_mlp_branch_mma"
    return "ogvt_mlp_branch"


class MlpBwdPlan(NamedTuple):
    """How ``ogvt_mlp_branch_bwd_mma`` cuts one call. Tokens kernel:
    ``t_split`` warps share each 16-row tile (C / t_split dxn columns
    each), so a tile is ``t_rows`` tokens; H is walked in chunks of
    ``t_chunk`` units, ``t_buffers`` of them staged at once; ``t_blocks``
    blocks of ``t_smem`` shared bytes walk the ``t_tiles`` tiles, at most
    ``t_blocks_per_sm`` an SM at the register cap ``t_regs``. Weights
    kernel: a block owns ``w_units`` hidden units (``w_slabs`` slabs) and
    one of ``w_splits`` contiguous runs of ``w_tiles_per_split`` tiles of
    ``w_rows`` tokens (``w_buffers`` staged at once); a warp holds
    ``w_mt`` m16 tiles of C (the kernel's template) of each slab; ``w_smem``
    shared bytes, ``w_blocks_per_sm`` an SM at ``w_regs``. ``ws_floats``:
    the fp32 workspace of both kernels' partials."""
    t_split: int
    t_rows: int
    t_chunk: int
    t_buffers: int
    t_tiles: int
    t_blocks: int
    t_smem: int
    t_regs: int
    t_blocks_per_sm: int
    w_units: int
    w_rows: int
    w_mt: int
    w_buffers: int
    w_slabs: int
    w_splits: int
    w_tiles_per_split: int
    w_smem: int
    w_regs: int
    w_blocks_per_sm: int
    ws_floats: int

    def args(self):
        """The plan's arguments of ``ogvt_mlp_branch_bwd_mma``, in order."""
        return (self.t_split, self.t_buffers, self.t_blocks, self.t_smem,
                self.w_units, self.w_rows, self.w_mt, self.w_buffers,
                self.w_splits, self.w_smem)


def _takes(M: int, C: int, H: int, dtype: torch.dtype) -> bool:
    """Whether the dtype and the shapes are ones the tensor-core kernel
    can take at all: bf16, C and H multiples of 16, M >= 1."""
    return (dtype == torch.bfloat16 and M >= 1 and C >= 16 and H >= 16
            and not C % 16 and not H % 16)


@lru_cache(maxsize=None)
def _fit(M: int, C: int, H: int):
    """The plan for bf16 x ``[M, C]`` and hidden width H, or why there is
    none (a str): no tokens-kernel or weights-kernel layout the kernel
    takes (``_layout``)."""
    # tokens kernel: of the splits the kernel takes, the smallest (the
    # tallest tiles), then the layout that keeps the most blocks on an SM,
    # then two weight buffers; two waves of blocks (a sweep of the layouts
    # at the shipped shapes on the card)
    tokens = []
    for split in (1, 2, 4):
        for buffers in (2, 1):
            got = _layout("tokens", C, split, buffers)
            if got is not None:
                threads, smem, regs, rows, chunk = got
                per_sm = sm_blocks(threads, smem, regs)
                tokens.append(((-split, per_sm, buffers), split, buffers,
                               rows, chunk, smem, regs, per_sm))
    if not tokens:
        return ("the dxn columns do not split over 1, 2 or 4 warps in "
                "multiples of 16 within one block's shared memory")
    _, split, buffers, t_rows, chunk, t_smem, t_regs, t_per_sm = max(tokens)
    t_tiles = -(-M // t_rows)
    t_blocks = min(t_tiles, 2 * SMS * t_per_sm, MMA_MAX_TOKEN_BLOCKS)

    best = None
    for units in MMA_UNITS:
        if units > 32 * -(-H // 32):
            continue
        for rows in MMA_ROWS:
            for wbuf in (2, 1):
                got = _layout("weights", C, units, rows, wbuf)
                if got is None:
                    continue
                threads, smem, regs, mt = got
                # the widest slab (the fewest reads of x and dy), then tiles
                # of 64 tokens, then 128, then x and dy staged ahead (a
                # sweep of every layout at the shipped shapes on the card)
                key = (units, rows == 64, rows, wbuf)
                if best is None or key > best[0]:
                    best = (key, units, rows, mt, wbuf, smem, regs,
                            sm_blocks(threads, smem, regs))
    if best is None:
        return "no weights-kernel layout fits one block's shared memory"
    _, units, rows, w_mt, wbuf, w_smem, w_regs, w_per_sm = best
    slabs = -(-H // units)
    w_tiles = -(-M // rows)
    per_split = 2 * C * H + H
    splits = _splits(w_tiles, slabs, SMS * w_per_sm,
                     max(1, MMA_MAX_WORKSPACE // per_split))
    tiles_per_split = -(-w_tiles // splits)
    splits = -(-w_tiles // tiles_per_split)
    return MlpBwdPlan(split, t_rows, chunk, buffers, t_tiles, t_blocks,
                      t_smem, t_regs, t_per_sm, units, rows, w_mt, wbuf,
                      slabs, splits, tiles_per_split, w_smem, w_regs,
                      w_per_sm, 3 * C * t_blocks + per_split * splits)


def mlp_branch_backward_plan(M: int, C: int, H: int,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> MlpBwdPlan:
    """The tensor-core backward's launch plan for x ``[M, C]`` and hidden
    width H, or a ValueError naming the shape it does not take: fp32 (the
    FMA kernel's), C or H not a multiple of 16, C whose dxn columns do not
    split over 1, 2 or 4 warps in multiples of 16 up to 128, and layouts
    that do not fit an H100 block's shared memory, as the kernel's own
    layout says (``_layout``). Cached: the wrapper asks at every launch."""
    where = f"mlp_branch_backward (mma): M={M}, C={C}, H={H}, {dtype}"
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    if not _takes(M, C, H, dtype):
        raise ValueError(f"{where}: C and H must be multiples of 16, M >= 1")
    plan = _fit(M, C, H)
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


def backward_entry(M: int, C: int, H: int, dtype: torch.dtype) -> str:
    """The C entry point a backward launch of these shapes takes:
    ``ogvt_mlp_branch_bwd_mma`` where :func:`mlp_branch_backward_plan`
    takes the shape (bf16, C and H multiples of 16, a layout that fits),
    else the FMA kernel's ``ogvt_mlp_branch_bwd``. Decided by dtype and
    shape alone."""
    if _takes(M, C, H, dtype) and not isinstance(_fit(M, C, H), str):
        return "ogvt_mlp_branch_bwd_mma"
    return "ogvt_mlp_branch_bwd"


def _check_launch(name, x, ln_scale, ln_bias, w1, b1, w2, b2, act, variant):
    """Validate what the kernels take; returns (M, C, H, act code)."""
    kernel_build.check_variant(name, variant, VARIANTS)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    act = act.lower()
    if act not in _ACT_CODES:
        raise ValueError(f"{name}: unknown activation '{act}'")
    C = x.shape[-1]
    H = w1.shape[-1] if w1.dim() == 2 else -1
    want = {"w1": (w1, (C, H), x.dtype), "b1": (b1, (H,), x.dtype),
            "w2": (w2, (H, C), x.dtype), "b2": (b2, (C,), x.dtype),
            "ln_scale": (ln_scale, (C,), torch.float32),
            "ln_bias": (ln_bias, (C,), torch.float32)}
    for tname, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name}: {tname} is {tuple(t.shape)} {t.dtype}; "
                f"expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: {tname} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not 1 <= C <= _MAX_C:
        raise ValueError(f"{name}: C={C} outside 1..{_MAX_C}")
    return x.numel() // C, C, H, _ACT_CODES[act]


FORWARD_ENTRIES = ("ogvt_mlp_branch_mma", "ogvt_mlp_branch")


def mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2, act: str,
               eps: float = 1e-5, apply_ln: bool = True, variant: str = "t"):
    """x [..., C] -> [..., C]. A CUDA tensor launches a kernel (or raises):
    ``csrc/mlp_branch_mma.cu`` where :func:`forward_entry` says so (bf16, C
    and H multiples of 16; x, w1 and w2 16-byte aligned or a ValueError),
    else ``csrc/mlp_branch.cu``; a CPU tensor takes
    :func:`mlp_branch_reference`. ``variant`` names the JAX kernel the
    launch stands for (:data:`VARIANTS`). Under tracing it is the op
    ``ogvt::mlp_branch`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("mlp_branch")(
            x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps, apply_ln, variant)
    if x.device.type == "cpu":
        return mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                                    eps, apply_ln)
    return _launch_forward(None, x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                           eps, apply_ln, variant)


def _launch_forward(entry: Optional[str], x, ln_scale, ln_bias, w1, b1, w2,
                    b2, act: str, eps: float = 1e-5, apply_ln: bool = True,
                    variant: str = "t", plan: Optional[MlpFwdPlan] = None):
    """:func:`mlp_branch` on the card through the C entry point ``entry``
    (one of :data:`FORWARD_ENTRIES`), or :func:`forward_entry`'s where it
    is None. A named entry, or a ``plan`` other than
    :func:`mlp_branch_forward_plan`'s (any of :func:`_fwd_plan`), is for
    comparing kernels and layouts on the same inputs (``chip_smoke.py``'s
    A/B, the card tests)."""
    M, C, H, code = _check_launch("mlp_branch", x, ln_scale, ln_bias, w1, b1,
                                  w2, b2, act, variant)
    if entry is None:
        entry = forward_entry(M, C, H, x.dtype)
    elif entry not in FORWARD_ENTRIES:
        raise ValueError(f"mlp_branch: entry {entry!r} is not one of "
                         f"{FORWARD_ENTRIES}")
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), M, C, H, code, float(eps), int(bool(apply_ln)),
            kernel_build.DTYPE_CODES[x.dtype])
    if entry == "ogvt_mlp_branch_mma":
        plan = plan or mlp_branch_forward_plan(M, C, H, x.dtype,
                                               act.lower())
        check_aligned16("mlp_branch", x=x, w1=w1, w2=w2)
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if entry == "ogvt_mlp_branch":
            err = lib.ogvt_mlp_branch(*ptrs, stream)
        else:
            err = lib.ogvt_mlp_branch_mma(*ptrs, *plan.args(), stream)
    kernel_build.check(err, f"mlp_branch launch ({entry})")
    kernel_build.count_launch(mlp_branch, variant, entry)
    return y


mlp_branch.launches = 0
mlp_branch.by_variant = Counter()
mlp_branch.by_entry = Counter()


BACKWARD_ENTRIES = ("ogvt_mlp_branch_bwd_mma", "ogvt_mlp_branch_bwd")


def mlp_branch_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, dy, act: str,
                        eps: float = 1e-5, apply_ln: bool = True,
                        variant: str = "t"):
    """Gradients ``(dx, dln_scale, dln_bias, dw1, db1, dw2, db2)`` of the
    branch for the output gradient ``dy``. A CUDA tensor launches the kernels
    (or raises): ``csrc/mlp_branch_bwd_mma.cu`` where
    :func:`backward_entry` says so (bf16, C and H multiples of 16; x, w1,
    w2 and dy 16-byte aligned or a ValueError), else
    ``csrc/mlp_branch_bwd.cu``; a CPU tensor takes
    :func:`mlp_branch_backward_reference`. Deterministic: two calls on the
    same inputs give bitwise-equal grads. ``variant`` as in
    :func:`mlp_branch`."""
    if x.device.type == "cpu":
        return mlp_branch_backward_reference(x, ln_scale, ln_bias, w1, b1, w2,
                                             b2, dy, act, eps, apply_ln)
    return _launch_backward(None, x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                            act, eps, apply_ln, variant)


def _launch_backward(entry: Optional[str], x, ln_scale, ln_bias, w1, b1, w2,
                     b2, dy, act: str, eps: float = 1e-5,
                     apply_ln: bool = True, variant: str = "t"):
    """:func:`mlp_branch_backward` on the card through the C entry point
    ``entry`` (one of :data:`BACKWARD_ENTRIES`), or :func:`backward_entry`'s
    where it is None. A named entry is for comparing the two kernels on
    the same inputs (``chip_smoke.py``'s A/B, the card tests)."""
    M, C, H, code = _check_launch("mlp_branch_backward", x, ln_scale, ln_bias,
                                  w1, b1, w2, b2, act, variant)
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(
            f"mlp_branch_backward: dy is {tuple(dy.shape)} {dy.dtype} on "
            f"{dy.device}; expected contiguous {tuple(x.shape)} {x.dtype} "
            f"on {x.device}")
    if entry is None:
        entry = backward_entry(M, C, H, x.dtype)
    elif entry not in BACKWARD_ENTRIES:
        raise ValueError(f"mlp_branch_backward: entry {entry!r} is not one "
                         f"of {BACKWARD_ENTRIES}")
    plan: Optional[MlpBwdPlan] = None
    if entry == "ogvt_mlp_branch_bwd_mma":
        plan = mlp_branch_backward_plan(M, C, H, x.dtype)
        check_aligned16("mlp_branch_backward", x=x, w1=w1, w2=w2, dy=dy)
    lib = kernel_build.load()
    n_ws = (lib.ogvt_mlp_branch_bwd_workspace(M, C, H) if plan is None
            else lib.ogvt_mlp_branch_bwd_mma_workspace(M, C, H, plan.t_blocks,
                                                       plan.w_splits))
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    grads = (torch.empty_like(x), torch.empty_like(ln_scale),
             torch.empty_like(ln_bias), torch.empty_like(w1),
             torch.empty_like(b1), torch.empty_like(w2), torch.empty_like(b2))
    ptrs = (x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), M, C, H, code,
            float(eps), int(bool(apply_ln)),
            kernel_build.DTYPE_CODES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is None:
            err = lib.ogvt_mlp_branch_bwd(*ptrs, stream)
        else:
            err = lib.ogvt_mlp_branch_bwd_mma(*ptrs, *plan.args(), stream)
    kernel_build.check(err, f"mlp_branch_backward launch ({entry})")
    kernel_build.count_launch(mlp_branch_backward, variant, entry)
    return grads


mlp_branch_backward.launches = 0
mlp_branch_backward.by_variant = Counter()
mlp_branch_backward.by_entry = Counter()


class _MLPBranch(torch.autograd.Function):
    """Recompute style, as ``_mlp_fwd``/``_mlp_bwd``: saves only the
    inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps,
                apply_ln, use_kernels, variant):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.cfg = (act, eps, apply_ln, use_kernels, variant)
        args = (x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps, apply_ln)
        if use_kernels:
            return mlp_branch(*args, variant)
        return mlp_branch_reference(*args)

    @staticmethod
    def backward(ctx, dy):
        act, eps, apply_ln, use_kernels, variant = ctx.cfg
        args = (*ctx.saved_tensors, dy.contiguous(), act, eps, apply_ln)
        if use_kernels:
            grads = mlp_branch_backward(*args, variant)
        else:
            grads = mlp_branch_backward_reference(*args)
        return (*grads, None, None, None, None, None)


def mlp_branch_autograd(x, ln_scale, ln_bias, w1, b1, w2, b2, act: str,
                        eps: float = 1e-5, apply_ln: bool = True,
                        use_kernels: bool = False, variant: str = "t"):
    """Differentiable fused branch: the kernels (:func:`mlp_branch`,
    :func:`mlp_branch_backward`) with ``use_kernels``, else the plain
    versions, both ways."""
    return _MLPBranch.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps,
                            apply_ln, use_kernels, variant)
