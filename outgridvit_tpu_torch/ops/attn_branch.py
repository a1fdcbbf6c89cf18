"""Fused pre-LN grid-attention branch ``y = proj(MHSA(qkv(LN(x))))`` for
grids of N >= 64 tokens: the CUDA kernels ``csrc/attn_branch.cu``,
``csrc/attn_branch_mma.cu`` and ``csrc/attn_branch_bwd_mma.cu`` (forward
and backward) and their plain PyTorch versions (twin of
``outgridvit_tpu/ops/attn_branch_pallas.py:attn_branch_pallas`` and its
recompute backward).

x is ``[G, N, C]`` (one row of tokens per grid); the LN scale and bias are
fp32 ``[C]``; ``wqkv [C, 3C]``, ``bqkv [3C]``, ``wproj [C, C]``, ``bproj
[C]`` are in the compute dtype, in the JAX layout. qkv's last axis is laid
out (3, heads, hd).

Forward rounding points (``_rows_fwd``): LN with fp32 statistics (fast
variance clamped at 0) cast to the compute dtype; ``qkv = round(xn.wqkv +
bqkv)`` summed in fp32; fp32 logits scaled after the sum; an fp32 softmax
with max subtraction, normalized by division; the probabilities cast to the
compute dtype before P.V; P.V summed in fp32 and cast once;
``y = round(out.wproj + bproj)``.

The backward (:func:`attn_branch_backward_reference`, ``_rows_bwd``) saves
only the inputs and recomputes the rest. :func:`attn_branch_autograd` is the
differentiable branch the model calls.

Each direction has two kernels, picked by dtype and shape before launch
(:func:`forward_entry`, :func:`backward_entry`): a bf16 launch at a shape
the tensor-core kernels are instantiated at (grids of 64 tokens, C = 64
with heads of 32 and C = 80 with heads of 40: every shipped shape) runs
``csrc/attn_branch_mma.cu`` forward (``ogvt_attn_branch[_nhwc]_mma``,
launch plan :func:`attn_branch_forward_plan`) and
``csrc/attn_branch_bwd_mma.cu`` backward
(``ogvt_attn_branch[_nhwc]_bwd_mma``, launch plan
:func:`attn_branch_backward_plan`), every product on ``mma.sync`` tiles;
fp32 launches and other shapes run the FMA kernels of
``csrc/attn_branch.cu`` (``ogvt_attn_branch[_nhwc]``,
``ogvt_attn_branch[_nhwc]_bwd``). Launches are counted per C entry point
(``attn_branch.by_entry``, ``attn_branch_nhwc.by_entry``,
``attn_branch_backward.by_entry``, ``attn_branch_nhwc_backward.by_entry``).

The NHWC variant (twin of ``outgridvit_tpu/ops/experimental/
attn_branch_nhwc_pallas.py:attn_branch_nhwc_pallas``, TPU kernel #12)
computes ``grid_unpartition(branch(grid_partition(x, g)))`` on the raw map
x ``[B, H, W, C]``: its kernels are the same ones with the partition folded
into their loads and stores (:func:`attn_branch_nhwc`,
:func:`attn_branch_nhwc_backward`, :func:`attn_branch_nhwc_autograd`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.grid import grid_partition, grid_unpartition
from outgridvit_tpu_torch.ops.grid_attention import grid_mhsa_reference
from outgridvit_tpu_torch.ops.kernel_build import (
    SMS,
    check_aligned16,
    sm_blocks,
)
from outgridvit_tpu_torch.ops.mlp_branch import layernorm_fp32

MIN_TOKENS = 64  # the JAX dispatch fuses the branch for N >= 64
_MAX_SMEM = 227 * 1024


def _check(x: torch.Tensor, heads: int):
    if x.dim() != 3:
        raise ValueError(f"x must be [G, N, C]; got {tuple(x.shape)}")
    G, N, C = x.shape
    if heads <= 0 or C % heads:
        raise ValueError(f"C={C} must be divisible by heads={heads}")
    return G, N, C


def attn_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                          heads: int, eps: float = 1e-5,
                          apply_ln: bool = True):
    """Plain PyTorch version: x [G, N, C] -> [G, N, C]."""
    _check(x, heads)
    dt = x.dtype
    xn = layernorm_fp32(x, ln_scale, ln_bias, eps) if apply_ln else x
    qkv = (xn.float() @ wqkv.float() + bqkv.float()).to(dt)
    out = grid_mhsa_reference(qkv, heads, round_probs=True)
    return (out.float() @ wproj.float() + bproj.float()).to(dt)


def attn_branch_backward_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                   bproj, dy, heads: int, eps: float = 1e-5,
                                   apply_ln: bool = True):
    """Plain PyTorch version of the backward, written out (not autograd),
    with the rounding points of the Pallas ``_rows_bwd``: ``dout =
    round(dy.wproj^T)``; recomputed fp32 probabilities ``a``; ``dv`` from
    ``a``, but the ``out`` that feeds ``dwproj`` from the rounded ``a``;
    ``ds = a * (dp - sum_m dp*a)``; dq and dk scaled in fp32; ``dwqkv`` and
    ``dxn`` from the rounded dqkv, ``dbqkv`` from the unrounded one; the LN
    backward in fp32 from xhat and rstd. Parameter grads are summed in fp32
    over all tokens and returned in their input's dtype. Returns
    ``(dx, dln_scale, dln_bias, dwqkv, dbqkv, dwproj, dbproj)``."""
    G, N, C = _check(x, heads)
    dt = x.dtype
    hd = C // heads
    scale = hd**-0.5
    x32 = x.reshape(-1, C).float()
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
    qkv = (xn32 @ wqkv.float() + bqkv.float()).to(dt).float()
    dy32 = dy.reshape(-1, C).float()
    dout = (dy32 @ wproj.float().t()).to(dt).float()

    q, k, v = qkv.reshape(G, N, 3, heads, hd).unbind(2)
    g = dout.reshape(G, N, heads, hd)
    logits = torch.einsum("gnhd,gmhd->ghnm", q, k) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    a = e / e.sum(-1, keepdim=True)
    out = torch.einsum("ghnm,gmhd->gnhd", a.to(dt).float(), v)
    out = out.to(dt).float().reshape(-1, C)
    dv = torch.einsum("ghnm,gnhd->gmhd", a, g)
    dp = torch.einsum("gnhd,gmhd->ghnm", g, v)
    ds = a * (dp - (dp * a).sum(-1, keepdim=True))
    dq = torch.einsum("ghnm,gmhd->gnhd", ds, k) * scale
    dk = torch.einsum("ghnm,gnhd->gmhd", ds, q) * scale
    dqkv = torch.stack([dq, dk, dv], 2).reshape(-1, 3 * C)
    dqkvb = dqkv.to(dt).float()

    dwproj = out.t() @ dy32
    dbproj = dy32.sum(0)
    dwqkv = xn32.t() @ dqkvb
    dbqkv = dqkv.sum(0)
    dxn = dqkvb @ wqkv.float().t()
    if apply_ln:
        dls = (dxn * xhat).sum(0)
        dlb = dxn.sum(0)
        dxhat = dxn * ln_scale.float()
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    else:
        dls = dlb = torch.zeros(C, dtype=torch.float32, device=x.device)
        dx = dxn
    return (dx.to(dt).reshape(G, N, C), dls.to(ln_scale.dtype),
            dlb.to(ln_bias.dtype), dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dbproj.to(bproj.dtype))


def smem_bytes(N: int, C: int, heads: int, backward: bool) -> int:
    """Dynamic shared memory of one block: fp32 rows padded by one float
    (``fwd_smem_floats`` / ``bwd_smem_floats`` of csrc/attn_branch.cu)."""
    hd = C // heads
    if backward:
        floats = N * (5 * (C + 1) + (3 * C + 1) + 2 * (N + 1) + (hd + 1) + 1)
    else:
        floats = N * (C + 1) + N * (3 * C + 1) + N * (N + 1)
    return 4 * floats


def attn_branch_fits(N: int, C: int, heads: int) -> bool:
    """Whether the fused branch's kernels take grids of N tokens, C channels
    and ``heads`` heads: the forward's and the backward's blocks both within
    shared memory. The counterpart of ``outgridvit_tpu/ops/
    attn_branch_pallas.py:attn_branch_feasible``, which probes the forward
    and the backward together; a shape only, never the device, so that the
    plain path and the card, a forward and a train step, route alike."""
    return all(smem_bytes(N, C, heads, bwd) <= _MAX_SMEM
               for bwd in (False, True))


def _check_launch(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                  heads, backward, shape=None):
    """Validate what the kernels take; returns (G, N, C), of the tokens x
    or, for an NHWC x, of its windows ``shape``."""
    G, N, C = shape or _check(x, heads)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    want = {"wqkv": (wqkv, (C, 3 * C), x.dtype),
            "bqkv": (bqkv, (3 * C,), x.dtype),
            "wproj": (wproj, (C, C), x.dtype),
            "bproj": (bproj, (C,), x.dtype),
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
    if heads <= 0 or C % heads:
        raise ValueError(f"{name}: C={C} must be divisible by heads={heads}")
    if smem_bytes(N, C, heads, backward) > _MAX_SMEM:
        raise ValueError(f"{name}: a grid of N={N}, C={C}, heads={heads} "
                         "exceeds shared memory")
    return G, N, C


def attn_branch(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads: int,
                eps: float = 1e-5, apply_ln: bool = True):
    """x [G, N, C] -> [G, N, C]. A CUDA tensor launches a kernel (or
    raises): ``csrc/attn_branch_mma.cu`` where :func:`forward_entry` says so
    (bf16 at the shapes it is instantiated at; x, wqkv and wproj 16-byte
    aligned or a ValueError), else ``csrc/attn_branch.cu``; a CPU tensor
    takes :func:`attn_branch_reference`. Under tracing it is the op
    ``ogvt::attn_branch`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("attn_branch")(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, eps,
            apply_ln)
    if x.device.type == "cpu":
        return attn_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                     bproj, heads, eps, apply_ln)
    return _launch_forward(None, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                           bproj, heads, eps, apply_ln)


def _forward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                  bproj, G, N, C, heads, shape_args, eps, apply_ln):
    """Launch the forward entry ``entry`` (a tokens or an NHWC one) for G
    grids; ``shape_args``: the entry's shape arguments (G, N, C, heads, or
    B, H, W, C, g, heads). Returns y."""
    mma = entry.endswith("_mma")
    if mma:
        plan = attn_branch_forward_plan(G, N, C, heads, x.dtype)
        check_aligned16(name, x=x, wqkv=wqkv, wproj=wproj)
    y = torch.empty_like(x)
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), y.data_ptr(), *shape_args,
            ctypes.c_float((C // heads) ** -0.5), float(eps),
            int(bool(apply_ln)), kernel_build.DTYPE_CODES[x.dtype],
            *(plan.args() if mma else ()),
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    return y


def _launch_forward(entry: Optional[str], x, ln_scale, ln_bias, wqkv, bqkv,
                    wproj, bproj, heads: int, eps: float = 1e-5,
                    apply_ln: bool = True):
    """:func:`attn_branch` on the card through the C entry point ``entry``
    (one of :data:`FORWARD_ENTRIES`), or :func:`forward_entry`'s where it is
    None. A named entry is for comparing the two kernels on the same inputs
    (``chip_smoke.py``'s A/B, the card tests)."""
    name = "attn_branch"
    G, N, C = _check_launch(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                            bproj, heads, False)
    if entry is None:
        entry = forward_entry(G, N, C, heads, x.dtype)
    elif entry not in FORWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{FORWARD_ENTRIES}")
    y = _forward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                      bproj, G, N, C, heads, (G, N, C, heads), eps, apply_ln)
    kernel_build.count_launch(attn_branch, None, entry)
    return y


attn_branch.launches = 0
attn_branch.by_entry = Counter()


# ---- the tensor-core kernels' launch plans (csrc/attn_branch_mma.cu,
# csrc/attn_branch_bwd_mma.cu)

# the layout queries of csrc/attn_branch_mma_layout.cpp
_LAYOUTS = {"forward": "ogvt_attn_branch_mma_fwd_layout",
            "tokens": "ogvt_attn_branch_bwd_mma_tokens_layout",
            "weights": "ogvt_attn_branch_bwd_mma_weights_layout"}
_BUILT = ("the kernels are built for grids of 64 tokens at C = 64 with "
          "heads of 32 and C = 80 with heads of 40")


def _layout(kind: str, *args: int) -> Optional[tuple]:
    """The kernels' own answer (``csrc/attn_branch_mma_layout.cpp``) for
    one layout: ``kind`` "forward", "tokens" or "weights" at (N, C, heads)
    gives (threads, shared bytes, register cap); None where the kernel does
    not take it."""
    out = (ctypes.c_int * 3)()
    fn = getattr(kernel_build.load_layouts(), _LAYOUTS[kind])
    return None if fn(*args, out) else tuple(out)


class AttnFwdPlan(NamedTuple):
    """How ``ogvt_attn_branch[_nhwc]_mma`` cuts one call of G grids:
    ``blocks`` blocks of ``smem`` shared bytes, each a contiguous run of
    ``grids`` grids (the last may run short), at most ``blocks_per_sm`` an
    SM at the register cap ``regs``. The blocks depend on G alone."""
    blocks: int
    grids: int
    smem: int
    regs: int
    blocks_per_sm: int

    def args(self):
        """The plan's arguments of ``ogvt_attn_branch[_nhwc]_mma``, in
        order."""
        return (self.blocks, self.grids, self.smem)


class AttnBwdPlan(NamedTuple):
    """How ``ogvt_attn_branch[_nhwc]_bwd_mma`` cuts one call of G grids.
    Tokens kernel: ``t_blocks`` blocks of ``t_smem`` shared bytes, each a
    contiguous run of ``t_grids`` grids (the last may run short), at most
    ``t_blocks_per_sm`` an SM at the register cap ``t_regs``. Weights
    kernel: ``w_splits`` blocks, each a contiguous run of ``w_grids``
    grids, ``w_smem`` shared bytes, ``w_blocks_per_sm`` an SM at
    ``w_regs``. The blocks depend on G alone, so #5 and #12 split the grids
    alike."""
    t_blocks: int
    t_grids: int
    t_smem: int
    t_regs: int
    t_blocks_per_sm: int
    w_splits: int
    w_grids: int
    w_smem: int
    w_regs: int
    w_blocks_per_sm: int

    def args(self):
        """The plan's arguments of ``ogvt_attn_branch[_nhwc]_bwd_mma``, in
        order."""
        return (self.t_blocks, self.t_grids, self.t_smem, self.w_splits,
                self.w_grids, self.w_smem)


def _runs(G: int, slots: int):
    """(blocks, grids a block) for G grids over ``slots`` resident blocks:
    about one wave, each block a contiguous run of grids, none empty."""
    per = -(-G // slots)
    return -(-G // per), per


@lru_cache(maxsize=None)
def _fit_forward(G: int, N: int, C: int, heads: int):
    """The forward's plan for G bf16 grids of N tokens, C channels and
    ``heads`` heads, or why there is none (a str): the kernel's layout
    (:func:`_layout`) decides the shape; one wave of blocks."""
    if G < 1:
        return "G >= 1 grids"
    got = _layout("forward", N, C, heads)
    if got is None:
        return _BUILT
    threads, smem, regs = got
    per_sm = sm_blocks(threads, smem, regs)
    blocks, grids = _runs(G, SMS * per_sm)
    return AttnFwdPlan(blocks, grids, smem, regs, per_sm)


def attn_branch_forward_plan(G: int, N: int, C: int, heads: int,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> AttnFwdPlan:
    """The tensor-core forward's launch plan for G grids of N tokens, C
    channels and ``heads`` heads, or a ValueError naming the shape it does
    not take: fp32 (the FMA kernel's), and any shape the kernel is not
    built for, as its own layout query says (:func:`_layout`). Cached: the
    wrapper asks at every launch."""
    where = (f"attn_branch (mma): G={G}, N={N}, C={C}, heads={heads}, "
             f"{dtype}")
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    plan = _fit_forward(G, N, C, heads)
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


def forward_entry(G: int, N: int, C: int, heads: int,
                  dtype: torch.dtype) -> str:
    """The C entry point a forward launch of these shapes takes on tokens
    (the NHWC wrapper's names add ``_nhwc``): ``ogvt_attn_branch_mma`` where
    :func:`attn_branch_forward_plan` takes the shape, else the FMA kernel's
    ``ogvt_attn_branch``. Decided by dtype and shape alone, and never
    raises."""
    if (dtype == torch.bfloat16
            and not isinstance(_fit_forward(G, N, C, heads), str)):
        return "ogvt_attn_branch_mma"
    return "ogvt_attn_branch"


FORWARD_ENTRIES = ("ogvt_attn_branch_mma", "ogvt_attn_branch")
NHWC_FORWARD_ENTRIES = ("ogvt_attn_branch_nhwc_mma", "ogvt_attn_branch_nhwc")


@lru_cache(maxsize=None)
def _fit_backward(G: int, N: int, C: int, heads: int):
    """The plan for G bf16 grids of N tokens, C channels and ``heads``
    heads, or why there is none (a str): the kernels' layouts
    (:func:`_layout`) decide the shapes; both kernels take one wave of
    blocks."""
    if G < 1:
        return "G >= 1 grids"
    tok = _layout("tokens", N, C, heads)
    got = _layout("weights", N, C, heads)
    if tok is None or got is None:
        return _BUILT
    threads, t_smem, t_regs = tok
    t_per_sm = sm_blocks(threads, t_smem, t_regs)
    t_blocks, t_grids = _runs(G, SMS * t_per_sm)
    threads, w_smem, w_regs = got
    w_per_sm = sm_blocks(threads, w_smem, w_regs)
    w_splits, w_grids = _runs(G, SMS * w_per_sm)
    return AttnBwdPlan(t_blocks, t_grids, t_smem, t_regs, t_per_sm,
                       w_splits, w_grids, w_smem, w_regs, w_per_sm)


def attn_branch_backward_plan(G: int, N: int, C: int, heads: int,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> AttnBwdPlan:
    """The tensor-core backward's launch plan for G grids of N tokens, C
    channels and ``heads`` heads, or a ValueError naming the shape it does
    not take: fp32 (the FMA kernel's), and any shape the kernels are not
    built for, as their own layout queries say (:func:`_layout`).
    Cached: the wrapper asks at every launch."""
    where = (f"attn_branch_backward (mma): G={G}, N={N}, C={C}, "
             f"heads={heads}, {dtype}")
    if dtype != torch.bfloat16:
        raise ValueError(f"{where}: the tensor-core kernel takes bf16 only")
    plan = _fit_backward(G, N, C, heads)
    if isinstance(plan, str):
        raise ValueError(f"{where}: {plan}")
    return plan


def backward_entry(G: int, N: int, C: int, heads: int,
                   dtype: torch.dtype) -> str:
    """The C entry point a backward launch of these shapes takes on tokens
    (the NHWC wrapper's names add ``_nhwc``): ``ogvt_attn_branch_bwd_mma``
    where :func:`attn_branch_backward_plan` takes the shape, else the FMA
    kernel's ``ogvt_attn_branch_bwd``. Decided by dtype and shape alone,
    and never raises."""
    if (dtype == torch.bfloat16
            and not isinstance(_fit_backward(G, N, C, heads), str)):
        return "ogvt_attn_branch_bwd_mma"
    return "ogvt_attn_branch_bwd"


BACKWARD_ENTRIES = ("ogvt_attn_branch_bwd_mma", "ogvt_attn_branch_bwd")
NHWC_BACKWARD_ENTRIES = ("ogvt_attn_branch_nhwc_bwd_mma",
                         "ogvt_attn_branch_nhwc_bwd")


def _nhwc_entry(entry: str) -> str:
    """The NHWC wrapper's C entry point for a tokens one."""
    return entry.replace("ogvt_attn_branch", "ogvt_attn_branch_nhwc", 1)


def _backward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                   bproj, dy, G, N, C, heads, shape_args, eps, apply_ln):
    """Launch the backward entry ``entry`` (a tokens or an NHWC one) for G
    grids; ``shape_args``: the entry's shape arguments (G, N, C, heads, or
    B, H, W, C, g, heads). Returns the grads."""
    mma = entry.endswith("_mma")
    plan = attn_branch_backward_plan(G, N, C, heads, x.dtype) if mma else None
    if mma:
        check_aligned16(name, x=x, wqkv=wqkv, wproj=wproj, dy=dy)
    lib = kernel_build.load()
    n_ws = (lib.ogvt_attn_branch_bwd_workspace(G, C) if plan is None
            else lib.ogvt_attn_branch_bwd_mma_workspace(G, C, plan.t_blocks,
                                                        plan.w_splits))
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    grads = (torch.empty_like(x), torch.empty_like(ln_scale),
             torch.empty_like(ln_bias), torch.empty_like(wqkv),
             torch.empty_like(bqkv), torch.empty_like(wproj),
             torch.empty_like(bproj))
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), *shape_args,
            ctypes.c_float((C // heads) ** -0.5), float(eps),
            int(bool(apply_ln)), kernel_build.DTYPE_CODES[x.dtype],
            *(plan.args() if mma else ()),
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, f"{name} launch ({entry})")
    return grads


def attn_branch_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, dy,
                         heads: int, eps: float = 1e-5,
                         apply_ln: bool = True):
    """Gradients ``(dx, dln_scale, dln_bias, dwqkv, dbqkv, dwproj,
    dbproj)`` of the branch for the output gradient ``dy``. A CUDA tensor
    launches the kernels (or raises): ``csrc/attn_branch_bwd_mma.cu`` where
    :func:`backward_entry` says so (bf16 at the shapes it is instantiated
    at; x, wqkv, wproj and dy 16-byte aligned or a ValueError), else
    ``csrc/attn_branch.cu``; a CPU tensor takes
    :func:`attn_branch_backward_reference`. Deterministic: two calls on the
    same inputs give bitwise-equal grads."""
    if x.device.type == "cpu":
        return attn_branch_backward_reference(x, ln_scale, ln_bias, wqkv,
                                              bqkv, wproj, bproj, dy, heads,
                                              eps, apply_ln)
    return _launch_backward(None, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                            bproj, dy, heads, eps, apply_ln)


def _launch_backward(entry: Optional[str], x, ln_scale, ln_bias, wqkv, bqkv,
                     wproj, bproj, dy, heads: int, eps: float = 1e-5,
                     apply_ln: bool = True):
    """:func:`attn_branch_backward` on the card through the C entry point
    ``entry`` (one of :data:`BACKWARD_ENTRIES`), or
    :func:`backward_entry`'s where it is None. A named entry is for
    comparing the two kernels on the same inputs (``chip_smoke.py``'s A/B,
    the card tests)."""
    name = "attn_branch_backward"
    G, N, C = _check_launch(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                            bproj, heads, True)
    _check_dy(name, x, dy)
    if entry is None:
        entry = backward_entry(G, N, C, heads, x.dtype)
    elif entry not in BACKWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{BACKWARD_ENTRIES}")
    grads = _backward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv,
                           wproj, bproj, dy, G, N, C, heads,
                           (G, N, C, heads), eps, apply_ln)
    kernel_build.count_launch(attn_branch_backward, None, entry)
    return grads


attn_branch_backward.launches = 0
attn_branch_backward.by_entry = Counter()


def _check_dy(name, x, dy):
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(
            f"{name}: dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}; "
            f"expected contiguous {tuple(x.shape)} {x.dtype} on {x.device}")


class _AttnBranch(torch.autograd.Function):
    """Recompute style, as ``_branch_fwd``/``_branch_bwd``: saves only the
    inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads,
                eps, apply_ln, use_kernels):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
        ctx.cfg = (heads, eps, apply_ln, use_kernels)
        fn = attn_branch if use_kernels else attn_branch_reference
        return fn(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, eps,
                  apply_ln)

    @staticmethod
    def backward(ctx, dy):
        heads, eps, apply_ln, use_kernels = ctx.cfg
        fn = (attn_branch_backward if use_kernels
              else attn_branch_backward_reference)
        grads = fn(*ctx.saved_tensors, dy.contiguous(), heads, eps, apply_ln)
        return (*grads, None, None, None, None)


def attn_branch_autograd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                         heads: int, eps: float = 1e-5, apply_ln: bool = True,
                         use_kernels: bool = False):
    """Differentiable fused branch: the kernels (:func:`attn_branch`,
    :func:`attn_branch_backward`) with ``use_kernels``, else the plain
    versions, both ways."""
    return _AttnBranch.apply(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                             heads, eps, apply_ln, use_kernels)


# ---- #12: the same branch on an NHWC map ---------------------------------

def _windows(x: torch.Tensor, heads: int, grid_size: int):
    """(G, N, C) of the grid windows of x [B, H, W, C]."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C]; got {tuple(x.shape)}")
    B, H, W, C = x.shape
    g = grid_size
    if g <= 0 or H % g or W % g:
        raise ValueError(
            f"H and W must be divisible by grid_size; got {H}x{W}, g={g}")
    if heads <= 0 or C % heads:
        raise ValueError(f"C={C} must be divisible by heads={heads}")
    return B * g * g, (H // g) * (W // g), C


def _tokens(x: torch.Tensor, grid_size: int):
    grids, meta = grid_partition(x, grid_size)
    G, Hg, Wg, C = grids.shape
    return grids.reshape(G, Hg * Wg, C), meta


def _untokens(t: torch.Tensor, meta):
    B, H, W, C, g = meta
    return grid_unpartition(t.reshape(B * g * g, H // g, W // g, C), meta)


def attn_branch_nhwc_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                               bproj, heads: int, grid_size: int,
                               eps: float = 1e-5, apply_ln: bool = True):
    """Plain PyTorch version of #12: x [B, H, W, C] -> [B, H, W, C],
    partition -> :func:`attn_branch_reference` -> unpartition."""
    _windows(x, heads, grid_size)
    tokens, meta = _tokens(x, grid_size)
    return _untokens(attn_branch_reference(
        tokens, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, eps,
        apply_ln), meta)


def attn_branch_nhwc_backward_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, dy, heads: int,
                                        grid_size: int, eps: float = 1e-5,
                                        apply_ln: bool = True):
    """Plain PyTorch version of #12's backward: x and dy partitioned,
    :func:`attn_branch_backward_reference`, dx unpartitioned. Returns
    ``(dx, dln_scale, dln_bias, dwqkv, dbqkv, dwproj, dbproj)``."""
    _windows(x, heads, grid_size)
    tokens, meta = _tokens(x, grid_size)
    dx, *grads = attn_branch_backward_reference(
        tokens, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
        _tokens(dy, grid_size)[0], heads, eps, apply_ln)
    return (_untokens(dx, meta), *grads)


def attn_branch_nhwc(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                     heads: int, grid_size: int, eps: float = 1e-5,
                     apply_ln: bool = True):
    """#12's forward, x [B, H, W, C] -> [B, H, W, C]. A CUDA tensor launches
    a kernel (or raises): ``csrc/attn_branch_mma.cu`` where
    :func:`forward_entry` says so for the windows, else
    ``csrc/attn_branch.cu``; a CPU tensor takes
    :func:`attn_branch_nhwc_reference`. y is :func:`attn_branch`'s on the
    partitioned tokens, bit for bit. Under tracing it is the op
    ``ogvt::attn_branch_nhwc`` (``ops/library.py``)."""
    if kernel_build.tracing():
        return kernel_build.traced_op("attn_branch_nhwc")(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, grid_size,
            eps, apply_ln)
    if x.device.type == "cpu":
        return attn_branch_nhwc_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                          wproj, bproj, heads, grid_size, eps,
                                          apply_ln)
    return _launch_nhwc_forward(None, x, ln_scale, ln_bias, wqkv, bqkv,
                                wproj, bproj, heads, grid_size, eps, apply_ln)


def _launch_nhwc_forward(entry: Optional[str], x, ln_scale, ln_bias, wqkv,
                         bqkv, wproj, bproj, heads: int, grid_size: int,
                         eps: float = 1e-5, apply_ln: bool = True):
    """:func:`attn_branch_nhwc` on the card through the C entry point
    ``entry`` (one of :data:`NHWC_FORWARD_ENTRIES`), or
    :func:`forward_entry`'s for the windows where it is None, as
    :func:`_launch_forward`."""
    name = "attn_branch_nhwc"
    shape = _windows(x, heads, grid_size)
    G, N, C = _check_launch(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                            bproj, heads, False, shape)
    if entry is None:
        entry = _nhwc_entry(forward_entry(G, N, C, heads, x.dtype))
    elif entry not in NHWC_FORWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{NHWC_FORWARD_ENTRIES}")
    B, H, W, _ = x.shape
    y = _forward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                      bproj, G, N, C, heads, (B, H, W, C, grid_size, heads),
                      eps, apply_ln)
    kernel_build.count_launch(attn_branch_nhwc, None, entry)
    return y


attn_branch_nhwc.launches = 0
attn_branch_nhwc.by_entry = Counter()


def attn_branch_nhwc_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              dy, heads: int, grid_size: int,
                              eps: float = 1e-5, apply_ln: bool = True):
    """#12's gradients ``(dx, dln_scale, dln_bias, dwqkv, dbqkv, dwproj,
    dbproj)`` for dy [B, H, W, C]. A CUDA tensor launches the kernels (or
    raises); a CPU tensor takes :func:`attn_branch_nhwc_backward_reference`.
    The windows are walked in partition order, so the parameter grads equal
    :func:`attn_branch_backward`'s on the partitioned tokens, bit for
    bit."""
    if x.device.type == "cpu":
        return attn_branch_nhwc_backward_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, dy, heads,
            grid_size, eps, apply_ln)
    return _launch_nhwc_backward(None, x, ln_scale, ln_bias, wqkv, bqkv,
                                 wproj, bproj, dy, heads, grid_size, eps,
                                 apply_ln)


def _launch_nhwc_backward(entry: Optional[str], x, ln_scale, ln_bias, wqkv,
                          bqkv, wproj, bproj, dy, heads: int, grid_size: int,
                          eps: float = 1e-5, apply_ln: bool = True):
    """:func:`attn_branch_nhwc_backward` on the card through the C entry
    point ``entry`` (one of :data:`NHWC_BACKWARD_ENTRIES`), or
    :func:`backward_entry`'s for the windows where it is None, as
    :func:`_launch_backward`."""
    name = "attn_branch_nhwc_backward"
    shape = _windows(x, heads, grid_size)
    G, N, C = _check_launch(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                            bproj, heads, True, shape)
    _check_dy(name, x, dy)
    if entry is None:
        entry = _nhwc_entry(backward_entry(G, N, C, heads, x.dtype))
    elif entry not in NHWC_BACKWARD_ENTRIES:
        raise ValueError(f"{name}: entry {entry!r} is not one of "
                         f"{NHWC_BACKWARD_ENTRIES}")
    B, H, W, _ = x.shape
    grads = _backward_call(name, entry, x, ln_scale, ln_bias, wqkv, bqkv,
                           wproj, bproj, dy, G, N, C, heads,
                           (B, H, W, C, grid_size, heads), eps, apply_ln)
    kernel_build.count_launch(attn_branch_nhwc_backward, None, entry)
    return grads


attn_branch_nhwc_backward.launches = 0
attn_branch_nhwc_backward.by_entry = Counter()


class _AttnBranchNHWC(torch.autograd.Function):
    """#12, recompute style as ``_nhwc_fwd``/``_nhwc_bwd``: saves only the
    inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads,
                grid_size, eps, apply_ln, use_kernels):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj)
        ctx.cfg = (heads, grid_size, eps, apply_ln, use_kernels)
        fn = attn_branch_nhwc if use_kernels else attn_branch_nhwc_reference
        return fn(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads,
                  grid_size, eps, apply_ln)

    @staticmethod
    def backward(ctx, dy):
        heads, grid_size, eps, apply_ln, use_kernels = ctx.cfg
        fn = (attn_branch_nhwc_backward if use_kernels
              else attn_branch_nhwc_backward_reference)
        grads = fn(*ctx.saved_tensors, dy.contiguous(), heads, grid_size, eps,
                   apply_ln)
        return (*grads, None, None, None, None, None)


def attn_branch_nhwc_autograd(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              heads: int, grid_size: int, eps: float = 1e-5,
                              apply_ln: bool = True,
                              use_kernels: bool = False):
    """Differentiable #12 branch on x [B, H, W, C]: the kernels
    (:func:`attn_branch_nhwc`, :func:`attn_branch_nhwc_backward`) with
    ``use_kernels``, else their plain versions, both ways."""
    return _AttnBranchNHWC.apply(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                 bproj, heads, grid_size, eps, apply_ln,
                                 use_kernels)
