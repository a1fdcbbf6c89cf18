"""Fused pre-LN channel-MLP branch: the CUDA kernels ``csrc/mlp_branch.cu``
(forward) and ``csrc/mlp_branch_bwd.cu`` (backward) and their plain PyTorch
versions. One kernel pair stands for two TPU kernels that compute the same
math and rounding points in different VMEM layouts:
``outgridvit_tpu/ops/mlp_branch_pallas_t.py:mlp_branch_pallas_t`` (#2,
variant ``"t"``) and the row-layout
``outgridvit_tpu/ops/mlp_branch_pallas.py:mlp_branch_pallas`` (#4, variant
``"row"``). The variant only tags the launch count (``mlp_branch.by_variant``).

``y = fc2(act(fc1(LN(x))))`` per token with the kernel's rounding points:
LN with fp32 statistics cast to x.dtype; ``xn.w1`` summed in fp32, ``+ b1``,
cast; ``act`` in fp32, cast; ``a.w2`` summed in fp32, ``+ b2``, cast.
Weights are in the JAX layout: w1 [C, H], w2 [H, C]. The backward is
:func:`mlp_branch_backward_reference`'s math; :func:`mlp_branch_autograd`
is the differentiable branch the model calls (a ``torch.autograd.Function``
that saves only its inputs).
"""

from __future__ import annotations

from collections import Counter

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.activations import (
    activation_grad,
    make_activation,
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


def mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2, act: str,
               eps: float = 1e-5, apply_ln: bool = True, variant: str = "t"):
    """x [..., C] -> [..., C]. A CUDA tensor launches the kernel (or raises);
    a CPU tensor takes :func:`mlp_branch_reference`. ``variant`` names the
    JAX kernel the launch stands for (:data:`VARIANTS`)."""
    if x.device.type == "cpu":
        return mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                                    eps, apply_ln)
    M, C, H, code = _check_launch("mlp_branch", x, ln_scale, ln_bias, w1, b1,
                                  w2, b2, act, variant)
    y = torch.empty_like(x)
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        err = lib.ogvt_mlp_branch(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), M, C, H, code, float(eps),
            int(bool(apply_ln)), kernel_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "mlp_branch launch")
    kernel_build.count_launch(mlp_branch, variant)
    return y


mlp_branch.launches = 0
mlp_branch.by_variant = Counter()


def mlp_branch_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, dy, act: str,
                        eps: float = 1e-5, apply_ln: bool = True,
                        variant: str = "t"):
    """Gradients ``(dx, dln_scale, dln_bias, dw1, db1, dw2, db2)`` of the
    branch for the output gradient ``dy``. A CUDA tensor launches the kernels
    (or raises); a CPU tensor takes :func:`mlp_branch_backward_reference`.
    Deterministic: two calls on the same inputs give bitwise-equal grads.
    ``variant`` as in :func:`mlp_branch`."""
    if x.device.type == "cpu":
        return mlp_branch_backward_reference(x, ln_scale, ln_bias, w1, b1, w2,
                                             b2, dy, act, eps, apply_ln)
    M, C, H, code = _check_launch("mlp_branch_backward", x, ln_scale, ln_bias,
                                  w1, b1, w2, b2, act, variant)
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(
            f"mlp_branch_backward: dy is {tuple(dy.shape)} {dy.dtype} on "
            f"{dy.device}; expected contiguous {tuple(x.shape)} {x.dtype} "
            f"on {x.device}")
    lib = kernel_build.load()
    ws = torch.empty(lib.ogvt_mlp_branch_bwd_workspace(M, C, H),
                     dtype=torch.float32, device=x.device)
    grads = (torch.empty_like(x), torch.empty_like(ln_scale),
             torch.empty_like(ln_bias), torch.empty_like(w1),
             torch.empty_like(b1), torch.empty_like(w2), torch.empty_like(b2))
    with torch.cuda.device(x.device):
        err = lib.ogvt_mlp_branch_bwd(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), M, C, H, code,
            float(eps), int(bool(apply_ln)),
            kernel_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "mlp_branch_backward launch")
    kernel_build.count_launch(mlp_branch_backward, variant)
    return grads


mlp_branch_backward.launches = 0
mlp_branch_backward.by_variant = Counter()


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
