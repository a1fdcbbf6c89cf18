"""Fused pre-LN channel-MLP branch: the CUDA kernel ``csrc/mlp_branch.cu``
and its plain PyTorch version (twin of ``outgridvit_tpu/ops/
mlp_branch_pallas_t.py:mlp_branch_pallas_t``, forward).

``y = fc2(act(fc1(LN(x))))`` per token with the kernel's rounding points:
LN with fp32 statistics cast to x.dtype; ``xn.w1`` summed in fp32, ``+ b1``,
cast; ``act`` in fp32, cast; ``a.w2`` summed in fp32, ``+ b2``, cast.
Weights are in the JAX layout: w1 [C, H], w2 [H, C].
"""

from __future__ import annotations

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.activations import make_activation

_ACT_CODES = {"gelu": 0, "silu": 1, "relu": 2}  # enum Act in the .cu
_MAX_C = 4096


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


def mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2, act: str,
               eps: float = 1e-5, apply_ln: bool = True):
    """x [..., C] -> [..., C]. A CUDA tensor launches the kernel (or raises);
    a CPU tensor takes :func:`mlp_branch_reference`."""
    if x.device.type == "cpu":
        return mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                                    eps, apply_ln)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_branch: unsupported device {x.device}")
    if x.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"mlp_branch: dtype {x.dtype} is not float32/bfloat16")
    act = act.lower()
    if act not in _ACT_CODES:
        raise ValueError(f"mlp_branch: unknown activation '{act}'")
    C = x.shape[-1]
    H = w1.shape[-1] if w1.dim() == 2 else -1
    want = {"w1": (w1, (C, H), x.dtype), "b1": (b1, (H,), x.dtype),
            "w2": (w2, (H, C), x.dtype), "b2": (b2, (C,), x.dtype),
            "ln_scale": (ln_scale, (C,), torch.float32),
            "ln_bias": (ln_bias, (C,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"mlp_branch: {name} is {tuple(t.shape)} {t.dtype}; "
                f"expected {shape} {dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"mlp_branch: {name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("mlp_branch: x must be contiguous")
    if not 1 <= C <= _MAX_C:
        raise ValueError(f"mlp_branch: C={C} outside 1..{_MAX_C}")
    M = x.numel() // C
    y = torch.empty_like(x)
    lib = kernel_build.load()
    with torch.cuda.device(x.device):
        err = lib.ogvt_mlp_branch(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), M, C, H, _ACT_CODES[act], float(eps),
            int(bool(apply_ln)), kernel_build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "mlp_branch launch")
    mlp_branch.launches += 1
    return y


mlp_branch.launches = 0
