"""Fused outlook attention, stride 1, any odd K: the softmax over each
head's K*K tap logits fused with the taps. The CUDA kernel
``csrc/outlook_softmax.cu`` (forward) and its plain PyTorch version; twin of
``outgridvit_tpu/ops/experimental/outlook_pallas.py:outlook_attention_pallas``
(TPU kernel #9, ``model.use_pallas: fused_outlook``).

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

import torch

from outgridvit_tpu_torch.ops import kernel_build
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


# ---- the CUDA kernel ------------------------------------------------------

_MAX_SMEM = 227 * 1024
_PIX = 32  # pixels per block (kPix in csrc/outlook_softmax.cu)


def outlook_softmax_agg(v, logits, heads: int, k: int = 3):
    """#9 forward, [B, H, W, C] -> [B, H, W, C]. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes
    :func:`outlook_softmax_agg_reference`."""
    if v.device.type == "cpu":
        return outlook_softmax_agg_reference(v, logits, heads, k)
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
    if 4 * _PIX * heads * k * k > _MAX_SMEM:
        raise ValueError(f"{name}: {heads} heads of {k}x{k} taps exceed "
                         "shared memory")
    B, H, W, C = v.shape
    out = torch.empty_like(v)
    lib = kernel_build.load()
    with torch.cuda.device(v.device):
        err = lib.ogvt_outlook_softmax(
            v.data_ptr(), logits.data_ptr(), out.data_ptr(), B, H, W, C,
            heads, k, kernel_build.DTYPE_CODES[v.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, f"{name} launch")
    outlook_softmax_agg.launches += 1
    return out


outlook_softmax_agg.launches = 0


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
