"""Grid MHSA core for tiny grids: the CUDA kernel ``csrc/grid_mhsa.cu`` and
its plain PyTorch version (twin of ``outgridvit_tpu/ops/
grid_attention_pallas_t.py:grid_mhsa_pallas_t``, forward).

Both compute, per grid and head, ``softmax(q.k^T * hd^-1/2) v`` with the
q.k sum in fp32 scaled after the sum, an fp32 softmax with max subtraction,
and the P.V sum in fp32 cast once (the kernel's rounding points; the JAX
non-kernel path casts the probabilities to the compute dtype before P.V,
the port does not).
"""

from __future__ import annotations

import ctypes

import torch

from outgridvit_tpu_torch.ops import kernel_build

MAX_TOKENS = 16  # the JAX dispatch runs this kernel for N <= 16
_MAX_SMEM = 227 * 1024


def _check(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [G, N, 3C]; got {tuple(qkv.shape)}")
    G, N, C3 = qkv.shape
    if C3 % 3 or heads <= 0 or (C3 // 3) % heads:
        raise ValueError(
            f"qkv last dim {C3} must be 3*C with C divisible by heads={heads}")
    return G, N, C3 // 3


def grid_mhsa_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version: qkv [G, N, 3C] -> [G, N, C]."""
    G, N, C = _check(qkv, heads)
    hd = C // heads
    q, k, v = qkv.float().reshape(G, N, 3, heads, hd).unbind(2)
    logits = torch.einsum("gnhd,gmhd->ghnm", q, k) * hd**-0.5
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    out = torch.einsum("ghnm,gmhd->gnhd", p, v)
    return out.to(qkv.dtype).reshape(G, N, C)


def grid_mhsa(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv [G, N, 3C] -> [G, N, C]. A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes :func:`grid_mhsa_reference`."""
    if qkv.device.type == "cpu":
        return grid_mhsa_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"grid_mhsa: unsupported device {qkv.device}")
    G, N, C = _check(qkv, heads)
    if qkv.dtype not in kernel_build.DTYPE_CODES:
        raise TypeError(f"grid_mhsa: dtype {qkv.dtype} is not float32/bfloat16")
    if not qkv.is_contiguous():
        raise ValueError("grid_mhsa: qkv must be contiguous")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(
            f"grid_mhsa: N={N} tokens per grid; the kernel takes "
            f"1..{MAX_TOKENS}")
    if (N * 3 * C + heads * N * N) * 4 > _MAX_SMEM:
        raise ValueError(f"grid_mhsa: grid of N={N}, C={C} exceeds shared "
                         "memory")
    out = torch.empty((G, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernel_build.load()
    with torch.cuda.device(qkv.device):
        err = lib.ogvt_grid_mhsa(
            qkv.data_ptr(), out.data_ptr(), G, N, C, heads,
            ctypes.c_float((C // heads) ** -0.5),
            kernel_build.DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream().cuda_stream)
    kernel_build.check(err, "grid_mhsa launch")
    grid_mhsa.launches += 1
    return out


grid_mhsa.launches = 0
