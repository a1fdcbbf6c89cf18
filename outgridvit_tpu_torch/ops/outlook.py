"""Outlook-attention aggregation, NHWC, without unfold (twin of
``outgridvit_tpu/ops/outlook.py:outlook_aggregate_xla``).

``y[b, i, j, h, d] = sum_{ky,kx} v_pad[b, i*s+ky, j*s+kx, h, d] *
attn[b, i, j, h, ky*K+kx]`` with zero padding K//2; taps are ky-major and
v's channels split as [heads, hd]. The accumulator has the promoted dtype of
v and attn, as in the JAX function (bf16 when both are bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def outlook_aggregate(v: torch.Tensor, attn: torch.Tensor,
                      kernel_size: int = 3, stride: int = 1) -> torch.Tensor:
    """v [B, H, W, C], attn [B, Hs, Ws, heads, K*K] -> [B, Hs, Ws, C]."""
    if v.dim() != 4:
        raise ValueError(f"v must be [B,H,W,C]; got {tuple(v.shape)}")
    if attn.dim() != 5:
        raise ValueError(
            f"attn must be [B,Hs,Ws,heads,K*K]; got {tuple(attn.shape)}")
    k, s, p = kernel_size, stride, kernel_size // 2
    if k <= 0 or k % 2 == 0:
        raise ValueError("kernel_size must be odd and > 0 (e.g. 3, 5, 7)")
    if s <= 0:
        raise ValueError("stride must be > 0")
    if attn.shape[-1] != k * k:
        raise ValueError(
            f"attn last dim {attn.shape[-1]} != kernel_size^2 {k * k}")
    B, H, W, C = v.shape
    heads = attn.shape[3]
    if C % heads:
        raise ValueError(f"C={C} must be divisible by heads={heads}")
    Hs = (H + 2 * p - k) // s + 1
    Ws = (W + 2 * p - k) // s + 1
    if tuple(attn.shape[1:3]) != (Hs, Ws):
        raise ValueError(
            f"attn spatial {tuple(attn.shape[1:3])} inconsistent with v "
            f"{(H, W)} at stride {s} (expected {(Hs, Ws)})")
    hd = C // heads
    vh = F.pad(v, (0, 0, p, p, p, p)).reshape(B, H + 2 * p, W + 2 * p,
                                             heads, hd)
    acc = torch.zeros((B, Hs, Ws, heads, hd),
                      dtype=torch.promote_types(v.dtype, attn.dtype),
                      device=v.device)
    for ky in range(k):
        for kx in range(k):
            tap = vh[:, ky:ky + (Hs - 1) * s + 1:s, kx:kx + (Ws - 1) * s + 1:s]
            acc = acc + tap * attn[..., ky * k + kx, None]
    return acc.reshape(B, Hs, Ws, C).to(v.dtype)
