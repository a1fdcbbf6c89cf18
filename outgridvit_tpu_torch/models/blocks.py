"""Attention blocks, eval mode, NHWC (twins of ``outgridvit_tpu/models/
blocks.py``): outlook attention, grid MHSA, the outlooker block and the
hybrid OutGrid block. Drop-path and dropout are identity in eval mode and
are not carried.
"""

from __future__ import annotations

import torch
from torch import nn

from outgridvit_tpu_torch.models.layers import (
    ChannelMLP,
    Dense,
    LayerNorm,
    MBConv,
    layernorm_fp32,
)
from outgridvit_tpu_torch.ops.grid import grid_partition, grid_unpartition
from outgridvit_tpu_torch.ops.grid_attention import (
    MAX_TOKENS,
    grid_mhsa,
    grid_mhsa_reference,
)
from outgridvit_tpu_torch.ops.outlook import outlook_aggregate
from outgridvit_tpu_torch.stage_config import MBConvConfig, StageCfg


class OutlookAttention2d(nn.Module):
    """VOLO-style outlook attention, stride 1: a 1x1 projection gives
    heads*K^2 logits per pixel (heads-major), softmaxed in fp32 over the K^2
    taps; values from a 1x1 projection are aggregated by
    :func:`outlook_aggregate`, then projected."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        if kernel_size <= 0 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >0 (e.g., 3,5,7)")
        self.heads, self.k = num_heads, kernel_size
        kk = kernel_size * kernel_size
        self.attn = Dense(dim, num_heads * kk, dtype=dtype, device=device)
        self.v = Dense(dim, dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        B, H, W, _ = x.shape
        a = self.attn(x).reshape(B, H, W, self.heads, self.k * self.k)
        a = torch.softmax(a.float(), dim=-1).to(x.dtype)
        y = outlook_aggregate(self.v(x), a, kernel_size=self.k, stride=1)
        return self.proj(y)


class MultiHeadSelfAttention(nn.Module):
    """Grid MHSA on an NHWC map: partition into grids, pre-LN, qkv
    projection, the attention core, output projection, unpartition.

    The core is :func:`grid_mhsa` with ``use_kernels`` (the CUDA kernel on a
    CUDA tensor) and :func:`grid_mhsa_reference` otherwise. qkv's last axis
    is laid out (3, heads, hd)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 use_kernels: bool = False, device=None):
        super().__init__()
        if dim <= 0 or num_heads <= 0 or dim % num_heads:
            raise ValueError(
                f"dim ({dim}) must be > 0 and divisible by num_heads "
                f"({num_heads})")
        self.heads, self.use_kernels = num_heads, use_kernels
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x, ln: LayerNorm, grid_size: int):
        grids, meta = grid_partition(x, grid_size)
        G, Hg, Wg, C = grids.shape
        N = Hg * Wg
        if self.use_kernels and N > MAX_TOKENS:
            raise NotImplementedError(
                f"grid attention with N={N} > {MAX_TOKENS} tokens needs the "
                "N >= 64 branch kernel or the block-packed kernel, not "
                "ported yet (ROADMAP §2 #5, #6)")
        t = layernorm_fp32(grids.reshape(G, N, C), ln.weight, ln.bias, ln.eps)
        core = grid_mhsa if self.use_kernels else grid_mhsa_reference
        out = self.proj(core(self.qkv(t).contiguous(), self.heads))
        return grid_unpartition(out.reshape(G, Hg, Wg, C), meta)


class GridAttention2D(nn.Module):
    """MaxViT-style dilated grid attention, NHWC in and out. Owns the grid
    size; its ``mhsa`` child keeps the JAX tree's ``grid_attn/mhsa`` path,
    which the weight bridge maps key for key."""

    def __init__(self, dim: int, num_heads: int, grid_size: int,
                 dtype=torch.float32, use_kernels: bool = False, device=None):
        super().__init__()
        self.grid_size = grid_size
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, dtype, use_kernels,
                                           device)

    def forward(self, x, ln: LayerNorm):
        if x.dim() != 4:
            raise ValueError(f"Expected NHWC. Got {tuple(x.shape)}")
        return self.mhsa(x, ln, self.grid_size)


class OutlookerBlock2d(nn.Module):
    """Pre-LN outlooker block: x + attn(LN(x)); x + mlp(LN(x)). LN eps is
    1e-6 here."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 mlp_ratio: float = 2.0, act: str = "gelu",
                 norm_eps: float = 1e-6, dtype=torch.float32,
                 use_kernels: bool = False, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, device)
        self.attn = OutlookAttention2d(dim, num_heads, kernel_size, dtype,
                                       device)
        self.norm2 = LayerNorm(dim, norm_eps, device)
        self.mlp = ChannelMLP(dim, mlp_ratio, act, dtype, use_kernels, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(x, self.norm2)


class OutGridBlock(nn.Module):
    """The hybrid block: outlooker -> MBConv -> grid attention -> MLP, with
    pre-LN residuals. ``outlook_heads == 0``, ``num_heads == 0`` and
    ``use_mbconv=False`` skip their branch. The grid and MLP norms use eps
    1e-5."""

    def __init__(self, cfg: StageCfg, dtype=torch.float32,
                 use_kernels: bool = False, device=None):
        super().__init__()
        C = cfg.dim
        self.outlook = (OutlookerBlock2d(
            C, cfg.outlook_heads, cfg.outlook_kernel, cfg.outlook_mlp_ratio,
            cfg.mlp_act, dtype=dtype, use_kernels=use_kernels, device=device)
            if cfg.outlook_heads > 0 else None)
        self.mbconv = (MBConv(C, C, 1, MBConvConfig(
            expand_ratio=cfg.mbconv_expand_ratio, se_ratio=cfg.mbconv_se_ratio,
            act=cfg.mbconv_act, use_bn=cfg.use_bn), dtype, device)
            if cfg.use_mbconv else None)
        if cfg.num_heads > 0:
            self.norm2 = LayerNorm(C, 1e-5, device)
            self.grid_attn = GridAttention2D(C, cfg.num_heads, cfg.grid_size,
                                             dtype, use_kernels, device)
        else:
            self.norm2 = self.grid_attn = None
        self.norm3 = LayerNorm(C, 1e-5, device)
        self.mlp = ChannelMLP(C, cfg.mlp_ratio, cfg.mlp_act, dtype,
                              use_kernels, device)

    def forward(self, x):
        if self.outlook is not None:
            x = self.outlook(x)
        if self.mbconv is not None:
            x = self.mbconv(x)
        if self.grid_attn is not None:
            x = x + self.grid_attn(x, self.norm2)
        return x + self.mlp(x, self.norm3)
