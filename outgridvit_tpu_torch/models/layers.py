"""Shared NHWC layers, eval mode (twins of ``outgridvit_tpu/models/
layers.py``): LayerNorm, BatchNorm, Dense, the channel MLP, NHWC convs
(stem, depthwise 3x3, downsample), squeeze-excite and MBConv.

Parameters are fp32 in PyTorch's layouts (Linear [out, in], Conv OIHW,
depthwise [C, 1, 3, 3]) and are cast to the module's compute ``dtype`` per
call, as the JAX package casts its fp32 params. Submodule names follow the
reference torch ``state_dict`` keys (``stem.stem.0/1``, ``mbconv.expand.0/1``,
``downs.i.op.0/1``), so ``outgridvit_tpu/utils/port_torch.py`` maps them onto
the JAX tree unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from outgridvit_tpu_torch.ops.activations import make_activation
from outgridvit_tpu_torch.ops.mlp_branch import (
    layernorm_fp32,
    mlp_branch,
    mlp_branch_reference,
)
from outgridvit_tpu_torch.stage_config import DownsampleConfig, MBConvConfig


class LayerNorm(nn.Module):
    """Channel LayerNorm over the last axis with flax numerics
    (:func:`layernorm_fp32`); fp32 ``weight``/``bias``."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layernorm_fp32(x, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm on NHWC: fp32 running statistics and affine, as
    flax ``nn.BatchNorm(dtype=float32)``; output cast back to x.dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(x.dtype)


class Dense(nn.Module):
    """``nn.Dense`` over the last axis: fp32 ``weight`` [out, in] and
    optional ``bias``, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class ConvNHWC(nn.Module):
    """2-D convolution on NHWC activations with an OIHW ``weight``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     stride=self.stride, padding=self.weight.shape[-1] // 2,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


def _conv_bn(conv: nn.Module, dim: int, use_bn: bool, device) -> nn.Sequential:
    return nn.Sequential(conv, BatchNorm(dim, device=device)) if use_bn \
        else nn.Sequential(conv)


class ChannelMLP(nn.Module):
    """Pre-LN channel MLP branch ``fc2(act(fc1(LN(x))))`` over the last axis.

    With ``use_kernels`` it runs :func:`mlp_branch` (the CUDA kernel on a
    CUDA tensor); otherwise :func:`mlp_branch_reference`."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 dtype=torch.float32, use_kernels: bool = False, device=None):
        super().__init__()
        hidden = max(1, int(dim * mlp_ratio))
        self.act = act.lower()
        make_activation(self.act)  # validate the name
        self.dtype, self.use_kernels = dtype, use_kernels
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x, ln: LayerNorm):
        dt = self.dtype
        fn = mlp_branch if self.use_kernels else mlp_branch_reference
        return fn(x.to(dt).contiguous(), ln.weight, ln.bias,
                  self.fc1.weight.to(dt).t().contiguous(), self.fc1.bias.to(dt),
                  self.fc2.weight.to(dt).t().contiguous(), self.fc2.bias.to(dt),
                  self.act, ln.eps, True)


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation gate: fp32 mean cast to x.dtype, fp32
    sigmoid."""

    def __init__(self, channels: int, se_ratio: float = 0.25,
                 act: str = "silu", dtype=torch.float32, device=None):
        super().__init__()
        if not 0.0 < se_ratio <= 1.0:
            raise ValueError("se_ratio must be in (0, 1].")
        hidden = max(1, int(channels * se_ratio))
        self.act = make_activation(act)
        self.fc1 = Dense(channels, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, channels, dtype=dtype, device=device)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = self.fc2(self.act(self.fc1(s)))
        return x * torch.sigmoid(s.float()).to(x.dtype)


class MBConv(nn.Module):
    """Inverted residual: expand 1x1 (skipped if mid == in) -> depthwise 3x3
    -> SE -> project 1x1; residual iff stride 1 and in == out. Expand and
    project carry no bias when ``use_bn``."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 cfg: MBConvConfig = MBConvConfig(), dtype=torch.float32,
                 device=None):
        super().__init__()
        if in_ch <= 0 or out_ch <= 0:
            raise ValueError("in_ch and out_ch must be > 0")
        if stride not in (1, 2):
            raise ValueError("stride must be 1 or 2")
        self.act = make_activation(cfg.act)
        self.residual = stride == 1 and in_ch == out_ch
        bn = cfg.use_bn
        mid = max(1, int(round(in_ch * cfg.expand_ratio)))
        self.expand = (_conv_bn(Dense(in_ch, mid, bias=not bn, dtype=dtype,
                                      device=device), mid, bn, device)
                       if mid != in_ch else None)
        self.depthwise = _conv_bn(
            ConvNHWC(mid, mid, 3, stride, groups=mid, bias=not bn, dtype=dtype,
                     device=device), mid, bn, device)
        self.se = (SqueezeExcite(mid, cfg.se_ratio, cfg.act, dtype, device)
                   if cfg.se_ratio > 0 else None)
        self.project = _conv_bn(Dense(mid, out_ch, bias=not bn, dtype=dtype,
                                      device=device), out_ch, bn, device)

    def forward(self, x):
        out = x
        if self.expand is not None:
            out = self.act(self.expand(out))
        out = self.act(self.depthwise(out))
        if self.se is not None:
            out = self.se(out)
        out = self.project(out)
        return x + out if self.residual else out


class Downsample(nn.Module):
    """Between-stage downsample: 3x3 stride-2 conv (pad 1) -> BN -> act."""

    def __init__(self, in_ch: int, out_ch: int,
                 cfg: DownsampleConfig = DownsampleConfig(),
                 dtype=torch.float32, device=None):
        super().__init__()
        if cfg.kind != "conv":
            raise NotImplementedError(
                f"downsample kind '{cfg.kind}' is not ported yet (ROADMAP "
                "§1); only 'conv' is")
        self.act = make_activation(cfg.act)
        self.op = _conv_bn(ConvNHWC(in_ch, out_ch, 3, 2, bias=not cfg.use_bn,
                                    dtype=dtype, device=device),
                           out_ch, cfg.use_bn, device)

    def forward(self, x):
        return self.act(self.op(x))


class ConvStem(nn.Module):
    """3x3 stride-1 stem -> BN -> SiLU."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stem = nn.Sequential(
            ConvNHWC(in_ch, out_ch, 3, dtype=dtype, device=device),
            BatchNorm(out_ch, device=device))

    def forward(self, x):
        return F.silu(self.stem(x))


def init_parameters(model: nn.Module, generator: Optional[torch.Generator]):
    """Random init from ``generator`` (drawn on the CPU, so a seed gives the
    same weights on every device): LeCun-normal weights of rank >= 2 (as
    flax's default kernel init); norm scales 1 and biases 0 stay as built."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        * fan_in ** -0.5)
