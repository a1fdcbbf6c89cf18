"""Shared NHWC layers (twins of ``outgridvit_tpu/models/layers.py``):
LayerNorm, BatchNorm (batch statistics in train mode), DropPath, Dense, the
channel MLP, NHWC convs (stem, depthwise 3x3, downsample), squeeze-excite
and MBConv.

Parameters are fp32 in PyTorch's layouts (Linear [out, in], Conv OIHW,
depthwise [C, 1, 3, 3]) and are cast to the module's compute ``dtype`` per
call, as the JAX package casts its fp32 params. ``xla`` (the JAX package's
``use_pallas: false`` path) rounds as XLA evaluates the same ops: a dense
layer's product and bias add apart, the activations op by op
(:func:`~outgridvit_tpu_torch.ops.activations.make_activation`). Submodule names follow the
reference torch ``state_dict`` keys (``stem.stem.0/1``, ``mbconv.expand.0/1``,
``downs.i.op.0/1``), so ``outgridvit_tpu/utils/port_torch.py`` maps them onto
the JAX tree unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from outgridvit_tpu_torch.models.rematerialize import recomputing
from outgridvit_tpu_torch.ops.activations import make_activation
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks, drop_path
from outgridvit_tpu_torch.ops.dwconv import VARIANTS, dwconv3x3_autograd
from outgridvit_tpu_torch.ops.mlp_branch import (
    layernorm_fp32,
    mlp_branch_autograd,
    mlp_branch_variant,
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
    """BatchNorm on NHWC with the numerics of flax ``nn.BatchNorm(dtype=
    float32)``: fp32 statistics and affine, output cast back to x.dtype.

    Eval mode normalizes with the running statistics. Train mode uses the
    batch's: mean and the fast variance ``mean(x^2) - mean^2`` clamped at 0,
    and updates the running statistics with that **biased** variance at
    flax momentum 0.9 (``ra = 0.9 ra + 0.1 batch``; ``torch.nn.BatchNorm2d``
    would use the unbiased one), except in a rematerialized block's
    recompute, which must not update them a second time."""

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
            m = self.momentum
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth at ``rate`` in train mode, identity in
    eval mode or at rate 0. ``path`` is the flax module path that keys its
    mask in :class:`DropPathMasks` (set by the model). A rematerialized
    block's recompute reads the mask its forward drew."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.path = ""

    def forward(self, x, masks: Optional[DropPathMasks]):
        if not self.training or self.rate == 0.0:
            return x
        if masks is None:
            raise ValueError(
                f"DropPath '{self.path}' (rate {self.rate}) in train mode "
                "needs drop-path masks (DropPathMasks)")
        args = (self.path, self.rate, x.shape[0], x.device)
        keep = (masks.get(*args, again=True) if recomputing()
                else masks.get(*args))
        return drop_path(x, keep, self.rate)


class Dense(nn.Module):
    """``nn.Dense`` over the last axis: fp32 ``weight`` [out, in] and
    optional ``bias``, computed in ``dtype``; with ``xla`` the product and
    the bias add are rounded apart (``x @ w + b`` in the JAX package). A
    call's ``xla`` overrides the module's."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None, xla: bool = False):
        super().__init__()
        self.dtype, self.xla = dtype, xla
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x, xla: Optional[bool] = None):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.xla if xla is None else xla:
            y = torch.matmul(x.to(dt), self.weight.to(dt).t())
            return y if b is None else y + b
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


DWCONV_MODES = ("xla",) + VARIANTS  # the default first


class DepthwiseConv3x3(ConvNHWC):
    """The MBConv's depthwise 3x3 (``weight [C, 1, 3, 3]``, optional bias)
    in the JAX module's modes (``outgridvit_tpu/models/layers.py:333-361``):
    ``"xla"`` is :class:`ConvNHWC`'s grouped conv; ``"t"`` (TPU kernel #10)
    and ``"bwd"`` (#11) run :func:`dwconv3x3_autograd` at stride 1 (another
    stride takes the conv), the CUDA kernels with ``use_kernels`` and their
    plain versions without: one function either way. A bias is added after
    the conv."""

    def __init__(self, channels: int, stride: int = 1, bias: bool = False,
                 dtype=torch.float32, device=None, mode: str = "xla",
                 use_kernels: bool = False):
        if mode not in DWCONV_MODES:
            raise ValueError(f"dwconv mode {mode!r} is not one of "
                             f"{DWCONV_MODES}")
        super().__init__(channels, channels, 3, stride, groups=channels,
                         bias=bias, dtype=dtype, device=device)
        self.mode, self.use_kernels = mode, use_kernels

    def forward(self, x):
        if self.mode == "xla" or self.stride != 1:
            return super().forward(x)
        dt = self.dtype
        w9 = self.weight.to(dt).reshape(self.weight.shape[0], 9).t()
        y = dwconv3x3_autograd(x.to(dt).contiguous(), w9.contiguous(),
                               self.mode, self.use_kernels)
        return y if self.bias is None else y + self.bias.to(dt)


def _conv_bn(conv: nn.Module, dim: int, use_bn: bool, device) -> nn.Sequential:
    return nn.Sequential(conv, BatchNorm(dim, device=device)) if use_bn \
        else nn.Sequential(conv)


class ChannelMLP(nn.Module):
    """Pre-LN channel MLP branch ``fc2(act(fc1(LN(x))))`` over the last axis,
    through :func:`mlp_branch_autograd`: with ``use_kernels`` the CUDA
    kernels forward and backward, otherwise their plain versions. Launches
    are tagged with the JAX kernel the shape picks
    (:func:`mlp_branch_variant`, ``outgridvit_tpu/models/layers.py:237-241``);
    the math is the same.

    ``xla`` takes the JAX package's unfused XLA path instead (``use_pallas:
    false``, ``outgridvit_tpu/models/layers.py:297-305``): LN cast to the
    compute dtype, ``x@w1`` and ``+ b1`` each rounded, the activation op
    by op in the compute dtype, ``@w2`` and ``+ b2`` each rounded; plain
    PyTorch under autograd, no kernel."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 xla: bool = False):
        super().__init__()
        hidden = max(1, int(dim * mlp_ratio))
        self.act = act.lower()
        make_activation(self.act)  # validate the name
        self.dtype, self.use_kernels, self.xla = dtype, use_kernels, xla
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device, xla=xla)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device, xla=xla)

    def forward(self, x, ln: LayerNorm):
        dt = self.dtype
        if self.xla:
            h = self.fc1(layernorm_fp32(x, ln.weight, ln.bias, ln.eps))
            return self.fc2(make_activation(self.act, xla=True)(h))
        spatial = math.prod(x.shape[1:-1])
        return mlp_branch_autograd(
            x.to(dt).contiguous(), ln.weight, ln.bias,
            self.fc1.weight.to(dt).t().contiguous(), self.fc1.bias.to(dt),
            self.fc2.weight.to(dt).t().contiguous(), self.fc2.bias.to(dt),
            self.act, ln.eps, True, self.use_kernels,
            mlp_branch_variant(spatial, x.shape[-1]))


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation gate: fp32 mean cast to x.dtype, fp32
    sigmoid."""

    def __init__(self, channels: int, se_ratio: float = 0.25,
                 act: str = "silu", dtype=torch.float32, device=None,
                 xla: bool = False):
        super().__init__()
        if not 0.0 < se_ratio <= 1.0:
            raise ValueError("se_ratio must be in (0, 1].")
        hidden = max(1, int(channels * se_ratio))
        self.act = make_activation(act, xla)
        self.fc1 = Dense(channels, hidden, dtype=dtype, device=device, xla=xla)
        self.fc2 = Dense(hidden, channels, dtype=dtype, device=device, xla=xla)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = self.fc2(self.act(self.fc1(s)))
        return x * torch.sigmoid(s.float()).to(x.dtype)


class MBConv(nn.Module):
    """Inverted residual: expand 1x1 (skipped if mid == in) -> depthwise 3x3
    -> SE -> project 1x1; residual iff stride 1 and in == out. Expand and
    project carry no bias when ``use_bn``. ``dwconv`` and ``use_kernels``
    pick the depthwise path (:class:`DepthwiseConv3x3`)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 cfg: MBConvConfig = MBConvConfig(), dtype=torch.float32,
                 device=None, dwconv: str = "xla", use_kernels: bool = False,
                 xla: bool = False):
        super().__init__()
        if in_ch <= 0 or out_ch <= 0:
            raise ValueError("in_ch and out_ch must be > 0")
        if stride not in (1, 2):
            raise ValueError("stride must be 1 or 2")
        self.act = make_activation(cfg.act, xla)
        self.residual = stride == 1 and in_ch == out_ch
        bn = cfg.use_bn
        mid = max(1, int(round(in_ch * cfg.expand_ratio)))
        self.expand = (_conv_bn(Dense(in_ch, mid, bias=not bn, dtype=dtype,
                                      device=device, xla=xla), mid, bn,
                                device)
                       if mid != in_ch else None)
        self.depthwise = _conv_bn(
            DepthwiseConv3x3(mid, stride, not bn, dtype, device, dwconv,
                             use_kernels), mid, bn, device)
        self.se = (SqueezeExcite(mid, cfg.se_ratio, cfg.act, dtype, device,
                                 xla) if cfg.se_ratio > 0 else None)
        self.project = _conv_bn(Dense(mid, out_ch, bias=not bn, dtype=dtype,
                                      device=device, xla=xla), out_ch, bn,
                                device)

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
                 dtype=torch.float32, device=None, xla: bool = False):
        super().__init__()
        if cfg.kind != "conv":
            raise NotImplementedError(
                f"downsample kind '{cfg.kind}' is not ported yet (ROADMAP "
                "§1); only 'conv' is")
        self.act = make_activation(cfg.act, xla)
        self.op = _conv_bn(ConvNHWC(in_ch, out_ch, 3, 2, bias=not cfg.use_bn,
                                    dtype=dtype, device=device),
                           out_ch, cfg.use_bn, device)

    def forward(self, x):
        return self.act(self.op(x))


class ConvStem(nn.Module):
    """3x3 stride-1 stem -> BN -> SiLU."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32,
                 device=None, xla: bool = False):
        super().__init__()
        self.stem = nn.Sequential(
            ConvNHWC(in_ch, out_ch, 3, dtype=dtype, device=device),
            BatchNorm(out_ch, device=device))
        self.act = make_activation("silu", xla)

    def forward(self, x):
        return self.act(self.stem(x))


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
