"""Shared NHWC layers (twins of ``outgridvit_tpu/models/layers.py``):
LayerNorm, BatchNorm (batch statistics in train mode), DropPath, dropout,
Dense, the channel MLP, NHWC convs (stem, depthwise 3x3, downsample),
squeeze-excite and MBConv.

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
from outgridvit_tpu_torch.ops.dropout import dropout
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
    recompute, which must not update them a second time.

    On a mesh (``parallel/mesh.py:shard_model`` sets ``data_axis``) the
    train-mode statistics cover the global batch, as GSPMD's mean over a
    batch split on ``data`` does in JAX: the per-channel ``sum(x)``,
    ``sum(x^2)`` and the count are summed over the data group, gradients
    flowing through the sum (SyncBatchNorm's maths on the fast variance).
    With one rank on the data axis the expression is the one above."""

    momentum = 0.9
    data_axis = None  # the mesh's data Axis (parallel/collectives.py)

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
            axis = self.data_axis
            if axis is None or axis.size == 1:
                mean = x32.mean(dims)
                var = torch.clamp((x32 * x32).mean(dims) - mean * mean,
                                  min=0.0)
            else:
                mean, var = _global_moments(x32, dims, axis)
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


def _global_moments(x32, dims, axis):
    """Mean and clamped fast variance of ``x32`` over ``dims`` and the
    ranks of ``axis``: the local sums and count, summed over the axis."""
    from outgridvit_tpu_torch.parallel.collectives import all_reduce_sum

    C = x32.shape[-1]
    count = x32.new_full((1,), float(x32.numel() // C))
    sums = all_reduce_sum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                                     count]), axis)
    mean = sums[:C] / sums[2 * C]
    var = torch.clamp(sums[C:2 * C] / sums[2 * C] - mean * mean, min=0.0)
    return mean, var


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


def apply_dropout(x, rate: float, masks: Optional[DropPathMasks],
                  path: str, training: bool):
    """flax ``nn.Dropout(rate)`` at the site ``path``: x in eval mode or at
    rate 0, zeros at rate 1, else x with the site's keep mask from
    ``masks`` (``ops/dropout.py``). A rematerialized block's recompute
    gets its forward's mask again: the masks are a function of the site
    and the step, drawn or given, never of the call."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if masks is None:
        raise ValueError(f"dropout '{path}' (rate {rate}) in train mode "
                         "needs masks (DropPathMasks with a dropout source)")
    return dropout(x, masks.dropout_keep(path, rate, x.shape, x.device), rate)


def site_path(path: str, name: str) -> str:
    """The flax path of dropout site ``name`` (``Dropout_0``) of the module
    at ``path`` ("" for a module applied alone)."""
    return f"{path}/{name}" if path else name


_LN_IDENTITY: dict = {}


def ln_identity(C: int, device):
    """LayerNorm parameters (ones, zeros) that a fused branch called
    without its LN (``apply_ln=False``) reads but does not apply, made
    once per (C, device). A pair made where it could not serve every later
    call is not kept: in a CUDA graph capture (whose fill runs only at
    replay), in inference mode (its tensors cannot be saved for a
    backward), or as a tracer's tensors."""
    key = (C, torch.device(device))
    got = _LN_IDENTITY.get(key)
    if got is None:
        got = (torch.ones(C, device=device), torch.zeros(C, device=device))
        if (type(got[0]) is torch.Tensor and not got[0].is_inference()
                and not torch.compiler.is_compiling()
                and not (key[1].type == "cuda"
                         and torch.cuda.is_current_stream_capturing())):
            _LN_IDENTITY[key] = got
    return got


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


def same_pads(size: int, k: int, s: int):
    """flax ``nn.Conv``'s ``"SAME"`` padding of one axis: (low, high) so
    that the output has ``ceil(size / s)`` positions."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvNHWC(nn.Module):
    """2-D convolution on NHWC activations with an OIHW ``weight``: padded
    ``kernel // 2`` on every side, or with ``same`` as flax ``nn.Conv``'s
    default ``"SAME"`` (no padding where the kernel equals the stride and
    divides the input, as the patch embeds have it)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dtype=torch.float32,
                 device=None, same: bool = False):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.same = same
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        k, s = self.weight.shape[-1], self.stride
        x = x.to(dt).permute(0, 3, 1, 2)
        pad = k // 2
        if self.same:
            (t, bo), (le, r) = (same_pads(n, k, s) for n in x.shape[2:])
            pad = 0
            if (t, bo, le, r) != (0, 0, 0, 0):
                x = F.pad(x, (le, r, t, bo))
        y = F.conv2d(x, self.weight.to(dt), b, stride=s, padding=pad,
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
    """Channel MLP branch ``fc2(act(fc1(LN(x))))`` over the last axis (no
    LN when called without one), through :func:`mlp_branch_autograd`: with
    ``use_kernels`` the CUDA kernels forward and backward, otherwise their
    plain versions. Launches are tagged with the JAX kernel the shape picks
    (:func:`mlp_branch_variant`, ``outgridvit_tpu/models/layers.py:
    237-241``); the math is the same. JAX falls back to XLA for a token
    count its TPU kernel cannot tile (``mlp_t_fits``); the CUDA kernels
    take any, so the port runs them at every shape.

    ``xla`` takes the JAX package's unfused XLA path instead (``use_pallas:
    false``, ``outgridvit_tpu/models/layers.py:297-305``): LN cast to the
    compute dtype, ``x@w1`` and ``+ b1`` each rounded, the activation op
    by op in the compute dtype, ``@w2`` and ``+ b2`` each rounded; plain
    PyTorch under autograd, no kernel. Dropout at ``drop`` in train mode
    takes that path too, as in JAX (``layers.py:260, 300-304``): after the
    activation (site ``<path>/Dropout_0``) and after fc2
    (``<path>/Dropout_1``)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 xla: bool = False, drop: float = 0.0):
        super().__init__()
        hidden = max(1, int(dim * mlp_ratio))
        self.act = act.lower()
        make_activation(self.act)  # validate the name
        self.dtype, self.use_kernels, self.xla = dtype, use_kernels, xla
        self.drop = float(drop)
        self.path = ""  # the flax module path, set by the model
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device, xla=xla)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device, xla=xla)

    def forward(self, x, ln: Optional[LayerNorm] = None,
                masks: Optional[DropPathMasks] = None):
        dt = self.dtype
        if self.xla or (self.training and self.drop > 0.0):
            h = x if ln is None else layernorm_fp32(x, ln.weight, ln.bias,
                                                    ln.eps)
            h = make_activation(self.act, xla=True)(self.fc1(h, xla=True))
            h = apply_dropout(h, self.drop, masks,
                              site_path(self.path, "Dropout_0"), self.training)
            return apply_dropout(self.fc2(h, xla=True), self.drop, masks,
                                 site_path(self.path, "Dropout_1"),
                                 self.training)
        spatial = math.prod(x.shape[1:-1])
        lw, lb, eps = ((ln.weight, ln.bias, ln.eps) if ln is not None
                       else (*ln_identity(x.shape[-1], x.device), 1e-5))
        return mlp_branch_autograd(
            x.to(dt).contiguous(), lw, lb,
            self.fc1.weight.to(dt).t().contiguous(), self.fc1.bias.to(dt),
            self.fc2.weight.to(dt).t().contiguous(), self.fc2.bias.to(dt),
            self.act, eps, ln is not None, self.use_kernels,
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


def avg_pool(x, s: int):
    """flax ``nn.avg_pool(x, (s, s), strides=(s, s))`` on NHWC (VALID: a
    remainder row or column is dropped): the window's sum in x's dtype,
    then divided by s*s."""
    B, H, W, C = x.shape
    Hs, Ws = H // s, W // s
    win = x[:, :Hs * s, :Ws * s].reshape(B, Hs, s, Ws, s, C)
    acc = win[:, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = acc + win[:, :, i, :, j]
    return acc / torch.tensor(float(s * s), dtype=x.dtype)


class Downsample(nn.Module):
    """Between-stage downsample (``outgridvit_tpu/models/layers.py:
    463-490``): kind ``"conv"``, a 3x3 stride-2 conv (pad 1) -> BN -> act;
    kind ``"pool"``, a 2x2 stride-2 average pool -> 1x1 (``Dense``) -> BN
    -> act. Either way ``op.0`` holds the conv and ``op.1`` the BN: the
    JAX package's ``port_torch_state_dict`` maps ``downs_i.bn`` to the
    first of ``op.1`` / ``op.2`` it finds, so the reference's pool layout
    (conv at ``op.1``, BN at ``op.2``) would hand the BN the conv's
    weight."""

    def __init__(self, in_ch: int, out_ch: int,
                 cfg: DownsampleConfig = DownsampleConfig(),
                 dtype=torch.float32, device=None, xla: bool = False):
        super().__init__()
        if cfg.kind not in ("conv", "pool"):
            raise ValueError("cfg.kind must be 'conv' or 'pool'")
        self.kind = cfg.kind
        self.act = make_activation(cfg.act, xla)
        conv = (ConvNHWC(in_ch, out_ch, 3, 2, bias=not cfg.use_bn,
                         dtype=dtype, device=device) if cfg.kind == "conv"
                else Dense(in_ch, out_ch, bias=not cfg.use_bn, dtype=dtype,
                           device=device, xla=xla))
        self.op = _conv_bn(conv, out_ch, cfg.use_bn, device)

    def forward(self, x):
        if self.kind == "pool":
            x = avg_pool(x, 2)
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
