"""The baseline zoo (twin of ``outgridvit_tpu/models/baselines.py``): the
comparison models the reference trains under the OutGridViT recipe, with
its small-image stem surgeries, NHWC.

- ``resnet18_cifar`` / ``resnet50_cifar``: ResNets with a 3x3 stride-1
  stem and no max pool (basic blocks 2/2/2/2, bottlenecks 3/4/6/3);
- ``convnext_tiny``: ConvNeXt-T with a 2x2 stride-2 stem (7x7 depthwise,
  LN, 4x pointwise MLP, layer scale ``gamma``);
- ``effnetv2_s``: EfficientNetV2-S with a 3x3 stride-1 stem (fused and
  inverted-residual blocks, squeeze-excite on the block input's width);
- ``deit_tiny_patch4`` / ``deit_small_patch4`` / ``vit_micro_patch4``:
  ViTs with a 4x4 patch embedding, a cls token and learned position
  embeddings;
- ``maxvit_nano_cifar`` / ``maxvit_tiny_cifar``: MBConv (stride 2 at a
  stage's first block) -> window attention -> grid attention -> MLP;
- ``swin_tiny_patch2``: window / shifted-window attention with a cyclic
  roll and Swin's region mask, patch merging between stages.

Every module has the JAX module's name (``layer0_0``, ``stem_bn``,
``stages_0_1``, ``patch_embed``, ...) and every parameter its layout in
the port's convention, so ``utils/port_jax.py:load_flax_variables`` maps
the JAX tree through :data:`FLAX_RENAMES`, strictly. Parameters are fp32;
``dtype`` is the compute dtype, and the math keeps the JAX modules'
rounding points (flax's ``nn.Conv`` / ``nn.Dense`` in ``dtype``, BatchNorm
and LayerNorm in fp32 cast back, the activations op by op as flax
evaluates them, fp32 pooling and classifier).

What runs the port's kernels, with ``use_kernels`` (their plain versions
without): the channel MLPs of the ViTs, MaxViTs and Swin (#2, #4 by
shape; no LN inside, the block norms it first), and the MaxViTs' window
and grid attention (the grid core #1 / #3 at N = w*w <= 16). The DeiT
attention is built off the kernels, as JAX builds it (``use_pallas=
False``), and Swin's masked window attention is plain PyTorch, as it is
XLA in JAX: fp32 logits and softmax, the probabilities cast to the
compute dtype before P.V. Each model is called ``model(x, drop_masks)``
as the train step calls the main models; the zoo's drop-path rates are 0
as JAX builds them (DeiT's ``dpr_max`` takes another).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from outgridvit_tpu_torch.models.blocks import (
    GridAttention2D,
    MultiHeadSelfAttention,
    WindowAttention2D,
)
from outgridvit_tpu_torch.models.layers import (
    BatchNorm,
    ChannelMLP,
    ConvNHWC,
    Dense,
    DropPath,
    LayerNorm,
    MBConv,
    init_parameters,
)
from outgridvit_tpu_torch.ops.activations import make_activation
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.grid import window_partition, window_unpartition
from outgridvit_tpu_torch.stage_config import MBConvConfig, make_dpr

# flax module path (dot-joined) -> torch module path, applied in order
# (``utils/port_jax.py:torch_key``): the MBConv's sequential children, then
# the BatchNorm and LayerNorm wrappers' inner ``bn`` / ``ln``
FLAX_RENAMES = (
    (r"\.mbconv\.(expand|depthwise|project)$", r".mbconv.\1.0"),
    (r"\.mbconv\.(expand|depthwise|project)_bn\.bn$", r".mbconv.\1.1"),
    (r"\.bn$", ""),
    (r"\.ln$", ""),
)

_relu = make_activation("relu", xla=True)
_silu = make_activation("silu", xla=True)
_gelu = make_activation("gelu", xla=True)


def _conv(in_ch, out_ch, k, stride=1, groups=1, bias=False, dtype=None,
          device=None):
    """flax ``nn.Conv`` as the zoo calls it: odd kernels padded k // 2 on
    each side (explicit in JAX, or ``"SAME"`` at k = 1), even ones (the
    patch embeds and downsamples, k = stride) with ``"SAME"``."""
    return ConvNHWC(in_ch, out_ch, k, stride, groups, bias, dtype, device,
                    same=k % 2 == 0)


def _pool_fp32(x):
    return x.float().mean(dim=(1, 2))


class Baseline(nn.Module):
    """What every zoo model shares: the compute ``dtype``, flax paths on
    its DropPaths, and the bridge's rename table."""

    flax_renames = FLAX_RENAMES

    def _set_paths(self):
        for name, m in self.named_modules():
            if isinstance(m, (DropPath, MultiHeadSelfAttention, ChannelMLP)):
                m.path = name.replace(".", "/")


# -- ResNets ----------------------------------------------------------------

class _BasicBlock(nn.Module):
    def __init__(self, in_ch, filters, stride, dtype, device):
        super().__init__()
        self.conv1 = _conv(in_ch, filters, 3, stride, dtype=dtype,
                           device=device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = _conv(filters, filters, 3, dtype=dtype, device=device)
        self.bn2 = BatchNorm(filters, device=device)
        if stride != 1 or in_ch != filters:
            self.downsample = _conv(in_ch, filters, 1, stride, dtype=dtype,
                                    device=device)
            self.downsample_bn = BatchNorm(filters, device=device)
        else:
            self.downsample = self.downsample_bn = None

    def forward(self, x):
        y = self.bn2(self.conv2(_relu(self.bn1(self.conv1(x)))))
        if self.downsample is not None:
            x = self.downsample_bn(self.downsample(x))
        return _relu(x + y)


class _Bottleneck(nn.Module):
    def __init__(self, in_ch, width, stride, dtype, device):
        super().__init__()
        out = width * 4
        self.conv1 = _conv(in_ch, width, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm(width, device=device)
        self.conv2 = _conv(width, width, 3, stride, dtype=dtype,
                           device=device)
        self.bn2 = BatchNorm(width, device=device)
        self.conv3 = _conv(width, out, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm(out, device=device)
        if stride != 1 or in_ch != out:
            self.downsample = _conv(in_ch, out, 1, stride, dtype=dtype,
                                    device=device)
            self.downsample_bn = BatchNorm(out, device=device)
        else:
            self.downsample = self.downsample_bn = None

    def forward(self, x):
        y = _relu(self.bn1(self.conv1(x)))
        y = _relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample_bn(self.downsample(x))
        return _relu(x + y)


class _ResNet(Baseline):
    def __init__(self, num_classes, block, width, plan, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.stem = _conv(3, width, 3, dtype=dtype, device=device)
        self.stem_bn = BatchNorm(width, device=device)
        in_ch = width
        for si, (w, depth, stride) in enumerate(plan):
            for bi in range(depth):
                blk = block(in_ch, w, stride if bi == 0 else 1, dtype, device)
                self.add_module(f"layer{si}_{bi}", blk)
                in_ch = w * (4 if block is _Bottleneck else 1)
        self.blocks = [m for n, m in self.named_children()
                       if n.startswith("layer")]
        self.fc = Dense(in_ch, num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = _relu(self.stem_bn(self.stem(x.to(self.dtype))))
        for blk in self.blocks:
            x = blk(x)
        return self.fc(_pool_fp32(x))


class ResNet18Cifar(_ResNet):
    """ResNet-18 with the CIFAR stem (3x3 s1, no max pool); JAX
    ``baselines.py:55``."""

    def __init__(self, num_classes: int = 100, width: int = 64,
                 dtype=torch.float32, device=None):
        super().__init__(num_classes, _BasicBlock, width,
                         [(width * m, 2, s) for m, s in
                          ((1, 1), (2, 2), (4, 2), (8, 2))], dtype, device)


class ResNet50Cifar(_ResNet):
    """ResNet-50 with the CIFAR stem; bottleneck depths 3/4/6/3, widths
    64-512 (x4 expansion); JAX ``baselines.py:216``."""

    def __init__(self, num_classes: int = 100, dtype=torch.float32,
                 device=None):
        super().__init__(num_classes, _Bottleneck, 64,
                         [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)],
                         dtype, device)


# -- ConvNeXt ---------------------------------------------------------------

class _ConvNeXtBlock(nn.Module):
    def __init__(self, dim, dtype, device):
        super().__init__()
        self.dwconv = _conv(dim, dim, 7, groups=dim, bias=True, dtype=dtype,
                            device=device)
        self.norm = LayerNorm(dim, 1e-6, device)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype, device=device,
                             xla=True)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype, device=device,
                             xla=True)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6, device=device))

    def forward(self, x):
        y = self.pwconv2(_gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXtTiny(Baseline):
    """ConvNeXt-T with a 2x2 stride-2 stem; depths 3/3/9/3, dims
    96-768, LN + 2x2 stride-2 downsampling; JAX ``baselines.py:269``."""

    def __init__(self, num_classes: int = 100,
                 dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (3, 3, 9, 3), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        self.stem = _conv(3, dims[0], 2, 2, bias=True, dtype=dtype,
                          device=device)
        self.stem_norm = LayerNorm(dims[0], 1e-6, device)
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            if si > 0:
                self.add_module(f"down_norm_{si}",
                                LayerNorm(dims[si - 1], 1e-6, device))
                self.add_module(f"down_{si}", _conv(
                    dims[si - 1], dim, 2, 2, bias=True, dtype=dtype,
                    device=device))
            for bi in range(depth):
                self.add_module(f"stages_{si}_{bi}",
                                _ConvNeXtBlock(dim, dtype, device))
        self.norm = LayerNorm(dims[-1], 1e-6, device)
        self.head = Dense(dims[-1], num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = self.stem_norm(self.stem(x.to(self.dtype)))
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = getattr(self, f"down_{si}")(
                    getattr(self, f"down_norm_{si}")(x))
            for bi in range(depth):
                x = getattr(self, f"stages_{si}_{bi}")(x)
        return self.head(self.norm(_pool_fp32(x)))


# -- EfficientNetV2-S ---------------------------------------------------------

class _SEUnit(nn.Module):
    """GAP (fp32, cast back) -> 1x1 reduce (SiLU) -> 1x1 expand -> sigmoid
    gate in the compute dtype."""

    def __init__(self, ch, rd, dtype, device):
        super().__init__()
        self.reduce = _conv(ch, rd, 1, bias=True, dtype=dtype, device=device)
        self.expand = _conv(rd, ch, 1, bias=True, dtype=dtype, device=device)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = self.expand(_silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class _FusedMBConv(nn.Module):
    def __init__(self, in_ch, out_ch, expand, stride, dtype, device):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.expand = expand
        if expand == 1:
            self.conv = _conv(in_ch, out_ch, 3, stride, dtype=dtype,
                              device=device)
            self.bn = BatchNorm(out_ch, device=device)
        else:
            mid = in_ch * expand
            self.conv_exp = _conv(in_ch, mid, 3, stride, dtype=dtype,
                                  device=device)
            self.bn1 = BatchNorm(mid, device=device)
            self.conv_pwl = _conv(mid, out_ch, 1, dtype=dtype, device=device)
            self.bn2 = BatchNorm(out_ch, device=device)

    def forward(self, x):
        if self.expand == 1:
            y = _silu(self.bn(self.conv(x)))
        else:
            y = self.bn2(self.conv_pwl(_silu(self.bn1(self.conv_exp(x)))))
        return y + x if self.residual else y


class _MBConvV2(nn.Module):
    def __init__(self, in_ch, out_ch, expand, stride, se_ratio, dtype,
                 device):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        mid = in_ch * expand
        self.conv_pw = _conv(in_ch, mid, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv_dw = _conv(mid, mid, 3, stride, groups=mid, dtype=dtype,
                             device=device)
        self.bn2 = BatchNorm(mid, device=device)
        self.se = _SEUnit(mid, max(1, int(in_ch * se_ratio)), dtype, device)
        self.conv_pwl = _conv(mid, out_ch, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm(out_ch, device=device)

    def forward(self, x):
        y = _silu(self.bn1(self.conv_pw(x)))
        y = self.se(_silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


# timm's v2_s stage table: (kind, repeats, expand, out channels, stride, se)
EFFNETV2_S_STAGES = (
    ("fused", 2, 1, 24, 1, 0.0),
    ("fused", 4, 4, 48, 2, 0.0),
    ("fused", 4, 4, 64, 2, 0.0),
    ("mb", 6, 4, 128, 2, 0.25),
    ("mb", 9, 6, 160, 1, 0.25),
    ("mb", 15, 6, 256, 2, 0.25),
)


class EfficientNetV2S(Baseline):
    """EfficientNetV2-S with a 3x3 stride-1 stem and a 1x1 head conv to
    1280; JAX ``baselines.py:390``."""

    def __init__(self, num_classes: int = 100, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = _conv(3, 24, 3, dtype=dtype, device=device)
        self.stem_bn = BatchNorm(24, device=device)
        in_ch, blocks = 24, []
        for si, (kind, repeat, expand, out_ch, stride, se) in enumerate(
                EFFNETV2_S_STAGES):
            for bi in range(repeat):
                s = stride if bi == 0 else 1
                blk = (_FusedMBConv(in_ch, out_ch, expand, s, dtype, device)
                       if kind == "fused" else
                       _MBConvV2(in_ch, out_ch, expand, s, se, dtype, device))
                self.add_module(f"blocks_{si}_{bi}", blk)
                blocks.append(blk)
                in_ch = out_ch
        self.blocks = blocks
        self.conv_head = _conv(in_ch, 1280, 1, dtype=dtype, device=device)
        self.head_bn = BatchNorm(1280, device=device)
        self.classifier = Dense(1280, num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = _silu(self.stem_bn(self.conv_stem(x.to(self.dtype))))
        for blk in self.blocks:
            x = blk(x)
        x = _silu(self.head_bn(self.conv_head(x)))
        return self.classifier(_pool_fp32(x))


# -- ViTs -------------------------------------------------------------------

class _ViTBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, drop_path, dtype, use_kernels,
                 device):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, device)
        self.attn = MultiHeadSelfAttention(dim, heads, dtype, False, device,
                                           xla=True)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, 1e-6, device)
        self.mlp = ChannelMLP(dim, mlp_ratio, "gelu", dtype, use_kernels,
                              device)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, masks):
        x = x + self.dp1(self.attn(self.norm1(x), masks=masks), masks)
        return x + self.dp2(self.mlp(self.norm2(x), masks=masks), masks)


class DeiT(Baseline):
    """ViT with a patch embedding, cls token and learned position
    embedding (``cls_token`` [1, 1, dim], ``pos_embed`` [1, n + 1, dim] for
    ``img`` px input); JAX ``baselines.py:107``. The attention runs off the
    kernels (JAX ``use_pallas=False``), the MLP through #2."""

    def __init__(self, num_classes: int = 100, patch: int = 4, dim: int = 192,
                 depth: int = 12, num_heads: int = 3, mlp_ratio: float = 4.0,
                 dpr_max: float = 0.0, dtype=torch.float32,
                 use_kernels: bool = False, device=None, img: int = 32):
        super().__init__()
        self.dtype, self.patch, self.dim = dtype, patch, dim
        n = (img // patch) ** 2
        self.patch_embed = _conv(3, dim, patch, patch, bias=True, dtype=dtype,
                                 device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim,
                                                  device=device))
        blocks = []
        for i, dp in enumerate(make_dpr(depth, dpr_max)):
            blk = _ViTBlock(dim, num_heads, mlp_ratio, dp, dtype, use_kernels,
                            device)
            self.add_module(f"blocks_{i}", blk)
            blocks.append(blk)
        self.blocks = blocks
        self.norm = LayerNorm(dim, 1e-6, device)
        self.head = Dense(dim, num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = self.patch_embed(x.to(self.dtype))
        B = x.shape[0]
        x = x.reshape(B, -1, self.dim)
        cls = self.cls_token.expand(B, 1, self.dim).to(x.dtype)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, drop_masks)
        return self.head(self.norm(x)[:, 0].float())

    def init_extra(self, generator: torch.Generator):
        """JAX's inits of the token parameters: the cls token zeros, the
        position embedding normal(0.02)."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                             generator=generator) * 0.02)


# -- MaxViT -----------------------------------------------------------------

class _MaxViTBlock(nn.Module):
    """MBConv (stride 2 at a stage's first block) -> LN -> window attention
    -> LN -> grid attention -> LN -> MLP, each with a residual."""

    def __init__(self, in_ch, dim, heads, window, grid, stride, dtype,
                 use_kernels, device):
        super().__init__()
        self.mbconv = MBConv(in_ch, dim, stride, MBConvConfig(), dtype,
                             device, use_kernels=use_kernels)
        self.norm_w = LayerNorm(dim, 1e-5, device)
        self.window_attn = WindowAttention2D(dim, heads, window, dtype,
                                             use_kernels, device)
        self.norm_g = LayerNorm(dim, 1e-5, device)
        self.grid_attn = GridAttention2D(dim, heads, grid, dtype, use_kernels,
                                         device)
        self.norm_m = LayerNorm(dim, 1e-5, device)
        self.mlp = ChannelMLP(dim, 4.0, "gelu", dtype, use_kernels, device)

    def forward(self, x, masks):
        x = self.mbconv(x)
        x = x + self.window_attn(self.norm_w(x), masks)
        x = x + self.grid_attn(self.norm_g(x), masks=masks)
        return x + self.mlp(self.norm_m(x), masks=masks)


class _MaxViT(Baseline):
    def __init__(self, num_classes, stem_dim, dims, depths, window_size,
                 first_stride, two_stem_convs, dtype, use_kernels, device,
                 img):
        super().__init__()
        self.dtype, self.two = dtype, two_stem_convs
        if two_stem_convs:
            self.stem_conv1 = _conv(3, stem_dim, 3, dtype=dtype, device=device)
            self.stem_bn1 = BatchNorm(stem_dim, device=device)
            self.stem_conv2 = _conv(stem_dim, stem_dim, 3, dtype=dtype,
                                    device=device)
        else:
            self.stem = _conv(3, stem_dim, 3, dtype=dtype, device=device)
            self.stem_bn = BatchNorm(stem_dim, device=device)
        in_ch, H, blocks = stem_dim, img, []
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            for bi in range(depth):
                stride = 2 if bi == 0 and (si > 0 or first_stride) else 1
                H = max(1, H // stride)
                w = min(window_size, H)
                blk = _MaxViTBlock(in_ch, dim, max(2, dim // 32), w, w,
                                   stride, dtype, use_kernels, device)
                self.add_module(f"stages_{si}_{bi}", blk)
                blocks.append(blk)
                in_ch = dim
        self.blocks = blocks
        self.head = Dense(in_ch, num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = x.to(self.dtype)
        if self.two:
            x = _gelu(self.stem_bn1(self.stem_conv1(x)))
            x = self.stem_conv2(x)
        else:
            x = _gelu(self.stem_bn(self.stem(x)))
        for blk in self.blocks:
            x = blk(x, drop_masks)
        return self.head(_pool_fp32(x))


class MaxViTNano(_MaxViT):
    """Compact MaxViT for 32 px: stem 48, dims 48/96/192, depths 1/2/2,
    stride 2 at the first block of stages 1-2; JAX ``baselines.py:475``."""

    def __init__(self, num_classes: int = 100, stem_dim: int = 48,
                 dims: Sequence[int] = (48, 96, 192),
                 depths: Sequence[int] = (1, 2, 2), window_size: int = 4,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 img: int = 32):
        super().__init__(num_classes, stem_dim, dims, depths, window_size,
                         False, False, dtype, use_kernels, device, img)


class MaxViTTiny(_MaxViT):
    """MaxViT-T for 32 px with the CIFAR stem (two 3x3 stride-1 convs):
    dims 64/128/256/512, depths 2/2/5/2, stride 2 at every stage's first
    block; JAX ``baselines.py:511``."""

    def __init__(self, num_classes: int = 100, stem_dim: int = 64,
                 dims: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 5, 2), window_size: int = 4,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 img: int = 32):
        super().__init__(num_classes, stem_dim, dims, depths, window_size,
                         True, True, dtype, use_kernels, device, img)


# -- Swin -------------------------------------------------------------------

def swin_region_mask(H: int, W: int, w: int, s: int) -> np.ndarray:
    """Swin's additive mask [nW, N, N] for a cyclic shift of s: 0 between
    two tokens of one pre-roll region, -1e30 between regions (JAX
    ``baselines.py:595-609``)."""
    region = np.zeros((H, W), np.int32)
    rid = 0
    for hs in (slice(0, H - w), slice(H - w, H - s), slice(H - s, H)):
        for ws in (slice(0, W - w), slice(W - w, W - s), slice(W - s, W)):
            region[hs, ws] = rid
            rid += 1
    region = np.roll(region, (-s, -s), axis=(0, 1))
    Hb, Wb = H // w, W // w
    region = region.reshape(Hb, w, Wb, w).transpose(0, 2, 1, 3).reshape(
        Hb * Wb, w * w)
    return np.where(region[:, :, None] != region[:, None, :], -1e30,
                    0.0).astype(np.float32)


class _SwinBlock(nn.Module):
    """(Shifted) window MHSA + MLP: LN -> roll by -s -> windows -> qkv ->
    fp32 logits (+ the region mask) and softmax -> probabilities cast to
    the compute dtype -> P.V -> proj -> unpartition -> roll by s, residual;
    LN -> MLP, residual."""

    def __init__(self, dim, heads, window, shift, dtype, use_kernels,
                 device):
        super().__init__()
        self.heads, self.w, self.s = heads, window, shift
        self.norm1 = LayerNorm(dim, 1e-5, device)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device, xla=True)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, xla=True)
        self.norm2 = LayerNorm(dim, 1e-5, device)
        self.mlp = ChannelMLP(dim, 4.0, "gelu", dtype, use_kernels, device)
        self._masks = {}

    def _mask(self, H, W, device):
        key = (H, W, device)
        if key not in self._masks:  # made once per shape, off any capture
            self._masks[key] = torch.from_numpy(
                swin_region_mask(H, W, self.w, self.s)).to(device)
        return self._masks[key]

    def forward(self, x, masks):
        B, H, W, C = x.shape
        w, s, heads = self.w, self.s, self.heads
        hd, N = C // heads, w * w
        y = self.norm1(x)
        if s > 0:
            y = torch.roll(y, (-s, -s), (1, 2))
        wins, meta = window_partition(y, w)
        Bw = wins.shape[0]
        qkv = self.qkv(wins.reshape(Bw, N, C)).reshape(Bw, N, 3, heads, hd)
        q, k, v = qkv.float().unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        if s > 0:
            mask = self._mask(H, W, x.device)
            nW = mask.shape[0]
            logits = (logits.reshape(Bw // nW, nW, heads, N, N)
                      + mask[None, :, None]).reshape(Bw, heads, N, N)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        a = (e / e.sum(-1, keepdim=True)).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", a.float(), v).to(x.dtype)
        out = self.proj(out.reshape(Bw, N, C))
        y = window_unpartition(out.reshape(Bw, w, w, C), meta)
        if s > 0:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x), masks=masks)


class SwinTiny(Baseline):
    """Swin-style hierarchy for small images: a 2x2 patch embed, stages of
    [window, shifted-window] blocks (dims 96/192/384, depths 2/2/4, window
    4, heads dim // 32), 2x2 patch merging (LN, a bias-free linear)
    between stages; JAX ``baselines.py:631``."""

    def __init__(self, num_classes: int = 100, patch: int = 2,
                 dims: Sequence[int] = (96, 192, 384),
                 depths: Sequence[int] = (2, 2, 4), window_size: int = 4,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 img: int = 32):
        super().__init__()
        self.dtype, self.depths = dtype, tuple(depths)
        self.patch_embed = _conv(3, dims[0], patch, patch, bias=True,
                                 dtype=dtype, device=device)
        H = img // patch
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            if si > 0:
                self.add_module(f"merge_norm_{si}",
                                LayerNorm(4 * dims[si - 1], 1e-5, device))
                self.add_module(f"merge_{si}", Dense(
                    4 * dims[si - 1], dim, bias=False, dtype=dtype,
                    device=device, xla=True))
                H //= 2
            w = min(window_size, H)
            for bi in range(depth):
                shift = w // 2 if bi % 2 == 1 and H > w else 0
                self.add_module(f"stages_{si}_{bi}", _SwinBlock(
                    dim, max(2, dim // 32), w, shift, dtype, use_kernels,
                    device))
        self.norm = LayerNorm(dims[-1], 1e-5, device)
        self.head = Dense(dims[-1], num_classes, device=device)
        self._set_paths()

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        x = self.patch_embed(x.to(self.dtype))
        for si, depth in enumerate(self.depths):
            if si > 0:
                B, H, W, C = x.shape
                x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
                    0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
                x = getattr(self, f"merge_{si}")(
                    getattr(self, f"merge_norm_{si}")(x))
            for bi in range(depth):
                x = getattr(self, f"stages_{si}_{bi}")(x, drop_masks)
        return self.head(_pool_fp32(self.norm(x)))


# -- the registry -------------------------------------------------------------

BASELINES = {
    "resnet18_cifar": ("resnet18",),
    "resnet50_cifar": ("resnet50",),
    "convnext_tiny": ("convnext_tiny_patch2",),
    "effnetv2_s": ("efficientnetv2_s",),
    "deit_tiny_patch4": ("deit_tiny",),
    "deit_small_patch4": ("deit_small",),
    "vit_micro_patch4": ("vit_micro",),
    "maxvit_nano_cifar": ("maxvit_nano",),
    "maxvit_tiny_cifar": ("maxvit_tiny",),
    "swin_tiny_patch2": ("swin_tiny",),
}


def _make(name: str, num_classes: int, dtype, use_kernels: bool, device,
          img: int):
    common = dict(dtype=dtype, device=device)
    zoo = dict(common, use_kernels=use_kernels, img=img)
    if name == "resnet18_cifar":
        return ResNet18Cifar(num_classes, **common)
    if name == "resnet50_cifar":
        return ResNet50Cifar(num_classes, **common)
    if name == "convnext_tiny":
        return ConvNeXtTiny(num_classes, **common)
    if name == "effnetv2_s":
        return EfficientNetV2S(num_classes, **common)
    if name == "deit_tiny_patch4":
        return DeiT(num_classes, 4, 192, 12, 3, **zoo)
    if name == "deit_small_patch4":
        return DeiT(num_classes, 4, 384, 12, 6, **zoo)
    if name == "vit_micro_patch4":
        return DeiT(num_classes, 4, 32, 2, 2, **zoo)
    if name == "maxvit_nano_cifar":
        return MaxViTNano(num_classes, **zoo)
    if name == "maxvit_tiny_cifar":
        return MaxViTTiny(num_classes, **zoo)
    return SwinTiny(num_classes, **zoo)


def canonical_name(name: str) -> str:
    """A ``build_baseline`` name or alias (any case) -> its canonical name;
    an unknown one raises ``ValueError`` naming the available ones."""
    key = name.lower()
    for canon, aliases in BASELINES.items():
        if key == canon or key in aliases:
            return canon
    raise ValueError(f"Unknown baseline '{name}'. Available: "
                     f"{', '.join(BASELINES)}")


def init_baseline(model: nn.Module, generator: torch.Generator):
    """Random weights from ``generator``: LeCun-normal weights of rank >= 2
    (:func:`init_parameters`), then JAX's inits of DeiT's token parameters;
    norm scales 1, biases 0 and ConvNeXt's ``gamma`` 1e-6 stay as built."""
    init_parameters(model, generator)
    if isinstance(model, DeiT):
        model.init_extra(generator)


def build_baseline(name: str, num_classes: int = 100, dtype=torch.float32,
                   device="cuda", use_kernels: Optional[bool] = None,
                   seed: int = 0, img_size: int = 32) -> nn.Module:
    """Build a zoo model (a name or alias of JAX ``build_baseline``,
    ``outgridvit_tpu/models/baselines.py:150-180``) in eval mode with
    random weights from a ``torch.Generator`` seeded with ``seed`` (not on
    the ``meta`` device). Parameters are fp32, ``dtype`` the compute
    dtype; ``use_kernels`` as in
    :func:`~outgridvit_tpu_torch.models.build.build_model`: None runs the
    CUDA kernels iff ``device`` is CUDA, True on another device raises.
    ``img_size`` sizes DeiT's position embedding (JAX takes it from the
    input at init) and the MaxViT and Swin windows."""
    canon = canonical_name(name)
    device = torch.device(device)
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    elif use_kernels and device.type != "cuda":
        raise ValueError(f"use_kernels=True needs a CUDA device; got {device}")
    model = _make(canon, num_classes, dtype, use_kernels, device,
                  img_size)
    model.name = canon
    if device.type != "meta":
        init_baseline(model, torch.Generator().manual_seed(seed))
    return model.eval()
