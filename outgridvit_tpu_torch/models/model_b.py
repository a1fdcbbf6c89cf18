"""Model B, OutlookerFrontGridNet (twin of ``outgridvit_tpu/models/
model_b.py``): stem -> 1x1 ``proj_in`` when the stem width differs from
stage 0 -> ``outlooker_front_depth`` outlooker blocks at stage 0's width with
its outlook settings and dropouts (``front.i``) -> stages of GridOnlyBlocks
with downsamples between them -> BN head -> fp32 mean over H, W -> fp32
classifier. The linear stochastic-depth schedule ``make_dpr`` runs over the
front and the stage blocks together. NHWC throughout. ``remat`` as in
``model_a.py``: each front outlooker and each GridOnlyBlock runs under
``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from outgridvit_tpu_torch.models.blocks import (
    GridOnlyBlock,
    MultiHeadSelfAttention,
    OutlookAttention2d,
    OutlookerBlock2d,
)
from outgridvit_tpu_torch.models.layers import (
    BatchNorm,
    ChannelMLP,
    ConvStem,
    Dense,
    Downsample,
    DropPath,
)
from outgridvit_tpu_torch.models.model_a import flax_path
from outgridvit_tpu_torch.models.rematerialize import (
    checkpoint_block,
    remat_enabled,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.stage_config import (
    DownsampleConfig,
    StageCfg,
    make_dpr,
)


class OutlookerFrontGridNet(nn.Module):
    def __init__(self, num_classes: int, stages: Sequence[StageCfg],
                 in_ch: int = 3, stem_dim: int = 64,
                 outlooker_front_depth: int = 2, dpr_max: float = 0.1,
                 down_cfg: DownsampleConfig = DownsampleConfig(),
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False,
                 remat: Optional[str] = None):
        super().__init__()
        if not stages:
            raise ValueError("model.stages must have at least one stage config")
        remat_enabled(remat)  # an unknown policy raises here
        self.dtype, self.remat = dtype, remat
        self.stage_cfgs = tuple(stages)
        self.stem = ConvStem(in_ch, stem_dim, dtype, device, xla)
        self.proj_in = (Dense(stem_dim, stages[0].dim, dtype=dtype,
                              device=device, xla=xla)
                        if stem_dim != stages[0].dim else None)
        dprs = iter(make_dpr(
            outlooker_front_depth + sum(s.depth for s in stages), dpr_max))
        f = stages[0]
        self.front = nn.ModuleList(
            OutlookerBlock2d(f.dim, f.outlook_heads, f.outlook_kernel,
                             f.outlook_mlp_ratio, f.mlp_act,
                             drop_path=next(dprs), dtype=dtype,
                             use_kernels=use_kernels, device=device,
                             outlook_mode=outlook_mode, xla=xla,
                             attn_drop=f.attn_drop, proj_drop=f.proj_drop,
                             mlp_drop=f.ffn_drop)
            for _ in range(outlooker_front_depth))
        self.stages = nn.ModuleList(
            nn.ModuleList(GridOnlyBlock(s.replace(drop_path=next(dprs)),
                                        dtype, use_kernels, device, dwconv,
                                        xla, attn_nhwc)
                          for _ in range(s.depth))
            for s in stages)
        self.downs = nn.ModuleList(
            Downsample(a.dim, b.dim, down_cfg, dtype, device, xla)
            for a, b in zip(stages[:-1], stages[1:]))
        self.head_norm = BatchNorm(stages[-1].dim, device=device)
        self.classifier = Dense(stages[-1].dim, num_classes,
                                dtype=torch.float32, device=device)
        for name, m in self.named_modules():
            if isinstance(m, (DropPath, OutlookAttention2d,
                              MultiHeadSelfAttention, ChannelMLP)):
                m.path = flax_path(name)

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        """x: [B, H, W, in_ch] float -> logits [B, num_classes] fp32, with
        the train-mode behaviour of :class:`~outgridvit_tpu_torch.models.
        model_a.MaxOutNet`."""
        x = self.stem(x.to(self.dtype))
        if self.proj_in is not None:
            x = self.proj_in(x)
        for block in self.front:
            x = checkpoint_block(block, self.remat, x, drop_masks)
        for si, blocks in enumerate(self.stages):
            for block in blocks:
                x = checkpoint_block(block, self.remat, x, drop_masks)
            if si < len(self.downs):
                x = self.downs[si](x)
        x = self.head_norm(x).float().mean(dim=(1, 2))
        return self.classifier(x)
