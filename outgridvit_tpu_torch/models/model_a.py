"""Model A, MaxOutNet, eval forward (twin of ``outgridvit_tpu/models/
model_a.py``): stem -> 1x1 ``proj_in`` when the stem width differs from
stage 0 -> stages of OutGridBlocks with stride-2 conv downsamples between
them -> BN head -> fp32 mean over H, W -> fp32 classifier. NHWC throughout.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from outgridvit_tpu_torch.models.blocks import OutGridBlock
from outgridvit_tpu_torch.models.layers import (
    BatchNorm,
    ConvStem,
    Dense,
    Downsample,
)
from outgridvit_tpu_torch.stage_config import DownsampleConfig, StageCfg


class MaxOutNet(nn.Module):
    def __init__(self, num_classes: int, stages: Sequence[StageCfg],
                 in_ch: int = 3, stem_dim: int = 64,
                 down_cfg: DownsampleConfig = DownsampleConfig(),
                 dtype=torch.float32, use_kernels: bool = False, device=None):
        super().__init__()
        if not stages:
            raise ValueError("model.stages must have at least one stage config")
        self.dtype = dtype
        self.stem = ConvStem(in_ch, stem_dim, dtype, device)
        self.proj_in = (Dense(stem_dim, stages[0].dim, dtype=dtype,
                              device=device)
                        if stem_dim != stages[0].dim else None)
        self.stages = nn.ModuleList(
            nn.ModuleList(OutGridBlock(s, dtype, use_kernels, device)
                          for _ in range(s.depth))
            for s in stages)
        self.downs = nn.ModuleList(
            Downsample(a.dim, b.dim, down_cfg, dtype, device)
            for a, b in zip(stages[:-1], stages[1:]))
        self.head_norm = BatchNorm(stages[-1].dim, device=device)
        self.classifier = Dense(stages[-1].dim, num_classes,
                                dtype=torch.float32, device=device)

    def forward(self, x):
        """x: [B, H, W, in_ch] float -> logits [B, num_classes] fp32."""
        if self.training:
            raise RuntimeError(
                "MaxOutNet is ported for eval only (call .eval()); the train "
                "forward comes with the train step (ROADMAP §1)")
        x = self.stem(x.to(self.dtype))
        if self.proj_in is not None:
            x = self.proj_in(x)
        for si, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x)
            if si < len(self.downs):
                x = self.downs[si](x)
        x = self.head_norm(x).float().mean(dim=(1, 2))
        return self.classifier(x)
