"""Model A, MaxOutNet (twin of ``outgridvit_tpu/models/model_a.py``): stem
-> 1x1 ``proj_in`` when the stem width differs from stage 0 -> stages of
OutGridBlocks (linear stochastic-depth schedule ``make_dpr`` over all
blocks) with stride-2 conv downsamples between them -> BN head -> fp32 mean
over H, W -> fp32 classifier. NHWC throughout.

``remat`` names a per-block rematerialization policy
(``models/rematerialize.py``): each OutGridBlock then runs under
``torch.utils.checkpoint``; None or an off value saves as usual.
``stage_cfgs`` keeps the stage configs (the capture's grid sizes).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch
from torch import nn

from outgridvit_tpu_torch.models.blocks import (
    MultiHeadSelfAttention,
    OutGridBlock,
    OutlookAttention2d,
)
from outgridvit_tpu_torch.models.layers import (
    BatchNorm,
    ConvStem,
    Dense,
    Downsample,
    DropPath,
)
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


def flax_path(torch_name: str) -> str:
    """'stages.0.1.outlook.dp1' -> 'stages_0_1/outlook/dp1' and
    'front.2.dp1' -> 'front_2/dp1', the module path the JAX model gives the
    same DropPath."""
    s = re.sub(r"^stages\.(\d+)\.(\d+)", r"stages_\1_\2", torch_name)
    return re.sub(r"^front\.(\d+)", r"front_\1", s).replace(".", "/")


class MaxOutNet(nn.Module):
    def __init__(self, num_classes: int, stages: Sequence[StageCfg],
                 in_ch: int = 3, stem_dim: int = 64, dpr_max: float = 0.1,
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
        dprs = iter(make_dpr(sum(s.depth for s in stages), dpr_max))
        self.stages = nn.ModuleList(
            nn.ModuleList(OutGridBlock(s.replace(drop_path=next(dprs)), dtype,
                                       use_kernels, device, outlook_mode,
                                       dwconv, xla, attn_nhwc)
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
                              MultiHeadSelfAttention)):
                m.path = flax_path(name)

    def forward(self, x, drop_masks: Optional[DropPathMasks] = None):
        """x: [B, H, W, in_ch] float -> logits [B, num_classes] fp32.

        In train mode BatchNorm uses (and updates) batch statistics, and
        drop-path draws its keep masks from ``drop_masks`` (required when any
        block's rate is nonzero)."""
        x = self.stem(x.to(self.dtype))
        if self.proj_in is not None:
            x = self.proj_in(x)
        for si, blocks in enumerate(self.stages):
            for block in blocks:
                x = checkpoint_block(block, self.remat, x, drop_masks)
            if si < len(self.downs):
                x = self.downs[si](x)
        x = self.head_norm(x).float().mean(dim=(1, 2))
        return self.classifier(x)
