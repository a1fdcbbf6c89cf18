"""Typed configuration dataclasses (the port's own copy of
``outgridvit_tpu/stage_config.py``; a test holds the two schemas, field
for field and default for default, equal).

Schema-compatible with the reference configs so the same YAML files load
unchanged (reference: `src/stage_config.py:4-34`, `src/model/mbc_conv.py:32-38`,
`src/model/grid_attention.py:12-30`, `src/model/downsampling.py:21-25`).

One deliberate extension over the reference: `num_heads=0` / `outlook_heads=0`
are first-class and mean "skip that branch" — the reference's ablation notebooks
needed a hacked block variant for this (see SURVEY.md §2.6 ablation note).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Mapping


def _filter_kwargs(cls, cfg: Mapping[str, Any]) -> dict:
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in cfg.items() if k in names}


@dataclass
class StageCfg:
    """All per-stage hyperparameters for one model stage."""

    # core dims
    dim: int
    depth: int

    # grid attention (num_heads == 0 disables the grid-attention branch)
    num_heads: int
    grid_size: int
    window_size: int = 8  # kept for config compatibility; unused in grid mode

    # outlooker (outlook_heads == 0 disables the outlooker branch)
    outlook_heads: int = 6
    outlook_kernel: int = 3
    outlook_mlp_ratio: float = 2.0

    # MBConv
    mbconv_expand_ratio: float = 4.0
    mbconv_se_ratio: float = 0.25
    mbconv_act: str = "silu"
    use_bn: bool = True

    # drops
    attn_drop: float = 0.0
    proj_drop: float = 0.0
    ffn_drop: float = 0.0
    drop_path: float = 0.0

    # channel MLP (applies over last dim of NHWC)
    mlp_ratio: float = 4.0
    mlp_act: str = "gelu"

    # ablation switch: disable the MBConv branch (reference "plain" ablation)
    use_mbconv: bool = True

    @classmethod
    def from_dict(cls, cfg: Mapping[str, Any]) -> "StageCfg":
        return cls(**_filter_kwargs(cls, cfg))

    def replace(self, **kw) -> "StageCfg":
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(kw)
        return StageCfg(**d)


@dataclass(frozen=True)
class MBConvConfig:
    expand_ratio: float = 4.0
    se_ratio: float = 0.25
    act: str = "silu"
    use_bn: bool = True
    drop_path: float = 0.0


@dataclass(frozen=True)
class AttentionConfig:
    dim: int
    num_heads: int
    qkv_bias: bool = True
    attn_drop: float = 0.0
    proj_drop: float = 0.0


@dataclass(frozen=True)
class GridAttentionConfig:
    dim: int
    num_heads: int
    grid_size: int
    mode: str = "grid"
    window_size: int = 1
    qkv_bias: bool = True
    attn_drop: float = 0.0
    proj_drop: float = 0.0


@dataclass(frozen=True)
class DownsampleConfig:
    kind: str = "conv"  # "conv" (3x3 s2) or "pool" (avgpool 2x2 + 1x1)
    act: str = "silu"
    use_bn: bool = True

    @classmethod
    def from_dict(cls, cfg: Mapping[str, Any]) -> "DownsampleConfig":
        return cls(**_filter_kwargs(cls, cfg))


def build_stages(stage_cfgs: list) -> list:
    """YAML stage list -> [StageCfg], mirroring the reference train-CLI builder
    (`scripts/train.py:29-30`)."""
    stages = [StageCfg.from_dict(c) for c in stage_cfgs]
    if not stages:
        raise ValueError("model.stages must have at least one stage config")
    return stages


def make_dpr(total_blocks: int, dpr_max: float) -> list:
    """Linear 0 -> dpr_max stochastic-depth schedule (reference
    `src/model/stem_head.py:17-20`)."""
    if total_blocks <= 1:
        return [dpr_max]
    return [dpr_max * i / (total_blocks - 1) for i in range(total_blocks)]
