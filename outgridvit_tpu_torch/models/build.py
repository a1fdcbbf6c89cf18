"""Model construction from a config dict (twin of ``outgridvit_tpu/models/
build.py``), with the same ``model.type`` aliases."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from outgridvit_tpu_torch.models.layers import init_parameters
from outgridvit_tpu_torch.models.model_a import MaxOutNet
from outgridvit_tpu_torch.stage_config import DownsampleConfig, build_stages

_MODEL_A_ALIASES = ("a", "model_a", "maxout", "outgrid")
_MODEL_B_ALIASES = ("b", "model_b", "outlooker_front", "front")


def build_model(model_cfg: Mapping[str, Any], dtype=torch.float32,
                use_kernels: Optional[bool] = None, device="cuda",
                seed: int = 0) -> MaxOutNet:
    """Build a model in eval mode with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (skipped on the ``meta``
    device). Parameters are fp32; ``dtype`` is the compute dtype.

    ``use_kernels``: None runs the CUDA kernels iff ``device`` is CUDA;
    False runs their plain PyTorch versions; True on a non-CUDA device
    raises."""
    device = torch.device(device)
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    elif use_kernels and device.type != "cuda":
        raise ValueError(
            f"use_kernels=True needs a CUDA device; got {device}")
    model_type = str(model_cfg.get("type", "model_a")).lower()
    if model_type in _MODEL_B_ALIASES:
        raise NotImplementedError(
            "model_b (OutlookerFrontGridNet) is not ported yet: ROADMAP §1, "
            "'Model B and remat'")
    if model_type not in _MODEL_A_ALIASES:
        raise ValueError(
            f"Unknown model.type '{model_type}'. Use 'model_a' (MaxOutNet) or "
            f"'model_b' (OutlookerFrontGridNet)")
    model = MaxOutNet(
        num_classes=int(model_cfg.get("num_classes", 100)),
        stages=build_stages(model_cfg.get("stages", [])),
        in_ch=int(model_cfg.get("in_ch", 3)),
        stem_dim=int(model_cfg.get("stem_dim", 64)),
        down_cfg=DownsampleConfig.from_dict(model_cfg.get("downsample", {})
                                            or {}),
        dtype=dtype, use_kernels=use_kernels, device=device)
    if device.type != "meta":
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
