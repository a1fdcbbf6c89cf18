"""Input normalization (twin of ``outgridvit_tpu/ops/augment.py:
normalize_batch``). The augmentation recipe itself is ported with training."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_batch(x: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float]) -> torch.Tensor:
    """uint8/int NHWC -> normalized float32."""
    xf = x.to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (xf - m) / s
