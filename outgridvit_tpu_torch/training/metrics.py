"""Accuracy metrics (twin of ``outgridvit_tpu/training/metrics.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def accuracy_topk(logits: torch.Tensor, targets: torch.Tensor,
                  ks: Sequence[int] = (1, 3, 5)) -> Dict[int, torch.Tensor]:
    """{k: percent of rows whose target is in the top k} as fp32 scalars.
    Soft targets [B, K] count by their argmax."""
    if targets.dim() == 2:
        targets = targets.argmax(-1)
    num_classes = logits.shape[-1]
    max_k = min(max(ks), num_classes)
    pred = logits.topk(max_k, dim=-1).indices
    correct = pred == targets[:, None].to(pred.dtype)
    return {k: 100.0 * correct[:, :min(k, num_classes)].any(-1).float().mean()
            for k in ks}
