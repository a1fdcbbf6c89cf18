"""Losses, always computed in fp32 (twin of ``outgridvit_tpu/training/
losses.py``)."""

from __future__ import annotations

import torch


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets_soft: torch.Tensor) -> torch.Tensor:
    """-(t * log_softmax(logits)).sum(-1).mean()."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets_soft.float() * logp).sum(-1).mean()


def cross_entropy_smoothed(logits: torch.Tensor, labels: torch.Tensor,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """(1-s) * NLL + s * mean over classes of -log p, averaged over the
    batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(-1)
        loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    else:
        loss = nll
    return loss.mean()
