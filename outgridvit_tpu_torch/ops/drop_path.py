"""Stochastic depth (twin of ``outgridvit_tpu/ops/drop_path.py``) with the
keep mask passed in: ``jax.random`` bits cannot be reproduced in torch, so
the caller draws the mask (:class:`DropPathMasks`) and both frameworks can
be fed the same one."""

from __future__ import annotations

from typing import Mapping, Optional

import torch


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor,
              rate: float) -> torch.Tensor:
    """x [B, ...] times ``keep_mask`` [B] (bool) scaled by 1/(1-rate), the
    scale formed in x.dtype as the JAX function forms it."""
    if rate == 0.0:
        return x
    if keep_mask.shape != (x.shape[0],):
        raise ValueError(f"keep_mask must be [{x.shape[0]}]; got "
                         f"{tuple(keep_mask.shape)}")
    keep = 1.0 - rate
    scale = keep_mask.to(x.dtype) * torch.tensor(1.0 / keep, dtype=x.dtype,
                                                 device=x.device)
    return x * scale.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


class DropPathMasks:
    """Keep masks for one train forward, by DropPath module path (the flax
    path, e.g. ``"stages_0_0/outlook/dp1"``): given as a mapping of [B] bool
    tensors, or drawn per call from a ``torch.Generator`` as Bernoulli(keep)
    per sample."""

    def __init__(self, masks: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        if (masks is None) == (generator is None):
            raise ValueError("give exactly one of masks and generator")
        self.masks, self.generator = masks, generator

    def get(self, path: str, rate: float, batch: int,
            device) -> torch.Tensor:
        if self.masks is not None:
            try:
                mask = self.masks[path]
            except KeyError:
                raise KeyError(f"no drop-path mask for '{path}'") from None
            return torch.as_tensor(mask, dtype=torch.bool, device=device)
        u = torch.rand(batch, generator=self.generator,
                       device=self.generator.device)
        return (u < 1.0 - rate).to(device)
