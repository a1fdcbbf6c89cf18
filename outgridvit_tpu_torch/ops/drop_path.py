"""Stochastic depth (twin of ``outgridvit_tpu/ops/drop_path.py``) with the
keep mask passed in: ``jax.random`` bits cannot be reproduced in torch, so
the caller draws the mask (:class:`DropPathMasks`) and both frameworks can
be fed the same one."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor,
              rate: float) -> torch.Tensor:
    """x [B, ...] times ``keep_mask`` [B] (bool) scaled by 1/(1-rate), the
    scale formed in x.dtype as the JAX function forms it. The scale is a
    0-d host tensor, which a device op reads as a launch argument: no
    host-to-device copy, so a CUDA graph can capture the step."""
    if rate == 0.0:
        return x
    if keep_mask.shape != (x.shape[0],):
        raise ValueError(f"keep_mask must be [{x.shape[0]}]; got "
                         f"{tuple(keep_mask.shape)}")
    keep = 1.0 - rate
    scale = keep_mask.to(x.dtype) * torch.tensor(1.0 / keep, dtype=x.dtype)
    return x * scale.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


class DropPathMasks:
    """Keep masks for one train forward, by DropPath module path (the flax
    path, e.g. ``"stages_0_0/outlook/dp1"``): given as a mapping of [B] bool
    tensors, or drawn per call from a ``torch.Generator`` as Bernoulli(keep)
    per sample. Given a ``record`` list, the generator mode appends each
    call's ``(path, rate)`` to it: the order :func:`draw_drop_masks` needs
    to draw the same masks before the forward. ``get(..., again=True)``
    (a rematerialized block's recompute) returns the mask the forward got
    for that path: it draws and records nothing."""

    def __init__(self, masks: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 record: Optional[List[Tuple[str, float]]] = None):
        if (masks is None) == (generator is None):
            raise ValueError("give exactly one of masks and generator")
        self.masks, self.generator, self.record = masks, generator, record
        self.drawn: Dict[str, torch.Tensor] = {}

    def get(self, path: str, rate: float, batch: int, device,
            again: bool = False) -> torch.Tensor:
        if again:
            try:
                return self.drawn[path]
            except KeyError:
                raise KeyError(f"drop-path mask for '{path}' asked again "
                               "but never drawn") from None
        if self.masks is not None:
            try:
                mask = self.masks[path]
            except KeyError:
                raise KeyError(f"no drop-path mask for '{path}'") from None
            mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
        else:
            if self.record is not None:
                self.record.append((path, rate))
            u = torch.rand(batch, generator=self.generator,
                           device=self.generator.device)
            mask = (u < 1.0 - rate).to(device)
        self.drawn[path] = mask
        return mask


def draw_drop_masks(generator: torch.Generator,
                    order: Sequence[Tuple[str, float]],
                    batch: int) -> Dict[str, torch.Tensor]:
    """The keep masks, by path, that a forward calling its DropPaths in
    ``order`` (``(path, rate)`` pairs, as ``DropPathMasks(record=...)``
    records them) draws from ``generator``: the same draws in the same
    order, so bitwise the masks the forward would draw, on the generator's
    device."""
    masks: Dict[str, torch.Tensor] = {}
    for path, rate in order:
        if path in masks:
            raise ValueError(f"DropPath '{path}' is called twice in one "
                             "forward; its masks cannot be drawn by path")
        u = torch.rand(batch, generator=generator, device=generator.device)
        masks[path] = u < 1.0 - rate
    return masks
