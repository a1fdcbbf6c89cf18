"""MaxViT-style dilated grid partitioning, NHWC (twin of
``outgridvit_tpu/ops/grid.py``).

Grid group (gy, gx) holds the pixels (i*g+gy, j*g+gx): each group is a
dilated view of the whole map.
"""

from __future__ import annotations

from typing import Tuple

import torch


def grid_partition(x: torch.Tensor, grid_size: int) -> Tuple[torch.Tensor, tuple]:
    """[B, H, W, C] -> ([B*g*g, H/g, W/g, C], meta)."""
    if x.dim() != 4:
        raise ValueError(f"Expected x.ndim==4 (BHWC). Got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    g = grid_size
    if g <= 0:
        raise ValueError("grid_size must be > 0")
    if H % g or W % g:
        raise ValueError(
            f"H and W must be divisible by grid_size. Got H={H}, W={W}, g={g}")
    Hg, Wg = H // g, W // g
    grids = (x.reshape(B, Hg, g, Wg, g, C).permute(0, 2, 4, 1, 3, 5)
             .reshape(B * g * g, Hg, Wg, C))
    return grids, (B, H, W, C, g)


def grid_unpartition(grids: torch.Tensor, meta: tuple) -> torch.Tensor:
    """Inverse of :func:`grid_partition`."""
    B, H, W, C, g = meta
    Hg, Wg = H // g, W // g
    if tuple(grids.shape) != (B * g * g, Hg, Wg, C):
        raise ValueError(
            f"grids shape mismatch. Expected {(B * g * g, Hg, Wg, C)} "
            f"got {tuple(grids.shape)}")
    return (grids.reshape(B, g, g, Hg, Wg, C).permute(0, 3, 1, 4, 2, 5)
            .reshape(B, H, W, C))
