"""MaxViT-style dilated grid and contiguous window partitioning, NHWC
(twin of ``outgridvit_tpu/ops/grid.py``).

Grid group (gy, gx) holds the pixels (i*g+gy, j*g+gx): each group is a
dilated view of the whole map. Window (by, bx) holds the w x w block of
pixels (by*w + i, bx*w + j).
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


def window_partition(x: torch.Tensor,
                     window_size: int) -> Tuple[torch.Tensor, tuple]:
    """[B, H, W, C] -> ([B*nW, w, w, C], meta): contiguous (non-dilated)
    w x w windows, row-major over the map, the MaxViT block attention's
    counterpart of :func:`grid_partition`."""
    if x.dim() != 4:
        raise ValueError(f"Expected x.ndim==4 (BHWC). Got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    w = window_size
    if w <= 0:
        raise ValueError("window_size must be > 0")
    if H % w or W % w:
        raise ValueError(
            f"H and W must be divisible by window_size. Got H={H}, W={W}, "
            f"w={w}")
    Hb, Wb = H // w, W // w
    wins = (x.reshape(B, Hb, w, Wb, w, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(B * Hb * Wb, w, w, C))
    return wins, (B, H, W, C, w)


def window_unpartition(wins: torch.Tensor, meta: tuple) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    B, H, W, C, w = meta
    Hb, Wb = H // w, W // w
    return (wins.reshape(B, Hb, Wb, w, w, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(B, H, W, C))
