"""Mixup / CutMix (twin of ``outgridvit_tpu/training/mixing.py``), with the
randomness split from the math: :func:`sample_mix_draws` draws from a
``torch.Generator``, :func:`apply_mix_draws` is deterministic given the
draws and matches the JAX function on the same draws.

- with probability ``prob`` mix at all, else return one-hot targets;
- if both alphas > 0, choose cutmix or mixup 50/50;
- mixup: convex blend with lam ~ Beta(a, a);
- cutmix: a box of side ``W*sqrt(1-lam)`` centred on a uniform pixel,
  clipped to the image; lam corrected by the swapped area.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class MixDraws(NamedTuple):
    """Every random draw one mixing application consumes."""

    perm: torch.Tensor        # [B] int, partner permutation
    lam_m: torch.Tensor       # scalar f32, mixup blend factor
    lam_c0: torch.Tensor      # scalar f32, cutmix Beta draw (pre-correction)
    cx: torch.Tensor          # scalar int, cutmix box centre x
    cy: torch.Tensor          # scalar int, cutmix box centre y
    use_cutmix: torch.Tensor  # scalar bool
    apply: torch.Tensor       # scalar bool, mix at all this step


def _gamma(alpha: float, generator: torch.Generator) -> float:
    """One Gamma(alpha, 1) draw (Marsaglia and Tsang, with the alpha < 1
    boost) from ``generator``."""
    boost = 1.0
    if alpha < 1.0:
        boost = float(torch.rand((), generator=generator)) ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = float(torch.rand((), generator=generator))
        if math.log(max(u, 1e-300)) < 0.5 * z * z + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(a: float, generator: torch.Generator) -> float:
    x, y = _gamma(a, generator), _gamma(a, generator)
    return x / (x + y)


def sample_mix_draws(generator: torch.Generator, batch: int, height: int,
                     width: int, mixup_alpha: float = 0.0,
                     cutmix_alpha: float = 0.0, prob: float = 1.0,
                     device=None) -> MixDraws:
    """Draw what :func:`apply_mix_draws` consumes, with the distributions of
    the JAX ``sample_mix_draws`` (the bits differ)."""
    g = generator
    perm = torch.randperm(batch, generator=g, device=g.device)
    lam_m = _beta(mixup_alpha, g) if mixup_alpha > 0.0 else 1.0
    lam_c0 = _beta(cutmix_alpha, g) if cutmix_alpha > 0.0 else 1.0
    cx = int(torch.randint(0, width, (), generator=g))
    cy = int(torch.randint(0, height, (), generator=g))
    if cutmix_alpha > 0.0 and mixup_alpha > 0.0:
        use_cutmix = float(torch.rand((), generator=g)) < 0.5
    else:
        use_cutmix = cutmix_alpha > 0.0
    apply = float(torch.rand((), generator=g)) < prob if prob < 1.0 else True

    def t(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return MixDraws(perm.to(device), t(lam_m, torch.float32),
                    t(lam_c0, torch.float32), t(cx, torch.int32),
                    t(cy, torch.int32), t(use_cutmix, torch.bool),
                    t(apply, torch.bool))


def cutmix_box(lam_c0, cx, cy, height: int, width: int):
    """Clipped cutmix box (x1, x2, y1, y2) and the area-corrected lambda."""
    side = torch.sqrt(1.0 - lam_c0.to(torch.float32))
    cut_w = (width * side).to(torch.int32)
    cut_h = (height * side).to(torch.int32)
    x1b = torch.clamp(cx - cut_w // 2, min=0)
    x2b = torch.clamp(cx + cut_w // 2, max=width)
    y1b = torch.clamp(cy - cut_h // 2, min=0)
    y2b = torch.clamp(cy + cut_h // 2, max=height)
    area = (x2b - x1b) * (y2b - y1b)
    lam_c = 1.0 - area.to(torch.float32) / float(width * height)
    return (x1b, x2b, y1b, y2b), lam_c


def apply_mix_draws(images: torch.Tensor, targets: torch.Tensor,
                    draws: MixDraws, num_classes: int):
    """(images [B, H, W, C], int targets [B]) -> (mixed images, soft targets
    [B, num_classes] fp32), given concrete draws."""
    B, H, W, _ = images.shape
    y1 = torch.nn.functional.one_hot(targets.long(), num_classes).float()
    perm = draws.perm.long()
    x2img = images[perm]
    y2 = y1[perm]
    lam_m = draws.lam_m.to(torch.float32)
    x_mix = (images * lam_m.to(images.dtype)
             + x2img * (1.0 - lam_m).to(images.dtype))
    (x1b, x2b, y1b, y2b), lam_c = cutmix_box(draws.lam_c0, draws.cx,
                                             draws.cy, H, W)
    col = torch.arange(W, device=images.device)[None, :]
    row = torch.arange(H, device=images.device)[:, None]
    box = (col >= x1b) & (col < x2b) & (row >= y1b) & (row < y2b)  # [H, W]
    x_cut = torch.where(box[None, :, :, None], x2img, images)
    x_aug = torch.where(draws.use_cutmix, x_cut, x_mix)
    lam = torch.where(draws.use_cutmix, lam_c, lam_m)
    images_out = torch.where(draws.apply, x_aug, images)
    targets_soft = torch.where(draws.apply, lam * y1 + (1.0 - lam) * y2, y1)
    return images_out, targets_soft
