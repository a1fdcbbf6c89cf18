"""The on-device train augmentation recipe (twin of the apply side of
``outgridvit_tpu/ops/augment.py``): RandomCrop(pad) and horizontal flip as
one composed nearest-neighbour warp, RandAugment over the 14-op space,
Normalize and RandomErasing, on a raw uint8 NHWC batch.

The randomness is split from the math as in the JAX package:
:func:`sample_augment_draws` draws every random quantity from a
``torch.Generator``; :func:`apply_augment_draws` is deterministic given the
draws, and on the same draws it is bit-exact against the JAX
``apply_augment_draws`` on the uint8 path (PIL's integer conventions: 16.16
fixed-point affine coordinates, truncating enhance blends, the integer
equalize and autocontrast luts). The JAX package computes its gathers as
one-hot contractions for the TPU; here they are plain integer gathers,
which give the same pixels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# op ids follow outgridvit_tpu/ops/augment.py:_OP_NAMES
_OP_NAMES = (
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize", "Solarize",
    "AutoContrast", "Equalize",
)
_OP = {n: i for i, n in enumerate(_OP_NAMES)}
_NUM_BINS = 31
# RandomErasing's box: area fraction, aspect ratio range, tries per image
# (the JAX sampler's defaults)
_ERASE_SCALE, _ERASE_RATIO, _ERASE_TRIES = (0.02, 0.20), (0.3, 3.3), 10


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Everything the device needs to run the train recipe on raw uint8."""

    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    crop_pad: int
    ra_num_ops: int = 2
    ra_magnitude: int = 7
    random_erasing_p: float = 0.25
    hflip_p: float = 0.5
    enable_augs: bool = True


class AugmentDraws(NamedTuple):
    """Concrete per-image randomness for one train batch (fields None when
    the stage is disabled); same fields as the JAX ``AugmentDraws``."""

    crop_top: Optional[torch.Tensor]     # [B] f32 in [0, 2*pad]
    crop_left: Optional[torch.Tensor]    # [B] f32
    flip: Optional[torch.Tensor]         # [B] bool
    op_ids: Optional[torch.Tensor]       # [num_ops, B] int into the op space
    signs: Optional[torch.Tensor]        # [num_ops, B] f32 in {-1., +1.}
    er_apply: Optional[torch.Tensor]     # [B] bool (p-gate AND a valid box)
    er_top: Optional[torch.Tensor]       # [B] int
    er_left: Optional[torch.Tensor]      # [B] int
    er_h: Optional[torch.Tensor]         # [B] int
    er_w: Optional[torch.Tensor]         # [B] int
    er_noise: Optional[torch.Tensor]     # [B, H, W, C] f32 N(0, 1)


# host constants kept on each device they were used on, by (values, dtype,
# device): a step makes no host-to-device copy once it has run there, so a
# CUDA graph can capture it
_DEVICE_CONSTS: Dict[tuple, torch.Tensor] = {}


def device_const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (a sequence or numpy array) as a tensor on ``device``,
    made once per (values, dtype, device)."""
    device = torch.device(device)
    key = (tuple(np.asarray(values).ravel().tolist()), np.shape(values),
           dtype, device)
    t = _DEVICE_CONSTS.get(key)
    if t is None:
        t = _DEVICE_CONSTS[key] = torch.as_tensor(
            np.asarray(values), dtype=dtype, device=device)
    return t


def normalize_batch(x: torch.Tensor, mean: Sequence[float],
                    std: Sequence[float]) -> torch.Tensor:
    """uint8/int NHWC -> normalized float32; ``mean`` and ``std`` are
    sequences (kept on x's device, :func:`device_const`) or fp32 tensors on
    x's device (then used as they are)."""
    xf = x.to(torch.float32) / 255.0
    m, s = (v if isinstance(v, torch.Tensor)
            else device_const(v, torch.float32, x.device)
            for v in (mean, std))
    return (xf - m) / s


# ------------------------------------------------------------- geometric

def _fix16(v: torch.Tensor) -> torch.Tensor:
    """PIL's FIX macro: C cast (truncate toward zero) of v*65536 + 0.5."""
    return torch.trunc(v * 65536.0 + 0.5).to(torch.int32)


def _affine_warp_nearest(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] int32; mat [B, 6] output->input (a, b, c, d, e, f) as
    PIL AFFINE, NEAREST, zero fill: per-row start
    FIX(c + a*0.5 + b*(y+0.5)), stepping by FIX(a) per output x, pixel =
    coord >> 16, all in fp32 / int32 as the JAX function."""
    B, H, W, C = x.shape
    ys = torch.arange(H, dtype=torch.float32, device=x.device) + 0.5
    a, b, c, d, e, f = (mat[:, i, None] for i in range(6))
    row_xx = _fix16(c + a * 0.5 + b * ys[None, :])
    row_yy = _fix16(f + d * 0.5 + e * ys[None, :])
    xs = torch.arange(W, dtype=torch.int32, device=x.device)[None, None, :]
    xi = (row_xx[:, :, None] + _fix16(a)[:, :, None] * xs) >> 16  # [B,H,W]
    yi = (row_yy[:, :, None] + _fix16(d)[:, :, None] * xs) >> 16
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, H * W, 1)
    out = x.reshape(B, H * W, C).gather(1, idx.long().expand(-1, -1, C))
    return (out * valid.reshape(B, H * W, 1).to(x.dtype)).reshape(B, H, W, C)


def _geo_matrices(op_id, v, H: int, W: int):
    """Per-image affine matrix of the selected geometric op; identity for
    the color and identity ops."""
    one = torch.ones_like(v)
    zero = torch.zeros_like(v)

    def where(name, cols, mat):
        return torch.where((op_id == _OP[name])[:, None],
                           torch.stack(cols, 1), mat)

    mat = torch.stack([one, zero, zero, zero, one, zero], 1)
    mat = where("ShearX", [one, v, zero, zero, one, zero], mat)
    mat = where("ShearY", [one, zero, zero, v, one, zero], mat)
    mat = where("TranslateX", [one, zero, v, zero, one, zero], mat)
    mat = where("TranslateY", [one, zero, zero, zero, one, v], mat)
    ang = v * (math.pi / 180.0)
    ca, sa = torch.cos(ang), torch.sin(ang)
    cx, cy = W / 2.0, H / 2.0
    return where("Rotate", [ca, -sa, cx - ca * cx + sa * cy,
                            sa, ca, cy - sa * cx - ca * cy], mat)


# ------------------------------------------------------------- color ops

def _gray_l(x):
    """PIL convert('L'): (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    v = x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000
    return v >> 16  # int32 [B, H, W]


def _blend_trunc(degenerate, x, f):
    """PIL ImageEnhance blend: floor(deg + f*(x-deg)) clipped to [0, 255]."""
    a = degenerate + f[:, None, None, None] * (x.to(torch.float32)
                                               - degenerate)
    return torch.clamp(torch.floor(a), 0, 255).to(torch.int32)


def _brightness(x, f):
    return torch.clamp(torch.floor(x.to(torch.float32)
                                   * f[:, None, None, None]),
                       0, 255).to(torch.int32)


def _color(x, f):
    return _blend_trunc(_gray_l(x)[..., None].to(torch.float32), x, f)


def _contrast(x, f):
    mean = torch.floor(_gray_l(x).to(torch.float32).mean((1, 2)) + 0.5)
    return _blend_trunc(mean[:, None, None, None], x, f)


def _sharpness(x, f):
    B, H, W, C = x.shape
    # the 3x3 smooth filter [1,1,1;1,5,1;1,1,1]/13 as nine shifted fp32
    # multiply-adds (no conv: cuDNN would run an fp32 conv in TF32). Any
    # summation order gives the same pixels after the round, since
    # (integer)/13 is never within fp32 error of a half-integer.
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    k = torch.tensor([1, 1, 1, 1, 5, 1, 1, 1, 1], dtype=torch.float32) / 13.0
    sm = torch.zeros(B, H, W, C, dtype=torch.float32, device=x.device)
    for t in range(9):
        ky, kx = divmod(t, 3)
        sm = sm + xp[:, ky:ky + H, kx:kx + W] * float(k[t])
    sm = torch.clamp(torch.round(sm), 0, 255)
    # PIL's filtered degenerate keeps the original 1px border
    ri = torch.arange(H, device=x.device)[None, :, None, None]
    ci = torch.arange(W, device=x.device)[None, None, :, None]
    border = (ri == 0) | (ri == H - 1) | (ci == 0) | (ci == W - 1)
    sm = torch.where(border, x.to(torch.float32), sm)
    return _blend_trunc(sm, x, f)


def _posterize(x, bits):
    mask = ((0xFF << (8 - bits)) & 0xFF).to(torch.int32)
    return x & mask[:, None, None, None]


def _solarize(x, thresh):
    t = thresh[:, None, None, None]
    return torch.where(x < t, x, 255 - x)


def _autocontrast(x):
    """PIL's lut, in exact integer math: (i - lo) * 255 // (hi - lo)."""
    lo = x.amin((1, 2), keepdim=True)
    hi = x.amax((1, 2), keepdim=True)
    out = torch.clamp((x - lo) * 255 // torch.clamp(hi - lo, min=1), 0, 255)
    return torch.where(hi > lo, out, x)


def _equalize(x):
    """PIL ImageOps.equalize integer lut per image and channel."""
    B, H, W, C = x.shape
    px = x.permute(0, 3, 1, 2).reshape(B * C, H * W).long()
    hist = torch.zeros(B * C, 256, dtype=torch.long, device=x.device)
    hist.scatter_add_(1, px, torch.ones_like(px))
    nnz = (hist > 0).sum(-1)
    bins = torch.arange(256, device=x.device)
    last_nz_idx = torch.where(hist > 0, bins, -1).amax(-1, keepdim=True)
    last_nz = hist.gather(1, last_nz_idx)[:, 0]
    step = (hist.sum(-1) - last_nz) // 255
    cum = torch.cumsum(hist, -1) - hist
    lut = torch.clamp((step[:, None] // 2 + cum)
                      // torch.clamp(step, min=1)[:, None], 0, 255)
    out = lut.gather(1, px)
    out = torch.where(((nnz <= 1) | (step == 0))[:, None], px, out)
    return out.to(x.dtype).reshape(B, C, H, W).permute(0, 2, 3, 1)


# ------------------------------------------------------------- RandAugment

def _ra_tables(image_size: int, magnitude: int):
    """Per-op magnitude at the chosen bin and whether the op is signed: the
    host RandAugment space of ``outgridvit_tpu/data/transforms.py:
    _ra_space``."""
    lin = np.linspace
    n = _NUM_BINS
    space = {
        "ShearX": (lin(0.0, 0.3, n), True),
        "ShearY": (lin(0.0, 0.3, n), True),
        "TranslateX": (lin(0.0, 150.0 / 331.0 * image_size, n), True),
        "TranslateY": (lin(0.0, 150.0 / 331.0 * image_size, n), True),
        "Rotate": (lin(0.0, 30.0, n), True),
        "Brightness": (lin(0.0, 0.9, n), True),
        "Color": (lin(0.0, 0.9, n), True),
        "Contrast": (lin(0.0, 0.9, n), True),
        "Sharpness": (lin(0.0, 0.9, n), True),
        "Posterize": (8 - (np.arange(n) / ((n - 1) / 4)).round(), False),
        "Solarize": (lin(255.0, 0.0, n), False),
    }
    mags = [float(space[k][0][magnitude]) if k in space else 0.0
            for k in _OP_NAMES]
    signed = [bool(space[k][1]) if k in space else False for k in _OP_NAMES]
    return np.asarray(mags, np.float32), np.asarray(signed, np.bool_)


def rand_augment_apply(x, op_ids, signs, magnitude: int = 7):
    """Deterministic RandAugment given the draws: ``op_ids`` [num_ops, B]
    into the 14-op space, ``signs`` [num_ops, B] in {-1., +1.}."""
    B, H, W, C = x.shape
    mags, signed = _ra_tables(W, magnitude)
    mags = device_const(mags, torch.float32, x.device)
    signed = device_const(signed, torch.bool, x.device)
    for s in range(op_ids.shape[0]):
        op_id = op_ids[s].long()
        v = mags[op_id] * torch.where(signed[op_id], signs[s].float(),
                                      torch.ones_like(signs[s].float()))
        # one warp handles every geometric op (identity matrix otherwise)
        x = _affine_warp_nearest(x, _geo_matrices(op_id, v, H, W))
        f = 1.0 + v
        for name, out in (
            ("Brightness", lambda: _brightness(x, f)),
            ("Color", lambda: _color(x, f)),
            ("Contrast", lambda: _contrast(x, f)),
            ("Sharpness", lambda: _sharpness(x, f)),
            ("Posterize", lambda: _posterize(x, v.to(torch.int32))),
            ("Solarize", lambda: _solarize(x, v.to(torch.int32))),
            ("AutoContrast", lambda: _autocontrast(x)),
            ("Equalize", lambda: _equalize(x)),
        ):
            x = torch.where((op_id == _OP[name])[:, None, None, None], out(),
                            x)
    return x


# ------------------------------------------------------------- full recipe

def apply_augment_draws(images_u8: torch.Tensor, draws: AugmentDraws,
                        cfg: AugmentConfig) -> torch.Tensor:
    """The train recipe on raw uint8 NHWC given concrete draws ->
    normalized float32."""
    x = images_u8.to(torch.int32)
    B, H, W, _ = x.shape
    if cfg.enable_augs:
        one = torch.ones(B, dtype=torch.float32, device=x.device)
        zero = torch.zeros_like(one)
        p = float(cfg.crop_pad)
        # crop then flip as ONE warp: the JAX compose(crop, flip) matrix,
        # whose terms are small integers, so this form is exact
        flip = draws.flip.to(x.device)
        mat = torch.stack([torch.where(flip, -1.0, 1.0), zero,
                           torch.where(flip, float(W), 0.0)
                           + (draws.crop_left.to(x.device) - p),
                           zero, one, draws.crop_top.to(x.device) - p], 1)
        x = _affine_warp_nearest(x, mat)
        if cfg.ra_num_ops > 0:
            x = rand_augment_apply(x, draws.op_ids.to(x.device),
                                   draws.signs.to(x.device), cfg.ra_magnitude)
    xf = normalize_batch(x, cfg.mean, cfg.std)
    if cfg.enable_augs and cfg.random_erasing_p > 0:
        ri = torch.arange(H, device=x.device)[None, :, None]
        ci = torch.arange(W, device=x.device)[None, None, :]
        top, left = (draws.er_top.to(x.device)[:, None, None],
                     draws.er_left.to(x.device)[:, None, None])
        eh = draws.er_h.to(x.device)[:, None, None]
        ew = draws.er_w.to(x.device)[:, None, None]
        inside = ((ri >= top) & (ri < top + eh) & (ci >= left)
                  & (ci < left + ew)
                  & draws.er_apply.to(x.device)[:, None, None])
        xf = torch.where(inside[..., None],
                         draws.er_noise.to(x.device, torch.float32), xf)
    return xf


def sample_augment_draws(generator: torch.Generator,
                         shape: Tuple[int, int, int, int],
                         cfg: AugmentConfig, device=None) -> AugmentDraws:
    """Draw every random quantity of the train recipe from ``generator``
    (on its device), with the distributions of the JAX
    ``sample_augment_draws``; the draws are returned on ``device``."""
    B, H, W, C = shape
    none = AugmentDraws(*([None] * 11))
    if not cfg.enable_augs:
        return none
    gd = generator.device
    kw = dict(generator=generator, device=gd)

    def uniform(*s):
        return torch.rand(*s, **kw)

    n = 2 * cfg.crop_pad + 1
    top = torch.randint(0, n, (B,), **kw).float()
    left = torch.randint(0, n, (B,), **kw).float()
    flip = uniform(B) < cfg.hflip_p
    op_ids = signs = None
    if cfg.ra_num_ops > 0:
        op_ids = torch.stack([torch.randint(0, len(_OP_NAMES), (B,), **kw)
                              for _ in range(cfg.ra_num_ops)])
        signs = torch.where(uniform(cfg.ra_num_ops, B) < 0.5, -1.0, 1.0)
    draws = none._replace(crop_top=top, crop_left=left, flip=flip,
                          op_ids=op_ids, signs=signs)
    if cfg.random_erasing_p > 0:
        apply = uniform(B) < cfg.random_erasing_p
        s0, s1 = _ERASE_SCALE
        area = (uniform(B, _ERASE_TRIES) * (s1 - s0) + s0) * (H * W)
        r0, r1 = (math.log(r) for r in _ERASE_RATIO)
        aspect = torch.exp(uniform(B, _ERASE_TRIES) * (r1 - r0) + r0)
        eh = torch.round(torch.sqrt(area * aspect)).to(torch.int32)
        ew = torch.round(torch.sqrt(area / aspect)).to(torch.int32)
        valid = (eh > 0) & (eh < H) & (ew > 0) & (ew < W)
        pick = valid.to(torch.int32).argmax(1, keepdim=True)
        eh = eh.gather(1, pick)[:, 0]
        ew = ew.gather(1, pick)[:, 0]
        er_top = torch.floor(uniform(B) * (H - eh + 1).float()).to(torch.int32)
        er_left = torch.floor(uniform(B) * (W - ew + 1).float()).to(
            torch.int32)
        draws = draws._replace(
            er_apply=apply & valid.any(1), er_top=er_top, er_left=er_left,
            er_h=eh, er_w=ew, er_noise=torch.randn(B, H, W, C, **kw))
    return AugmentDraws(*(None if t is None else t.to(device)
                          for t in draws))
