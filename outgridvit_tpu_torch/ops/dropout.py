"""Dropout (flax ``nn.Dropout`` as the JAX modules call it) with its keep
mask passed in, and the keep masks of a train step computed on the device.

``dropout(x, keep, rate)`` is flax's ``select(mask, x / keep_prob, 0)``:
the division in x's dtype (``keep_prob`` rounded to it first, as JAX
rounds the weak-typed Python float), not a product with ``1 / keep_prob``,
which rounds differently in bf16. At a site (``models/layers.py:
apply_dropout``) rate 0 returns x and rate 1 zeros, as flax does without
drawing a mask.

Masks are element-wise over the whole tensor, one per dropout site, a site
being the flax module path of the ``nn.Dropout`` the JAX module creates
(``stages_0_0/outlook/attn/Dropout_0``; the index follows the path the JAX
module takes, so the port's modules name their sites as the JAX one would
on the same dispatch). ``jax.random`` bits cannot be reproduced in torch,
so a parity test hands both frameworks the same masks by path
(:class:`DropPathMasks`'s ``dropout`` mapping). In training they come from
:class:`HashedDropout`: a counter-based integer hash of (seed, step, site,
element index) computed on the device, with the step read from the train
state's device step. A step's masks are then a pure function of those
four: a CUDA graph of K steps draws what K eager steps draw, a resume what
an uninterrupted run draws, and a rematerialized block's recompute what its
forward drew; no element-sized mask is drawn on the host or copied from it.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
# odd multipliers below 2^31: a product with a 32-bit value stays below
# 2^63, so the int64 arithmetic is exact on every device
_MUL = (0x7FEB352D, 0x1B873593)


def dropout(x: torch.Tensor, keep_mask: torch.Tensor,
            rate: float) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in train mode on x with the bool keep mask
    ``keep_mask`` (x's shape), for 0 < rate < 1 (the caller,
    ``models/layers.py:apply_dropout``, returns x at rate 0 and zeros at
    rate 1): ``where(mask, x / keep, 0)`` in x's dtype, ``keep = 1 - rate``.
    The divisor is a 0-d host tensor, which a device op reads as a launch
    argument (no host-to-device copy)."""
    if keep_mask.shape != x.shape:
        raise ValueError(f"keep_mask must be {tuple(x.shape)}; got "
                         f"{tuple(keep_mask.shape)}")
    keep = torch.tensor(1.0 - rate, dtype=x.dtype)
    return torch.where(keep_mask, x / keep, 0.0)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply rounds) on int64
    values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 16)


def site_key(path: str) -> int:
    """The 32-bit key of a dropout site's path."""
    return zlib.crc32(path.encode())


class HashedDropout:
    """Keep masks on the device from (``seed``, the step, the site's path,
    the element's flat index): ``mix(index ^ key) < keep * 2^32``, the key
    mixed from the seed, the site and ``step`` (a 0-d integer tensor on the
    device, read when the mask is made: the train state's ``device_step``,
    which the train step advances in place). Given a ``record`` list, each
    mask appends ``(path, shape)`` to it.

    ``rows=(first, count)``: the tensors hold rows ``[first, first +
    count)`` of the global batch (a data rank's, ``parallel/mesh.py``), the
    batch leading and outermost (``[B * grids, ...]`` grid tensors
    included), so an element's global flat index is its local one plus
    ``first`` times the elements a row: the rank draws the single device's
    masks of its rows."""

    def __init__(self, seed: int, step: torch.Tensor,
                 record: Optional[List[Tuple[str, tuple]]] = None,
                 rows: Optional[Tuple[int, int]] = None):
        self.seed, self.step, self.record = int(seed), step, record
        self.rows = rows

    def key(self, path: str) -> torch.Tensor:
        """The site's key at the current step, a 0-d int64 device tensor."""
        k = _mix((self.step.to(torch.int64) & _M32) ^ site_key(path))
        k = _mix(k ^ (self.seed & _M32))
        return _mix(k ^ ((self.seed >> 32) & _M32))

    def keep(self, path: str, rate: float, shape, device) -> torch.Tensor:
        if self.record is not None:
            self.record.append((path, tuple(shape)))
        n = 1
        for d in shape:
            n *= int(d)
        k = self.key(path).to(device)
        first = 0
        if self.rows is not None:
            lead, count = int(shape[0]), self.rows[1]
            if lead % count:
                raise ValueError(f"dropout '{path}' {tuple(shape)}: the "
                                 f"leading axis is not {count} batch rows")
            first = self.rows[0] * (n // count)
        h = _mix(torch.arange(first, first + n, dtype=torch.int64,
                              device=device) ^ k)
        return (h < round((1.0 - rate) * 2.0 ** 32)).reshape(shape)


def dropout_keep(source, path: str, rate: float, shape,
                 device) -> torch.Tensor:
    """The keep mask of site ``path`` from ``source``: a mapping of masks
    by path (moved to ``device``) or a :class:`HashedDropout`."""
    if isinstance(source, HashedDropout):
        return source.keep(path, rate, shape, device)
    try:
        mask = source[path]
    except KeyError:
        raise KeyError(f"no dropout mask for '{path}'") from None
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if tuple(mask.shape) != tuple(shape):
        raise ValueError(f"dropout mask for '{path}' is "
                         f"{tuple(mask.shape)}; the site is {tuple(shape)}")
    return mask

