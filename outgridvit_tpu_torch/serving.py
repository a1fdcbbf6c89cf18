"""Inference surface (twin of ``outgridvit_tpu/serving.py``: ``Predictor``
and ``build_predictor``).

A fixed-batch classifier: raw uint8 NHWC in, normalized on the device,
``(labels int32, probs float32)`` out. A ragged request is zero-padded to
``batch_size`` and the padding stripped, so every forward runs at one
shape, as the JAX predictor's one compiled program does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from outgridvit_tpu_torch.models import MaxOutNet, build_model
from outgridvit_tpu_torch.ops.augment import normalize_batch


@dataclass(frozen=True)
class Predictor:
    """``predict`` accepts 1..batch_size uint8 images [n, H, W, 3] (or one
    [H, W, 3]) and returns argmax labels [n] and softmax probs [n, classes]."""

    model: MaxOutNet
    batch_size: int
    img_size: int
    num_classes: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]

    @property
    def device(self) -> torch.device:
        return self.model.classifier.weight.device

    def predict(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        images = np.asarray(images)
        if not np.issubdtype(images.dtype, np.integer):
            raise ValueError(
                f"images must be raw uint8 pixels (got {images.dtype}); "
                "normalization happens on the device — pre-normalized floats "
                "would truncate to zeros")
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"got {n} images > compiled batch size {self.batch_size}; "
                f"chunk the request or build with a larger batch_size")
        if images.shape[1:3] != (self.img_size, self.img_size):
            raise ValueError(
                f"expected {self.img_size}x{self.img_size} images, got "
                f"{images.shape[1:3]}")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n,) + images.shape[1:],
                           dtype=images.dtype)
            images = np.concatenate([images, pad], axis=0)
        x = torch.from_numpy(images.astype(np.uint8)).to(self.device)
        with torch.inference_mode():
            logits = self.model(normalize_batch(x, self.mean, self.std))
            probs = torch.softmax(logits.float(), dim=-1)
            labels = probs.argmax(dim=-1).to(torch.int32)
        return labels.cpu().numpy()[:n], probs.cpu().numpy()[:n]

    def predict_many(self, images: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Any request size: full chunks back to back, the ragged tail padded
        like :meth:`predict`."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        out_l, out_p = [], []
        for i in range(0, len(images), self.batch_size):
            lab, prob = self.predict(images[i:i + self.batch_size])
            out_l.append(lab)
            out_p.append(prob)
        return np.concatenate(out_l), np.concatenate(out_p)


def build_predictor(
    model_cfg: Mapping[str, Any],
    variables: Optional[Mapping[str, Any]] = None,
    batch_size: int = 64,
    img_size: int = 32,
    mean: Sequence[float] = (0.5071, 0.4867, 0.4408),
    std: Sequence[float] = (0.2675, 0.2565, 0.2761),
    dtype=torch.bfloat16,
    use_kernels: Optional[bool] = None,
    device="cuda",
    seed: int = 0,
) -> Predictor:
    """Build a predictor from a model config and either the JAX package's
    ``variables`` (numpy tree, loaded by
    :func:`~outgridvit_tpu_torch.utils.port_jax.load_flax_variables`) or
    random weights from ``seed``. ``use_kernels`` as in
    :func:`~outgridvit_tpu_torch.models.build_model`."""
    model = build_model(model_cfg, dtype=dtype, use_kernels=use_kernels,
                        device=device, seed=seed)
    if variables is not None:
        from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

        load_flax_variables(model, variables)
    return Predictor(model=model, batch_size=batch_size, img_size=img_size,
                     num_classes=int(model_cfg.get("num_classes", 100)),
                     mean=tuple(mean), std=tuple(std))
