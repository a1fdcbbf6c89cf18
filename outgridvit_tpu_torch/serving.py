"""Inference surface (twin of ``outgridvit_tpu/serving.py``): ``Predictor``,
``build_predictor``, ``export_predictor`` and ``load_predictor``.

A fixed-batch classifier: raw uint8 NHWC in, normalized on the device,
``(labels int32, probs float32)`` out. A ragged request is zero-padded to
``batch_size`` and the padding stripped, so every forward runs at one
shape, as the JAX predictor's one compiled program does.

:func:`export_predictor` writes the classifier (normalize -> model ->
softmax -> argmax at the fixed batch shape) as a ``torch.export`` program,
weights included, behind a header of its own; :func:`load_predictor` runs
it without the model code or a checkpoint. With the kernels on, each
kernel launch is an ``ogvt::`` custom op in the program
(``ops/library.py``), so the artifact needs this package's op library, built
from ``csrc/`` at its first forward on the card.
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops.augment import normalize_batch

# the artifact's magic; the JAX package's is b"OGVT1", the port's
# checkpoints' b"OGVT"
ARTIFACT_MAGIC = b"OGVTPT1"


class Classifier(nn.Module):
    """uint8 [B, H, W, 3] -> (argmax labels int32 [B], softmax probs fp32
    [B, classes]): normalize (``mean`` / ``std`` as fp32 buffers on the
    model's device), the model's eval-mode forward, an fp32 softmax."""

    def __init__(self, model: nn.Module, mean: Sequence[float],
                 std: Sequence[float]):
        super().__init__()
        self.model = model
        device = next(model.parameters()).device
        self.register_buffer("mean", torch.tensor(
            tuple(mean), dtype=torch.float32, device=device))
        self.register_buffer("std", torch.tensor(
            tuple(std), dtype=torch.float32, device=device))

    def forward(self, images: torch.Tensor):
        logits = self.model(normalize_batch(images, self.mean, self.std))
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1).to(torch.int32), probs


class MeshClassifier(nn.Module):
    """A :class:`Classifier` on a mesh's data axis: each rank classifies
    its rows of the request and the labels and probabilities are gathered
    over the data group, so every rank returns the whole result."""

    def __init__(self, classifier: Classifier, mesh):
        super().__init__()
        self.classifier, self.mesh = classifier, mesh

    def forward(self, images: torch.Tensor):
        from outgridvit_tpu_torch.parallel.collectives import gather
        from outgridvit_tpu_torch.parallel.mesh import batch_sharding

        labels, probs = self.classifier(batch_sharding(self.mesh).local(
            images))
        return gather(labels, self.mesh.data), gather(probs, self.mesh.data)


@dataclass(frozen=True)
class Predictor:
    """``predict`` accepts 1..batch_size uint8 images [n, H, W, 3] (or one
    [H, W, 3]) and returns argmax labels [n] and softmax probs [n, classes].

    ``fn``: uint8 [batch_size, H, W, 3] on ``device`` -> (labels, probs), the
    live :class:`Classifier` or a loaded program's module. ``model`` is the
    live model (None for a loaded artifact); ``kernels`` whether the
    forward launches the CUDA kernels."""

    fn: Callable
    batch_size: int
    img_size: int
    num_classes: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    device: torch.device
    kernels: bool
    model: Optional[nn.Module] = None

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
            labels, probs = self.fn(x)
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
    checkpoint: Optional[str] = None,
    batch_size: int = 64,
    img_size: int = 32,
    mean: Sequence[float] = (0.5071, 0.4867, 0.4408),
    std: Sequence[float] = (0.2675, 0.2565, 0.2761),
    dtype=torch.bfloat16,
    use_kernels: Optional[bool] = None,
    device="cuda",
    seed: int = 0,
    dwconv: str = "xla",
    attn_nhwc: bool = False,
    mesh=None,
) -> Predictor:
    """Build a predictor from a model config and the JAX package's
    ``variables`` (numpy tree, loaded by
    :func:`~outgridvit_tpu_torch.utils.port_jax.load_flax_variables`), a
    ``checkpoint`` of the port (eval-only restore by
    :func:`~outgridvit_tpu_torch.training.checkpoints.load_model_variables`)
    or random weights from ``seed``; passing both ``variables`` and
    ``checkpoint`` raises. ``use_kernels``, ``dwconv`` and ``attn_nhwc`` as
    in :func:`~outgridvit_tpu_torch.models.build_model`.

    ``mesh``: a ``parallel.Mesh`` whose data axis splits the request batch
    (``batch_size`` must divide by it; the model on the rank's device is
    whole, as JAX replicates its parameters): every rank calls ``predict``
    with the same request and returns the whole result
    (:class:`MeshClassifier`)."""
    if variables is not None and checkpoint:
        raise ValueError(
            "pass either live variables or a checkpoint path, not both "
            "(the checkpoint would be silently ignored)")
    if mesh is not None:
        from outgridvit_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be the port's parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        if batch_size % mesh.data.size != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide over the data axis "
                f"({mesh.data.size} devices)")
    model = build_model(model_cfg, dtype=dtype, use_kernels=use_kernels,
                        device=device, seed=seed, dwconv=dwconv,
                        attn_nhwc=attn_nhwc)
    if variables is not None:
        from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

        load_flax_variables(model, variables)
    if checkpoint:
        from outgridvit_tpu_torch.training.checkpoints import (
            load_model_variables,
        )

        load_model_variables(checkpoint, model)
    model.eval()
    fn = Classifier(model, mean, std)
    if mesh is not None and mesh.data.size > 1:
        fn = MeshClassifier(fn, mesh)
    return Predictor(
        fn=fn, batch_size=batch_size,
        img_size=img_size, num_classes=int(model_cfg.get("num_classes", 100)),
        mean=tuple(mean), std=tuple(std),
        device=next(model.parameters()).device,
        kernels=any(getattr(m, "use_kernels", False)
                    for m in model.modules()),
        model=model)


def export_predictor(predictor: Predictor, path: str) -> None:
    """Write a live predictor as a standalone artifact: ``torch.export`` of
    its :class:`Classifier` at the fixed uint8 ``[batch_size, img_size,
    img_size, 3]`` shape, in eval mode under ``no_grad``, on the predictor's
    device, weights included. File: :data:`ARTIFACT_MAGIC`, the header's
    length (little-endian uint64), the header as JSON (``batch_size``,
    ``img_size``, ``num_classes``, ``mean``, ``std``, ``device``,
    ``kernels``, ``torch``), then the ``torch.export.save`` payload. With
    the kernels on, every launch is an ``ogvt::`` op node; a launch without
    an op cannot be traced and raises."""
    if predictor.model is None:
        raise ValueError("export_predictor needs a live predictor "
                         "(build_predictor), not a loaded artifact")
    if isinstance(predictor.fn, MeshClassifier):
        raise ValueError("export_predictor takes a single-device predictor "
                         "(build_predictor without a mesh of several data "
                         "ranks): the artifact holds no collectives")
    example = torch.zeros(
        (predictor.batch_size, predictor.img_size, predictor.img_size, 3),
        dtype=torch.uint8, device=predictor.device)
    predictor.fn.eval()
    with torch.no_grad():
        program = torch.export.export(predictor.fn, (example,))
    payload = io.BytesIO()
    torch.export.save(program, payload)
    header = json.dumps({
        "batch_size": predictor.batch_size, "img_size": predictor.img_size,
        "num_classes": predictor.num_classes, "mean": list(predictor.mean),
        "std": list(predictor.std), "device": predictor.device.type,
        "kernels": predictor.kernels, "torch": torch.__version__,
    }).encode("utf-8")
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        f.write(ARTIFACT_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(payload.getbuffer())


def _read_header(f, path: str) -> dict:
    head = f.read(len(ARTIFACT_MAGIC) + 8)
    if (len(head) < len(ARTIFACT_MAGIC) + 8
            or head[:len(ARTIFACT_MAGIC)] != ARTIFACT_MAGIC):
        raise ValueError(f"{path} is not an outgridvit_tpu_torch predictor "
                         "artifact")
    (n,) = struct.unpack("<Q", head[len(ARTIFACT_MAGIC):])
    try:
        return json.loads(f.read(n).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable artifact header") from e


def read_artifact_header(path: str) -> dict:
    """The header of an :func:`export_predictor` artifact; a ValueError for
    any other file (a JAX ``OGVT1`` artifact, a checkpoint)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_predictor(path: str) -> Predictor:
    """Load an :func:`export_predictor` artifact; the returned Predictor
    calls the loaded program (no model code or checkpoint needed). It needs
    this package's ``ogvt::`` op library (``ops/library.py``, imported here
    so the ops are registered before the program is read), whose CUDA
    kernels build from ``csrc/`` at the first forward on the card. An
    artifact exported on the card (kernels on or not: its weights live
    there) raises where torch sees no CUDA device; a file that is not such
    an artifact raises ValueError."""
    from outgridvit_tpu_torch.ops import library  # noqa: F401

    with open(path, "rb") as f:
        meta = _read_header(f, path)
        device = torch.device(meta["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path} was exported on a CUDA device (kernels "
                f"{'on' if meta['kernels'] else 'off'}); torch sees none "
                "here. Export with --device cpu for a CPU artifact")
        program = torch.export.load(io.BytesIO(f.read()))
    return Predictor(
        fn=program.module(), batch_size=int(meta["batch_size"]),
        img_size=int(meta["img_size"]), num_classes=int(meta["num_classes"]),
        mean=tuple(meta["mean"]), std=tuple(meta["std"]), device=device,
        kernels=bool(meta["kernels"]))
