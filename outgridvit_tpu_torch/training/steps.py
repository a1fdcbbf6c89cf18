"""The train step (twin of ``outgridvit_tpu/training/steps.py:
make_train_step``).

One step, in the JAX step's order: augment the raw uint8 batch, mix,
train-mode forward (BatchNorm batch statistics, drop-path), soft-target or
label-smoothed cross-entropy, backward, global gradient norm, clip + masked
AdamW, the non-finite guard, metrics. The step updates the model's
parameters, BatchNorm statistics and the optimizer state in place (JAX
donates the state instead).

Randomness: the step consumes :class:`StepDraws` (augment draws, mix draws,
drop-path masks), given by the caller or sampled from a ``torch.Generator``
with :func:`sample_step_draws`: one the caller hands in, or, given a
``seed``, the step's own from :func:`step_generator` seeded from ``(seed,
state.step)``, as the JAX step folds ``state.step`` into its key, so a
resumed run draws what an uninterrupted one drew. ``jax.random`` bits
cannot be reproduced, so parity tests hand both frameworks the same draws.

Non-finite guard: when the loss or the gradient norm is not finite, the
parameters, the optimizer state (moments and count) and the BatchNorm
statistics keep their values, ``nonfinite`` is 1 and the reported loss and
grad_norm are 0; the state's step advances all the same. The guard is a
select on the device, so the step needs no host sync.

The eval step (twin of ``make_eval_step``) normalizes a raw uint8 batch in
the step when asked, runs the eval-mode forward and returns the loss and
top-1/3/5 as 0-d device tensors. The K-batch eval superstep (twin of
``make_eval_superstep``'s ``lax.scan``) replays K eval steps captured in
one CUDA graph (:class:`EvalSuperstep`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from outgridvit_tpu_torch.ops.augment import (
    AugmentConfig,
    AugmentDraws,
    apply_augment_draws,
    normalize_batch,
    sample_augment_draws,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.training.losses import (
    cross_entropy_smoothed,
    soft_target_cross_entropy,
)
from outgridvit_tpu_torch.training.metrics import accuracy_topk
from outgridvit_tpu_torch.training.mixing import (
    MixDraws,
    apply_mix_draws,
    sample_mix_draws,
)
from outgridvit_tpu_torch.training.optim import global_norm
from outgridvit_tpu_torch.training.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    num_classes: int
    label_smoothing: float = 0.1
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    mix_prob: float = 1.0
    grad_clip_norm: Optional[float] = 1.0
    # set: batches are raw uint8 images and the augmentation recipe runs in
    # the step (ops/augment.py)
    augment: Optional[AugmentConfig] = None

    @property
    def mixing(self) -> bool:
        return self.mixup_alpha > 0.0 or self.cutmix_alpha > 0.0


class StepDraws(NamedTuple):
    """Every random input of one train step; a field is None when its stage
    is off."""

    augment: Optional[AugmentDraws] = None
    mix: Optional[MixDraws] = None
    drop_masks: Optional[DropPathMasks] = None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step``'s draws, seeded from
    ``(seed, step)`` through a numpy ``SeedSequence``: the same draws
    whichever device the step runs on (they are moved to it)."""
    hi, lo = np.random.SeedSequence((int(seed), int(step))).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed((int(hi) & 0x7FFFFFFF) << 32
                                         | int(lo))


def sample_step_draws(generator: torch.Generator, cfg: StepConfig,
                      shape: Tuple[int, int, int, int],
                      device=None) -> StepDraws:
    """Draw a step's augment and mix draws from ``generator``; drop-path
    masks are drawn from it too, during the forward."""
    B, H, W, _ = shape
    aug = (sample_augment_draws(generator, shape, cfg.augment, device)
           if cfg.augment is not None else None)
    mix = (sample_mix_draws(generator, B, H, W, cfg.mixup_alpha,
                            cfg.cutmix_alpha, cfg.mix_prob, device)
           if cfg.mixing and cfg.mix_prob > 0.0 else None)
    return StepDraws(aug, mix, DropPathMasks(generator=generator))


def make_train_step(cfg: StepConfig,
                    lr_schedule: Optional[Callable] = None):
    """Build the train step: ``(state, (images NHWC, int labels), draws=None,
    generator=None, seed=None) -> (state, metrics)``, with ``draws`` (a
    :class:`StepDraws`), a ``generator`` to sample them, or a ``seed`` to
    sample them from :func:`step_generator` at ``state.step`` (moved to
    the batch's device). The metrics are 0-d device tensors: loss, top1, top3,
    top5, grad_norm, clipped, nonfinite and, with ``lr_schedule``, lr (at
    ``state.step``)."""

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   seed: Optional[int] = None):
        images, labels = batch
        if draws is None:
            if generator is None:
                if seed is None:
                    raise ValueError(
                        "give the step's draws or a generator, or a seed")
                generator = step_generator(seed, state.step)
            draws = sample_step_draws(generator, cfg, tuple(images.shape),
                                      images.device)
        if cfg.augment is not None:
            images = apply_augment_draws(images, draws.augment, cfg.augment)
        if cfg.mixing and cfg.mix_prob > 0.0:
            images, targets = apply_mix_draws(images, labels, draws.mix,
                                              cfg.num_classes)
        else:
            targets = torch.nn.functional.one_hot(
                labels.long(), cfg.num_classes).float()

        model = state.model.train()
        params = dict(model.named_parameters())
        buffers = [b for b in model.buffers()]
        stats_before = [b.clone() for b in buffers]
        for p in params.values():
            p.grad = None
        logits = model(images, draws.drop_masks)
        if cfg.mixing:
            loss = soft_target_cross_entropy(logits, targets)
        else:
            loss = cross_entropy_smoothed(logits, labels,
                                          cfg.label_smoothing)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        gnorm = global_norm(list(grads.values()))
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        state.tx.apply_(params, grads, state.opt_state, gnorm, finite)
        with torch.no_grad():
            for b, old in zip(buffers, stats_before):
                b.copy_(torch.where(finite, b, old))
            logits = logits.detach()
            accs = accuracy_topk(logits, targets if cfg.mixing else labels)
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics: Dict[str, torch.Tensor] = {
                "loss": torch.where(finite, loss.detach(), zero),
                "top1": accs[1], "top3": accs[3], "top5": accs[5],
                "grad_norm": torch.where(finite, gnorm, zero),
                "clipped": ((gnorm > cfg.grad_clip_norm).float()
                            if cfg.grad_clip_norm is not None else zero),
                "nonfinite": (~finite).float(),
            }
            if lr_schedule is not None:
                metrics["lr"] = lr_schedule(
                    torch.tensor(state.step, dtype=torch.int32,
                                 device=loss.device))
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(model: torch.nn.Module, label_smoothing: float = 0.0,
                   normalize: Optional[Tuple[Sequence[float],
                                             Sequence[float]]] = None):
    """Build the eval step: ``((images NHWC, int labels)) -> {"loss",
    "top1", "top3", "top5"}``, 0-d fp32 device tensors: cross-entropy
    (``label_smoothing``, none by default) and top-k in percent of the
    eval-mode forward of ``model``. With ``normalize=(mean, std)`` the
    images come as raw uint8 and are normalized in the step
    (``normalize_batch``), the mean and std kept on the device per device,
    so a step makes no host tensor once it has run on a device."""
    stats: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def norm(x: torch.Tensor) -> torch.Tensor:
        if x.device not in stats:
            stats[x.device] = tuple(
                torch.tensor(v, dtype=torch.float32, device=x.device)
                for v in normalize)
        return normalize_batch(x, *stats[x.device])

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        images, labels = batch
        if normalize is not None:
            images = norm(images)
        logits = model.eval()(images)
        accs = accuracy_topk(logits, labels)
        return {"loss": cross_entropy_smoothed(logits, labels,
                                               label_smoothing),
                "top1": accs[1], "top3": accs[3], "top5": accs[5]}

    return eval_step


class EvalSuperstep:
    """K eval steps in one dispatch (twin of ``make_eval_superstep``):
    ``((images [K, B, ...], labels [K, B])) -> metrics dict of [K] fp32
    tensors``, equal to K :func:`make_eval_step` calls.

    On a CUDA device the K steps are captured once per input shape in one
    CUDA graph that reads static ``[K, B, H, W, C]`` and ``[K, B]`` buffers
    and writes ``[K]`` metric buffers; each call copies its batches into
    the buffers, replays the graph and returns copies of the metrics. A
    warm-up step on a side stream first builds and loads the kernels and
    computes each launch plan, so the capture makes no host sync. The
    graph reads the parameters and BatchNorm statistics by address: it
    follows their in-place updates (the train step's and a resume's
    ``copy_``) and would not follow a rebinding. The kernel wrappers count
    their launches once, at the capture; :attr:`replays` counts the
    replays of every instance. On a CPU device the K steps run eagerly."""

    replays = 0

    def __init__(self, model: torch.nn.Module, k: int,
                 label_smoothing: float = 0.0, normalize=None):
        self.k = int(k)
        self.step = make_eval_step(model, label_smoothing, normalize)
        self.graphs: Dict[tuple, tuple] = {}

    def _steps(self, images, labels) -> Dict[str, torch.Tensor]:
        ms = [self.step((images[i], labels[i])) for i in range(self.k)]
        return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    def _capture(self, images, labels):
        static = (torch.empty_like(images), torch.empty_like(labels))
        side = torch.cuda.Stream(images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):
            self.step((static[0][0].zero_(), static[1][0].zero_()))
        torch.cuda.current_stream(images.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._steps(*static)
        return graph, static, out

    def __call__(self, superbatch) -> Dict[str, torch.Tensor]:
        images, labels = superbatch
        if images.shape[0] != self.k or labels.shape[0] != self.k:
            raise ValueError(f"eval superstep of K={self.k}: got "
                             f"{tuple(images.shape)} / {tuple(labels.shape)}")
        if images.device.type != "cuda":
            return self._steps(images, labels)
        key = (images.device, tuple(images.shape), images.dtype,
               tuple(labels.shape), labels.dtype)
        if key not in self.graphs:
            self.graphs[key] = self._capture(images, labels)
        graph, (x, y), out = self.graphs[key]
        x.copy_(images)
        y.copy_(labels)
        graph.replay()
        EvalSuperstep.replays += 1
        return {key: v.clone() for key, v in out.items()}


def make_eval_superstep(model: torch.nn.Module, label_smoothing: float = 0.0,
                        normalize=None, k: int = 8) -> EvalSuperstep:
    """The K-batch eval superstep (:class:`EvalSuperstep`)."""
    return EvalSuperstep(model, k, label_smoothing, normalize)
