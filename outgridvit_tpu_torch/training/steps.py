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
with :func:`sample_step_draws`; ``jax.random`` bits cannot be reproduced, so
parity tests hand both frameworks the same draws.

Non-finite guard: when the loss or the gradient norm is not finite, the
parameters, the optimizer state (moments and count) and the BatchNorm
statistics keep their values, ``nonfinite`` is 1 and the reported loss and
grad_norm are 0; the state's step advances all the same. The guard is a
select on the device, so the step needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from outgridvit_tpu_torch.ops.augment import (
    AugmentConfig,
    AugmentDraws,
    apply_augment_draws,
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
    generator=None) -> (state, metrics)``, with ``draws`` (a
    :class:`StepDraws`) or a ``generator`` to sample them. The metrics are
    0-d device tensors: loss, top1, top3, top5, grad_norm, clipped,
    nonfinite and, with ``lr_schedule``, lr (at ``state.step``)."""

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None):
        images, labels = batch
        if draws is None:
            if generator is None:
                raise ValueError("give the step's draws or a generator")
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
