"""Train state (twin of ``outgridvit_tpu/training/train_state.py``): the
step counter, the model (its parameters and BatchNorm statistics), the
optimizer and its state.

The step is kept twice: ``step``, a host int for the seeds of the step's
draws and for checkpoints, and ``device_step``, a 0-d int32 tensor on the
model's device that the train step reads (the ``lr`` metric) and
increments in place, as JAX's ``state.step`` lives on the device. A CUDA
graph of K steps (``training/steps.py:TrainSuperstep``) reads and advances
the device one; the caller advances the host one by K. :meth:`set_step`
sets both."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from outgridvit_tpu_torch.training.optim import AdamW, AdamWState


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: AdamW
    device_step: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.device_step is None:
            self.device_step = torch.full((), int(self.step),
                                          dtype=torch.int32,
                                          device=self.opt_state.count.device)

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW) -> "TrainState":
        return cls(step=0, model=model,
                   opt_state=tx.init(dict(model.named_parameters())), tx=tx)

    @torch.no_grad()
    def set_step(self, step: int) -> None:
        """Set the host step and, in place, the device step to ``step``."""
        self.step = int(step)
        self.device_step.fill_(self.step)
