"""Train state (twin of ``outgridvit_tpu/training/train_state.py``): the
step counter, the model (its parameters and BatchNorm statistics), the
optimizer and its state."""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from outgridvit_tpu_torch.training.optim import AdamW, AdamWState


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: AdamW

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW) -> "TrainState":
        return cls(step=0, model=model,
                   opt_state=tx.init(dict(model.named_parameters())), tx=tx)
