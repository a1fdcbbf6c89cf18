"""Activation registry (twin of ``outgridvit_tpu/ops/activations.py``).

GELU is the exact erf form (``approximate="none"``), as in the JAX package.
The derivatives are the hand-written ones of the fused MLP kernel's backward
(``outgridvit_tpu/ops/mlp_branch_pallas.py:_gelu_grad32`` and siblings).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "relu": F.relu,
}


def make_activation(act: str):
    """Name (any case) -> elementwise activation function."""
    try:
        return _ACTS[act.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{act}'. Use one of: silu|gelu|relu") from None


def _gelu_grad(x):
    return (0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
            + x * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x))


def _silu_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


_GRADS = {
    "gelu": _gelu_grad,
    "silu": _silu_grad,
    "relu": lambda x: (x > 0.0).to(x.dtype),
}


def activation_grad(act: str):
    """Name (any case) -> the activation's derivative, elementwise."""
    make_activation(act)  # validate the name
    return _GRADS[act.lower()]
