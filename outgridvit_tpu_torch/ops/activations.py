"""Activation registry (twin of ``outgridvit_tpu/ops/activations.py``).

GELU is the exact erf form (``approximate="none"``), as in the JAX package.
"""

from __future__ import annotations

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
