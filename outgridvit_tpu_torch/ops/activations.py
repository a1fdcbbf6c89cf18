"""Activation registry (twin of ``outgridvit_tpu/ops/activations.py``).

GELU is the exact erf form (``approximate="none"``), as in the JAX package.
The derivatives are the hand-written ones of the fused MLP kernel's backward
(``outgridvit_tpu/ops/mlp_branch_pallas.py:_gelu_grad32`` and siblings).

``make_activation(act, xla=True)`` gives the forms that the JAX package's
XLA path evaluates op by op, each op rounded to the input's dtype (the HLO
of ``flax.linen.silu`` / ``gelu(approximate=False)`` as JAX runs it op by
op): ``silu = x * (1 / (1 + exp(-x)))`` and ``gelu = (0.5 * x) *
erfc(-x * c)`` with ``c = 2^-1/2`` in the input's dtype. (Under one
``jax.jit`` XLA may fuse them and keep an intermediate in fp32.) In fp32
they agree with the fused forms to about 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

def _silu_xla(x):
    dt = x.dtype
    return x * (1.0 / (1.0 + torch.exp(-x)).to(dt)).to(dt)


def _gelu_xla(x):
    c = torch.tensor(2.0 ** -0.5, dtype=x.dtype)
    return (0.5 * x) * torch.special.erfc(-x * c)


_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "relu": F.relu,
}
_XLA_ACTS = dict(_ACTS, gelu=_gelu_xla, silu=_silu_xla)


def make_activation(act: str, xla: bool = False):
    """Name (any case) -> elementwise activation function; ``xla`` picks the
    op-by-op forms of the JAX XLA path."""
    try:
        return (_XLA_ACTS if xla else _ACTS)[act.lower()]
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
