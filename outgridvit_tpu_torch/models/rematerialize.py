"""Opt-in per-block rematerialization (twin of ``outgridvit_tpu/models/
rematerialize.py``): each block runs under ``torch.utils.checkpoint`` and
its backward recomputes what the policy did not save.

Policies (the ``model.remat`` YAML key):
  - ``nothing``: save only the block input (``jax.checkpoint``'s default);
  - ``dots``: save the outputs of matrix products and convolutions
    (``dots_saveable``: ``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``convolution``), through
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``;
  - ``dots_no_batch``: save only the products without batch dimensions
    (``dots_with_no_batch_dims_saveable``: ``aten.mm`` and ``addmm``, the
    dense layers' products; the attention's batched products are
    recomputed);
  - ``off``: disabled. A falsy YAML value (``false``, ``''``, ``0``,
    ``null``) means off too.

The JAX package falls back to ``OUTGRIDVIT_REMAT`` when the key is absent;
the port does not read it (it keeps the JAX A/B env knobs out, ROADMAP §1
item 13), so an absent key is off.

A recompute must compute what the forward computed, and change nothing
the forward changed: :func:`checkpoint_block` marks the recompute
(:func:`recomputing`), in which drop-path reads the masks its forward drew
(``ops/drop_path.py:DropPathMasks``) and BatchNorm leaves its running
statistics alone (``models/layers.py:BatchNorm``), as JAX's functional
``nn.remat`` leaves them. No device RNG state is saved
(``preserve_rng_state=False``): the port passes every random draw in, and
a CUDA graph capture cannot save the generator's state. The kernels'
autograd Functions write only into tensors they allocate, which no policy
caches, so a recomputed launch never writes into a cached tensor.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
# the products jax.checkpoint_policies.dots_saveable keeps: dot_general
# (mm, addmm, bmm, baddbmm) and conv_general_dilated (convolution)
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default, _aten.convolution.default})
# dots_with_no_batch_dims_saveable: dot_generals without batch dimensions
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})

_POLICIES = {
    "nothing": None,
    "dots": _DOTS,
    "dots_no_batch": _DOTS_NO_BATCH,
}

# Values of model.remat that mean "explicitly disabled"
_OFF_SENTINELS = frozenset({"off", "none", "false", "0", ""})

_RECOMPUTING = contextvars.ContextVar("ogvt_recomputing", default=False)


def _saving(ops: frozenset) -> Callable:
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def remat_policy(name: str) -> Optional[Callable]:
    """Resolve a policy name to a selective-checkpoint policy function, or
    None for ``nothing`` (save only the block input); an unknown name
    raises ``ValueError`` as in JAX."""
    key = str(name).strip().lower()
    if key not in _POLICIES:
        raise ValueError(
            f"Unknown remat policy '{name}'; choose from {sorted(_POLICIES)}"
        )
    ops = _POLICIES[key]
    return None if ops is None else _saving(ops)


def remat_enabled(remat: Optional[str]) -> bool:
    """Whether ``remat`` names a policy; a named policy is validated."""
    if not remat or str(remat).strip().lower() in _OFF_SENTINELS:
        return False
    remat_policy(remat)
    return True


def recomputing() -> bool:
    """True while :func:`checkpoint_block` recomputes a block's forward in
    the backward."""
    return _RECOMPUTING.get()


def checkpoint_block(block: torch.nn.Module, remat: Optional[str], x,
                     *args):
    """``block(x, *args)``, rematerialized with policy ``remat`` when it
    names one and autograd records (a no-grad forward runs the block as
    it is)."""
    if not remat_enabled(remat) or not torch.is_grad_enabled():
        return block(x, *args)
    calls = []

    def run(x):
        token = _RECOMPUTING.set(bool(calls))
        calls.append(None)
        try:
            return block(x, *args)
        finally:
            _RECOMPUTING.reset(token)

    policy = remat_policy(remat)
    kw = ({} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)})
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)
