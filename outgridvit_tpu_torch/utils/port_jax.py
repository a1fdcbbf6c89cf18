"""Load the JAX package's variables and train state into the port.

``load_flax_variables(model, variables)`` takes the ``{"params": ...,
"batch_stats": ...}`` tree of ``outgridvit_tpu`` (nested dicts of numpy
arrays; no JAX needed) and fills the port's parameters and buffers, Model
A's and B's through ``_RENAMES``, the baseline zoo's through its own table
(``models/baselines.py:FLAX_RENAMES``, which the model names).
``jax_tree_to_port`` maps any tree shaped like the JAX params (grads, AdamW
moments) to the port's parameter names and layouts, and
``load_jax_train_state`` turns a JAX ``TrainState``'s parts into the port's
:class:`~outgridvit_tpu_torch.training.train_state.TrainState`. The reverse
direction needs no code here:
``outgridvit_tpu.utils.port_torch.port_torch_state_dict(model.state_dict(),
template, strict=True)`` maps the port's keys onto the JAX tree.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

if TYPE_CHECKING:
    from outgridvit_tpu_torch.training.optim import AdamW
    from outgridvit_tpu_torch.training.train_state import TrainState

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}

# flax module path (dot-joined) -> torch module path, applied in order
_RENAMES = (
    (r"stages_(\d+)_(\d+)", r"stages.\1.\2"),
    (r"front_(\d+)", r"front.\1"),
    (r"^stem\.conv$", "stem.stem.0"),
    (r"^stem\.bn\.bn$", "stem.stem.1"),
    (r"^downs_(\d+)\.conv$", r"downs.\1.op.0"),
    (r"^downs_(\d+)\.bn\.bn$", r"downs.\1.op.1"),
    (r"^head_norm\.bn$", "head_norm"),
    (r"\.mbconv\.(expand|depthwise|project)$", r".mbconv.\1.0"),
    (r"\.mbconv\.(expand|depthwise|project)_bn\.bn$", r".mbconv.\1.1"),
    (r"\.ln$", ""),
)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def renames_of(model: nn.Module) -> tuple:
    """The rename table of ``model``: its ``flax_renames`` (the baseline
    zoo's, ``models/baselines.py:FLAX_RENAMES``), else Model A's and B's."""
    return getattr(model, "flax_renames", _RENAMES)


def torch_key(flax_path: Tuple[str, ...], renames: tuple = _RENAMES) -> str:
    """('stages_0_0', 'mbconv', 'expand_bn', 'bn', 'mean') ->
    'stages.0.0.mbconv.expand.1.running_mean'; a top-level parameter
    (``('cls_token',)``) keeps its name."""
    *mods, leaf = flax_path
    s = ".".join(mods)
    for pat, rep in renames:
        s = re.sub(pat, rep, s)
    leaf = _LEAF.get(leaf, leaf)
    return f"{s}.{leaf}" if s else leaf


def _to_torch_layout(a: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return a
    if a.ndim == 2:  # Dense [in, out] -> [out, in]
        return a.T
    if a.ndim == 4:  # HWIO (depthwise [3, 3, 1, C]) -> OIHW ([C, 1, 3, 3])
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters and buffers from the JAX variables.
    Strict: raises ``ValueError`` listing every port tensor left unfilled,
    every JAX leaf left unused and every shape that disagrees."""
    state = model.state_dict()
    renames = renames_of(model)
    new: Dict[str, torch.Tensor] = {}
    unused, bad = [], []
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key = torch_key(path, renames)
            name = "/".join((collection,) + path)
            if key not in state:
                unused.append(name)
                continue
            arr = _to_torch_layout(np.asarray(leaf, dtype=np.float32),
                                   path[-1])
            if tuple(arr.shape) != tuple(state[key].shape):
                bad.append(f"{name} {arr.shape} -> {key} "
                           f"{tuple(state[key].shape)}")
                continue
            new[key] = torch.from_numpy(np.array(arr))
    missing = sorted(set(state) - set(new))
    if missing or unused or bad:
        raise ValueError(
            "Weight porting mismatch.\n"
            f"  port tensors without a JAX leaf: {missing}\n"
            f"  JAX leaves unused: {unused}\n  shape mismatches: {bad}")
    with torch.no_grad():
        for key, t in new.items():
            state[key].copy_(t)
    return model


def jax_tree_to_port(tree: Mapping[str, Any], renames: tuple = _RENAMES
                     ) -> Dict[str, np.ndarray]:
    """A tree shaped like the JAX params (the params themselves, their
    grads, AdamW ``mu``/``nu``) -> {port parameter name: fp32 array in the
    port's layout}; ``renames``: the model's table (:func:`renames_of`)."""
    return {torch_key(path, renames): np.ascontiguousarray(
                _to_torch_layout(np.asarray(leaf, dtype=np.float32), path[-1]))
            for path, leaf in _flatten(tree)}


def load_jax_train_state(model: nn.Module, tx: "AdamW", *,
                         params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any],
                         mu: Mapping[str, Any], nu: Mapping[str, Any],
                         count: int, step: int) -> "TrainState":
    """The port's ``TrainState`` from a JAX ``TrainState``'s parts (numpy
    trees): params and batch_stats into ``model`` (strict, as
    :func:`load_flax_variables`), the AdamW moments and count (``opt_state``'s
    ``ScaleByAdamState``) into a fresh optimizer state of ``tx``, and the
    step counter (host and device)."""
    from outgridvit_tpu_torch.training.train_state import TrainState

    load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
    state = TrainState.create(model, tx)
    for name, tree in (("mu", mu), ("nu", nu)):
        mapped = jax_tree_to_port(tree, renames_of(model))
        dst = getattr(state.opt_state, name)
        if set(mapped) != set(dst):
            raise ValueError(
                f"AdamW {name} does not match the model's parameters: "
                f"missing {sorted(set(dst) - set(mapped))}, "
                f"unused {sorted(set(mapped) - set(dst))}")
        with torch.no_grad():
            for key, arr in mapped.items():
                if tuple(arr.shape) != tuple(dst[key].shape):
                    raise ValueError(f"AdamW {name} {key}: {arr.shape} vs "
                                     f"{tuple(dst[key].shape)}")
                dst[key].copy_(torch.from_numpy(np.array(arr)))
    state.opt_state.count.fill_(int(count))
    state.set_step(step)
    return state
