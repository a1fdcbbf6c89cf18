"""Load the JAX package's variables into the port.

``load_flax_variables(model, variables)`` takes the ``{"params": ...,
"batch_stats": ...}`` tree of ``outgridvit_tpu`` (nested dicts of numpy
arrays; no JAX needed) and fills the port's parameters and buffers. The
reverse direction needs no code here:
``outgridvit_tpu.utils.port_torch.port_torch_state_dict(model.state_dict(),
template, strict=True)`` maps the port's keys onto the JAX tree.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}

# flax module path (dot-joined) -> torch module path, applied in order
_RENAMES = (
    (r"stages_(\d+)_(\d+)", r"stages.\1.\2"),
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


def torch_key(flax_path: Tuple[str, ...]) -> str:
    """('stages_0_0', 'mbconv', 'expand_bn', 'bn', 'mean') ->
    'stages.0.0.mbconv.expand.1.running_mean'."""
    *mods, leaf = flax_path
    s = ".".join(mods)
    for pat, rep in _RENAMES:
        s = re.sub(pat, rep, s)
    return f"{s}.{_LEAF.get(leaf, leaf)}"


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
    new: Dict[str, torch.Tensor] = {}
    unused, bad = [], []
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key = torch_key(path)
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
            new[key] = torch.from_numpy(np.ascontiguousarray(arr))
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
