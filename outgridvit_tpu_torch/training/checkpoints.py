"""Checkpoint save and load (twin of ``outgridvit_tpu/training/
checkpoints.py``), with the JAX package's best/last/resume metadata.

One file: the magic ``OGVT``, the metadata's length (little-endian uint64)
and the metadata as JSON (``epoch``, ``best_top1``, ``extra``), as the JAX
checkpoint has them, then a ``torch.save`` payload of the train state: the
model's ``state_dict`` (parameters and BatchNorm statistics), the AdamW
``mu``, ``nu`` and ``count``, ``step`` and ``device_step`` (the train
state's host and device step counts, equal in a state the train step has
advanced; a resume sets both from ``step``). The payload is the port's own
(the JAX one is msgpack, which the GPU machine lacks); a JAX train state
comes across through ``utils/port_jax.py:load_jax_train_state``. It is read
back with ``torch.load(weights_only=True)``.

Loading copies into the existing tensors of the state or model
(``copy_``), never rebinding them, so a captured CUDA graph that reads
them (``training/steps.py:EvalSuperstep``) stays valid.

On a mesh (``parallel/mesh.py``) the file holds the whole state, as the
JAX checkpoint does: every rank calls :func:`save_checkpoint`, which
gathers the tensor-parallel blocks of the parameters and moments over the
model group (a collective), and only rank 0 writes. Every rank loads the
whole state and keeps its blocks.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

_MAGIC = b"OGVT"


def _whole(tensors: Mapping[str, torch.Tensor], model: nn.Module
           ) -> Dict[str, torch.Tensor]:
    """The tensors by name, each tensor-parallel block of ``model``'s
    gathered whole over its model group (a collective)."""
    from outgridvit_tpu_torch.parallel.distributed import replicate_to_host
    from outgridvit_tpu_torch.parallel.mesh import mesh_of, shard_dims_of

    dims = shard_dims_of(model)
    if not dims:
        return dict(tensors)
    mesh = mesh_of(model)
    return {k: replicate_to_host(t, mesh, dims[k]) if k in dims else t
            for k, t in tensors.items()}


def _tree(state) -> Dict[str, Any]:
    model = state.model
    return {
        "model": _whole(model.state_dict(), model),
        "opt_state": {"mu": _whole(state.opt_state.mu, model),
                      "nu": _whole(state.opt_state.nu, model),
                      "count": state.opt_state.count},
        "step": int(state.step),
        "device_step": int(state.device_step),
    }


def save_checkpoint(path: str, state, epoch: int,
                    best_top1: float = float("-inf"),
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the train state and its metadata into one file (on a mesh:
    every rank calls it, rank 0 writes)."""
    from outgridvit_tpu_torch.parallel.distributed import is_main_process

    tree = _tree(state)
    if not is_main_process():
        return
    meta = json.dumps({"epoch": int(epoch), "best_top1": float(best_top1),
                       "extra": extra or {}}).encode("utf-8")
    payload = io.BytesIO()
    torch.save(tree, payload)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        f.write(payload.getbuffer())


def _read(path: str, map_location="cpu"):
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path} is not an outgridvit_tpu_torch "
                             "checkpoint")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode("utf-8"))
        payload = f.read()
    tree = torch.load(io.BytesIO(payload), map_location=map_location,
                      weights_only=True)
    return meta, tree


@torch.no_grad()
def _copy_into(dst: Mapping[str, torch.Tensor],
               src: Mapping[str, torch.Tensor], what: str,
               model: Optional[nn.Module] = None) -> None:
    """Copy ``src`` into ``dst`` by name; a tensor-parallel parameter of
    ``model`` (or its moment) takes the rank's block of the whole."""
    from outgridvit_tpu_torch.parallel.mesh import (
        local_block,
        mesh_of,
        shard_dims_of,
    )

    dims = shard_dims_of(model) if model is not None else {}
    if dims:
        src = {k: local_block(t, mesh_of(model), dims[k]) if k in dims
               else t for k, t in src.items()}
    if set(dst) != set(src):
        raise ValueError(
            f"checkpoint {what} does not match: missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")
    for key, t in dst.items():
        if tuple(t.shape) != tuple(src[key].shape):
            raise ValueError(f"checkpoint {what} {key}: "
                             f"{tuple(src[key].shape)} vs {tuple(t.shape)}")
        t.copy_(src[key])


def load_checkpoint(path: str, state=None) -> Dict[str, Any]:
    """Read a checkpoint: ``{"epoch", "best_top1", "extra", "state"}``.
    Given a ``state`` (a ``TrainState``), its model's parameters and
    buffers, AdamW moments and count are overwritten in place and its host
    and device steps set from the checkpoint's host step, and ``"state"``
    is that state; otherwise ``"state"`` is the raw tree (on the CPU)."""
    meta, tree = _read(path)
    out = dict(meta)
    if state is None:
        out["state"] = tree
        return out
    model = state.model
    _copy_into(model.state_dict(), tree["model"], "model", model)
    opt = tree["opt_state"]
    _copy_into(state.opt_state.mu, opt["mu"], "AdamW mu", model)
    _copy_into(state.opt_state.nu, opt["nu"], "AdamW nu", model)
    with torch.no_grad():
        state.opt_state.count.copy_(opt["count"])
    state.set_step(int(tree["step"]))
    out["state"] = state
    return out


def load_model_variables(path: str, model: nn.Module) -> nn.Module:
    """Restore only the model's parameters and BatchNorm statistics (in
    place), for eval-only use: the optimizer state is ignored."""
    _copy_into(model.state_dict(), _read(path)[1]["model"], "model", model)
    return model
