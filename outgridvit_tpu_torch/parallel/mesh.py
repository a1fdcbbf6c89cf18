"""The mesh and the sharding rules (twin of ``outgridvit_tpu/parallel/
mesh.py``) on ``torch.distributed``.

A :class:`Mesh` of shape ``(data, model)`` lays the world's ranks out as
``np.reshape`` lays out ``jax.devices()``: rank ``r`` sits at data index
``r // model`` and model index ``r % model``. Its data group (the ranks of
one model index) splits the batch: BatchNorm's statistics, the mix, the
loss, the metrics and the gradient are summed over it, as GSPMD sums them
in the JAX step. Its model group (the ranks of one data index) holds the
same rows and splits the tensor-parallel parameters.

Tensor parallelism gathers the weights first. The JAX package declares no
sharding rule for a ``pallas_call``, so GSPMD cannot split a kernel's work
over the model axis; the port does what that amounts to. A parameter that
a rule of :data:`_TP_RULES` shards keeps only its block (the parameter and
its AdamW moments hold ``1/model`` of the rows), and each forward reads the
weight whole, gathered over the model group
(``collectives.py:gather_shard``); the kernels (the fused MLP branch #2,
the attention branch #5, the projections) run on the whole weight, on the
rank's local rows, so the compute is repeated across the model axis. The
backward keeps the rank's slice of the whole weight's gradient, which every
rank of the model group computes the same.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from outgridvit_tpu_torch.parallel import distributed
from outgridvit_tpu_torch.parallel.collectives import (
    NO_AXIS,
    Axis,
    gather_shard,
)


@dataclass(frozen=True, eq=False)
class Mesh:
    """The world's ranks as a ``(data, model)`` grid, seen from one rank:
    ``devices`` (the rank grid), ``shape`` (``{"data": D, "model": M}``),
    this rank's ``data`` and ``model`` :class:`Axis`, its ``device`` (None
    without a process group) and the group's ``backend``."""

    devices: np.ndarray
    data: Axis
    model: Axis
    device: Optional[torch.device]
    backend: Optional[str]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(("data", "model"), self.devices.shape))

    @property
    def active(self) -> bool:
        """A process group exists: the step runs its collectives."""
        return self.data.active

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend})"


def _group(ranks: Sequence[int]):
    ranks = [int(r) for r in ranks]
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A ``(data, model)`` mesh over the world's ranks; default
    ``(world, 1)``: every rank on ``data``. Every rank must call it, in the
    same order: it makes the process groups of every data and model group
    of the grid."""
    world = distributed.process_count()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != #devices {world}")
    grid = np.arange(world).reshape(shape)
    if not dist.is_initialized():
        return Mesh(grid, NO_AXIS, NO_AXIS, None, None)
    rank = dist.get_rank()
    d, m = int(rank // shape[1]), int(rank % shape[1])
    data_groups = [_group(grid[:, j]) for j in range(shape[1])]
    model_groups = [_group(grid[i, :]) for i in range(shape[0])]
    return Mesh(grid, Axis(data_groups[m], shape[0], d),
                Axis(model_groups[d], shape[1], m), distributed.device(),
                distributed.backend())


@dataclass(frozen=True)
class RowSharding:
    """Rows of dimension ``dim`` split over the mesh's data axis (the
    port's ``NamedSharding(mesh, P(..., "data"))``)."""

    mesh: Mesh
    dim: int = 0

    def rows(self, global_size: int) -> slice:
        return distributed.local_row_slice(
            global_size, self.mesh.data.index, self.mesh.data.size)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global tensor."""
        s = self.rows(x.shape[self.dim])
        return x.narrow(self.dim, s.start, s.stop - s.start)


def batch_sharding(mesh: Mesh) -> RowSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return RowSharding(mesh, 0)


def superbatch_sharding(mesh: Mesh) -> RowSharding:
    """``[K, B, ...]`` stacked batches: the step axis stays whole, the
    batch axis splits."""
    return RowSharding(mesh, 1)


# Parameter partitioning rules for tensor parallelism, as in the JAX
# package: matched against the "/"-joined flax param path, with specs over
# the flax layout. Column-parallel on the hidden/out dim for the
# up-projections, row-parallel on the in dim for the down-projections.
_TP_RULES = [
    (re.compile(r"mlp/fc1/kernel$"), (None, "model")),
    (re.compile(r"mlp/fc1/bias$"), ("model",)),
    (re.compile(r"mlp/fc2/kernel$"), ("model", None)),
    (re.compile(r"qkv/kernel$"), (None, "model")),
    (re.compile(r"qkv/bias$"), ("model",)),
    (re.compile(r"(grid_attn/mhsa|attn)/proj/kernel$"), ("model", None)),
    (re.compile(r"mbconv/expand/kernel$"), (None, "model")),
    (re.compile(r"mbconv/expand/bias$"), ("model",)),
    (re.compile(r"mbconv/project/kernel$"), ("model", None)),
    (re.compile(r"classifier/kernel$"), (None, "model")),
    (re.compile(r"classifier/bias$"), ("model",)),
]


def param_pspec(path, leaf, model_axis_size: int) -> tuple:
    """The partition spec of one flax param leaf (``path``: a "/"-joined
    string or a tuple of names; ``leaf``: the array or its shape, in the
    flax layout): ``()`` (replicated) when the model axis is trivial, no
    rule matches, or a named dim does not divide."""
    if model_axis_size <= 1:
        return ()
    leaf_shape = getattr(leaf, "shape", leaf)
    name = path if isinstance(path, str) else "/".join(
        getattr(k, "key", getattr(k, "name", str(k))) for k in path)
    for rule, spec in _TP_RULES:
        if rule.search(name):
            if all(ax != "model" or dim % model_axis_size == 0
                   for dim, ax in zip(leaf_shape, spec)):
                return spec
    return ()


# the port's leaf names -> the flax leaves they come from
_FLAX_LEAVES = {"weight": ("kernel", "scale"), "bias": ("bias",)}


def flax_param_path(name: str, renames=None) -> Optional[str]:
    """The flax path (``"/"``-joined, the module prefix that the renames do
    not reach shortened to ``…``) of the port parameter ``name``: the
    longest tail of its module path that the weight bridge's
    ``utils/port_jax.py:torch_key`` maps back onto it, with a container's
    index (``mbconv.expand.0``) dropped. None for a leaf no flax leaf
    becomes."""
    from outgridvit_tpu_torch.utils.port_jax import _RENAMES, torch_key

    renames = _RENAMES if renames is None else renames
    *mods, leaf = name.split(".")
    for start in range(len(mods) + 1):
        tail = mods[start:]
        head = ("…",) if start else ()
        path = head + tuple(t for t in tail if not t.isdigit())
        for flax_leaf in _FLAX_LEAVES.get(leaf, ()):
            if (torch_key(path + (flax_leaf,), renames)
                    == ".".join(head + tuple(tail) + (leaf,))):
                return "/".join(path + (flax_leaf,))
    return None


def _flax_dims(rank: int) -> Tuple[int, ...]:
    """The port dim of each flax dim of a parameter of ``rank`` dims: Dense
    ``[in, out]`` is the port's ``[out, in]``; a conv's HWIO its OIHW."""
    return {2: (1, 0), 4: (2, 3, 1, 0)}.get(rank, tuple(range(rank)))


def param_shard_dims(model: nn.Module, model_axis_size: int
                     ) -> Dict[str, int]:
    """``{port parameter name: the port dim its block splits}`` for every
    parameter that :func:`param_pspec` shards over a model axis of
    ``model_axis_size``: the flax path through the weight bridge
    (:func:`flax_param_path`), the spec over the flax layout, moved onto the
    port's layout (a Dense kernel's ``P(None, "model")`` splits the port's
    ``[out, in]`` weight on dim 0)."""
    from outgridvit_tpu_torch.utils.port_jax import renames_of

    out: Dict[str, int] = {}
    if model_axis_size <= 1:
        return out
    renames = renames_of(model)
    for name, p in model.named_parameters():
        path = flax_param_path(name, renames)
        if path is None:
            continue
        dims = _flax_dims(p.dim())
        flax_shape = [0] * p.dim()
        for fd, pd in enumerate(dims):
            flax_shape[fd] = p.shape[pd]
        spec = param_pspec(path, flax_shape, model_axis_size)
        for fd, ax in enumerate(spec):
            if ax == "model":
                out[name] = dims[fd]
    return out


class _Gathered:
    """A module attribute that reads a tensor-parallel parameter whole: the
    rank's block gathered over the model group, differentiably; the
    parameter itself (under the same name) holds the block."""

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        try:
            p = obj.__dict__["_parameters"][self.name]
        except KeyError:
            raise AttributeError(self.name) from None
        spec = obj.__dict__.get("tp_shards", {}).get(self.name)
        return p if spec is None else gather_shard(p, *spec)


_TP_CLASSES: Dict[type, type] = {}


def _tp_class(cls: type) -> type:
    sub = _TP_CLASSES.get(cls)
    if sub is None:
        sub = _TP_CLASSES[cls] = type(cls.__name__, (cls,), {
            "__module__": cls.__module__, "__qualname__": cls.__qualname__,
            "weight": _Gathered("weight"), "bias": _Gathered("bias")})
    return sub


def mesh_of(model: nn.Module) -> Optional[Mesh]:
    """The mesh a model was placed on (:func:`shard_model`), or None."""
    return getattr(model, "parallel_mesh", None)


def shard_dims_of(model: nn.Module) -> Dict[str, int]:
    """``{parameter name: dim}`` of the model's tensor-parallel blocks."""
    return getattr(model, "tp_dims", {})


def local_block(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim`` (a copy)."""
    k = t.shape[dim] // mesh.model.size
    return t.narrow(dim, mesh.model.index * k, k).clone()


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``model`` (whole, the same on every rank) on ``mesh``, in
    place: its BatchNorms take their statistics over the data group, and
    each parameter a TP rule shards keeps its block and is read whole
    through the model group. A mesh without a process group changes
    nothing. Returns the model."""
    from outgridvit_tpu_torch.models.layers import BatchNorm

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be the port's parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh_of(model) is not None:
        if mesh_of(model) is not mesh:
            raise ValueError("the model is already placed on another mesh")
        return model
    if not mesh.active:
        return model
    model.parallel_mesh = mesh
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_axis = mesh.data
    dims = param_shard_dims(model, mesh.model.size)
    for name, dim in dims.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        p = mod._parameters[leaf]
        p.data = local_block(p.data, mesh, dim)
        if "tp_shards" not in mod.__dict__:
            mod.tp_shards = {}
            mod.__class__ = _tp_class(type(mod))
        mod.tp_shards[leaf] = (mesh.model, dim)
    model.tp_dims = dims
    return model


@torch.no_grad()
def shard_train_state(state, mesh: Mesh):
    """Place a ``TrainState`` on ``mesh`` (:func:`shard_model`), its AdamW
    moments sharded with their parameters; a state already placed there is
    returned as it is. Every rank holds the same whole state before (same
    seed, same init, same checkpoint)."""
    model = state.model
    if mesh_of(model) is mesh or not mesh.active:
        return state
    shard_model(model, mesh)
    for name, dim in shard_dims_of(model).items():
        for moments in (state.opt_state.mu, state.opt_state.nu):
            moments[name] = local_block(moments[name], mesh, dim)
    return state
