"""Multi-process execution (twin of ``outgridvit_tpu/parallel/distributed.py``)
on ``torch.distributed``: NCCL between CUDA devices, gloo on the CPU.

Contract, as in the JAX package: every process (a *rank*) runs the same
program over the same mesh (``parallel/mesh.py``). Data is the only
per-rank thing: each rank's loader yields its own rows of every global
batch (``ArrayDataLoader(process_id=, process_count=)``, split per *data*
rank, so the ranks of one model group load the same rows). The train state
is the same on every rank by construction (same seed, same init, same
checkpoint) and is placed on the mesh by ``mesh.py:shard_train_state``.
Only rank 0 logs and writes files.

Each rank computes on one device: ``cuda:(LOCAL_RANK % device count)``, or
the CPU. Ranks may share a card (two ranks on one H100), but NCCL refuses
two ranks on one device: such a world runs gloo, whose collectives take
CUDA tensors for ``all_reduce`` (``parallel/collectives.py``) but cannot be
captured in a CUDA graph.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective, or the rendezvous, waits for the other ranks
DEFAULT_TIMEOUT_S = 300.0

_DEVICE: Optional[torch.device] = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def local_device(local_rank: int) -> torch.device:
    """This rank's card: ``cuda:(local rank % device count)``."""
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *, device: str = "cuda",
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent ``torch.distributed`` bring-up.

    Arguments fall back to ``OUTGRIDVIT_COORDINATOR`` (``host:port`` of
    rank 0's store) / ``OUTGRIDVIT_NUM_PROCESSES`` /
    ``OUTGRIDVIT_PROCESS_ID``, then to torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. A world of one with no
    coordinator (no configuration at all) is a no-op returning False;
    anything else joins the process group and returns True.

    ``device``: ``"cuda"`` (the rank computes on :func:`local_device`, which
    becomes the current CUDA device; backend NCCL) or ``"cpu"`` (gloo).
    ``local_device_ids``: the rank's CUDA device index, overriding
    ``LOCAL_RANK``. ``backend`` overrides the choice: gloo lets ranks share
    a card. ``timeout_s`` bounds the rendezvous and every collective."""
    global _DEVICE
    coord = coordinator_address or os.environ.get("OUTGRIDVIT_COORDINATOR")
    nproc = (num_processes if num_processes is not None
             else _env_int("OUTGRIDVIT_NUM_PROCESSES", 0))
    pid = (process_id if process_id is not None
           else _env_int("OUTGRIDVIT_PROCESS_ID", -1))
    if not coord and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
        nproc = nproc or _env_int("WORLD_SIZE", 1)
        pid = pid if pid >= 0 else _env_int("RANK", 0)

    if not coord and nproc in (0, 1):
        return False  # a world of one: nothing to do
    if dist.is_initialized():
        return True
    if not coord:
        raise ValueError(f"{nproc} processes need a coordinator address "
                         "(host:port)")
    if pid < 0 or not 0 <= pid < max(nproc, 1):
        raise ValueError(f"process_id {pid} out of range [0, {nproc})")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        index = local_device_ids
        if isinstance(index, (list, tuple)):
            index = index[0]
        _DEVICE = local_device(index if index is not None
                               else _env_int("LOCAL_RANK", pid))
        torch.cuda.set_device(_DEVICE)
    else:
        _DEVICE = torch.device("cpu")
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"),
        init_method=f"tcp://{coord}", world_size=max(nproc, 1), rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def device() -> Optional[torch.device]:
    """The device :func:`initialize` gave this rank (None before)."""
    return _DEVICE if dist.is_initialized() else None


def backend() -> Optional[str]:
    """The process group's backend (``"nccl"``, ``"gloo"``), or None."""
    return dist.get_backend() if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that logs and writes files."""
    return process_index() == 0


def local_row_slice(global_batch_size: int, pid: int, pcount: int) -> slice:
    """Rows of every global batch owned by data rank ``pid`` of ``pcount``:
    ``[p*B/P, (p+1)*B/P)``."""
    if global_batch_size % pcount != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {pcount} processes")
    loc = global_batch_size // pcount
    return slice(pid * loc, (pid + 1) * loc)


def warmup_collectives() -> None:
    """One tiny all-reduce over every rank right after :func:`initialize`:
    the ranks meet while in lockstep, before any model build, and NCCL
    makes its communicator. No-op in a world of one without a group."""
    if not dist.is_initialized():
        return
    one = torch.ones((), device=device())
    dist.all_reduce(one)
    if int(one.item()) != process_count():
        raise RuntimeError(f"collective warm-up: {float(one)} ranks answered, "
                           f"{process_count()} expected")


def shard_loader_for_process(loader, mesh):
    """Make an ``ArrayDataLoader`` (in place) yield only this rank's rows of
    every global batch, split per data rank of ``mesh``
    (``ArrayDataLoader.split``): ranks of one model group load the same
    rows. ``None`` (no val loader) stays None."""
    if loader is not None:
        loader.split(mesh.data.index, mesh.data.size)
    return loader


def replicate_to_host(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A tensor-parallel block, split along ``dim`` over the ``mesh``'s
    model axis, gathered whole onto the host (CPU): a collective, which
    every rank of the model group must call (checkpoint saves do)."""
    from outgridvit_tpu_torch.parallel.collectives import gather

    with torch.no_grad():
        return gather(x.detach(), mesh.model, dim).cpu()
