"""Benchmark evaluation (twin of ``outgridvit_tpu/training/bench_eval.py``):
the timed eval epoch behind every published throughput number, with the
JAX function's metric dict.

Reports loss/top1/top3/top5, imgs_per_sec (after the warm-up dispatches),
ms_per_batch, epoch_seconds, the parameter count and size, forward FLOPs
and the device's memory. On the port:

- FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
  caller's ``model_fn`` (the plain path, ``use_kernels=False``, at the
  example batch's shape; ``benchmark_eval.py`` runs it on the ``meta``
  device). It counts matrix products and convolutions only, where XLA's
  cost analysis also counts elementwise work, so the two counts differ by
  design;
- memory is ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` of
  the model's device after the epoch, nan on the CPU;
- batches reach the device through ``data/pipeline.py:Prefetcher``; full
  K-groups run through the eval superstep's CUDA graph
  (``steps.py:EvalSuperstep``), ragged tails and fewer than K batches
  through the eval step.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def count_params(model: torch.nn.Module) -> int:
    """Elements of the model's parameters (BatchNorm statistics are
    buffers, as they are outside JAX's ``params``)."""
    return int(sum(p.numel() for p in model.parameters()))


def param_bytes(model: torch.nn.Module) -> int:
    return int(sum(p.numel() * p.element_size()
                   for p in model.parameters()))


def flops_of(fn, *args) -> Optional[float]:
    """Forward FLOPs of ``fn(*args)`` counted by ``FlopCounterMode`` under
    ``no_grad`` (products and convolutions; see the module docstring).
    None if the count cannot be made."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # no count is no metric, as in JAX
        return None


def format_ops(n: Optional[float]) -> str:
    if n is None or not np.isfinite(n):
        return "n/a"
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f} {unit}FLOPs"
        n /= 1000.0
    return f"{n:.2f} PFLOPs"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_one_epoch_logs(
    eval_step,
    state,
    loader,
    data_shard=None,
    warmup_batches: int = 2,
    model_fn=None,
    example_batch=None,
    verbose: bool = True,
    eval_superstep=None,
    k: int = 1,
):
    """Timed eval epoch. ``eval_step`` as from ``make_eval_step``;
    ``state`` a ``TrainState`` (or the model itself); ``data_shard`` the
    device the batches go to (default: the model's; the JAX argument's
    sharding has no one-device counterpart).

    ``eval_superstep`` / ``k``: when given (``make_eval_superstep``), runs
    of ``k`` full-size batches are stacked on the host and evaluated by one
    replay of the superstep's graph; ragged tails go through
    ``eval_step``. No host sync per batch: the clock starts once the first
    ``warmup_batches`` dispatches are done (``torch.cuda.synchronize``) and
    stops after one final sync; the metrics stay on the device and are
    fetched once at the end."""
    from outgridvit_tpu_torch.data.pipeline import Prefetcher
    from outgridvit_tpu_torch.training.loop import _fetch, _super_iter

    model = getattr(state, "model", state)
    device = torch.device(data_shard) if data_shard is not None else \
        next(model.parameters()).device
    n_params = count_params(model)
    size_mb = param_bytes(model) / (1024**2)

    flops = None
    if model_fn is not None and example_batch is not None:
        flops = flops_of(model_fn, example_batch)

    if eval_superstep is not None and k > 1:
        host_iter = _super_iter(loader, k)
    else:
        host_iter = iter(loader)

    device_metrics = []
    sizes = []  # one weight per step
    t_epoch0 = time.perf_counter()
    t_warm = t_epoch0
    timed_images = 0
    timed_batches = 0
    for bi, (images, labels) in enumerate(Prefetcher(host_iter, device)):
        if labels.dim() == 2:  # [K, B] superbatch
            m = eval_superstep((images, labels))
            bsz = [labels.shape[1]] * labels.shape[0]
        else:
            m = eval_step((images, labels))
            bsz = [labels.shape[0]]
        device_metrics.append(m)
        sizes.extend(bsz)
        if bi == warmup_batches - 1:
            _sync(device)  # warm-up and capture done: start the clock
            t_warm = time.perf_counter()
        elif bi >= warmup_batches:
            timed_images += sum(bsz)
            timed_batches += len(bsz)
    _sync(device)  # the whole chain
    t_end = time.perf_counter()
    epoch_s = t_end - t_epoch0

    fetched = _fetch(device_metrics, ("loss", "top1", "top3", "top5"))
    w = np.asarray(sizes, dtype=np.float64)
    n = int(w.sum())
    totals = {key: float(sum(m[key] * b for m, b in zip(fetched, w)))
              for key in ("loss", "top1", "top3", "top5")}

    if device.type == "cuda":
        mem_gib = torch.cuda.memory_allocated(device) / (1024**3)
        peak_gib = torch.cuda.max_memory_allocated(device) / (1024**3)
    else:
        mem_gib = peak_gib = float("nan")

    metrics = {
        "loss": totals["loss"] / max(1, n),
        "top1": totals["top1"] / max(1, n),
        "top3": totals["top3"] / max(1, n),
        "top5": totals["top5"] / max(1, n),
        # steady-state rate over the post-warm-up window (the capture and
        # the kernels' build excluded; the whole epoch is epoch_seconds)
        "imgs_per_sec": (timed_images / max(t_end - t_warm, 1e-9)
                         if timed_batches else n / max(epoch_s, 1e-9)),
        "ms_per_batch": (1000.0 * (t_end - t_warm) / timed_batches
                         if timed_batches else float("nan")),
        "epoch_seconds": epoch_s,
        "num_images": n,
        "params": n_params,
        "param_size_mb": size_mb,
        "flops_fwd": flops,
        "mem_gib": mem_gib,
        "mem_peak_gib": peak_gib,
    }
    if verbose:
        print(
            f"[bench] params {n_params:,} ({size_mb:.2f} MB) | "
            f"flops/fwd {format_ops(flops)}"
        )
        print(
            f"[bench] loss {metrics['loss']:.4f} | "
            f"top1 {metrics['top1']:.2f}% | top3 {metrics['top3']:.2f}% | "
            f"top5 {metrics['top5']:.2f}%"
        )
        print(
            f"[bench] {metrics['imgs_per_sec']:.1f} imgs/s | "
            f"{metrics['ms_per_batch']:.2f} ms/batch | "
            f"epoch {epoch_s:.2f} s | "
            f"mem {mem_gib:.2f} GiB (peak {peak_gib:.2f})"
        )
    return metrics
