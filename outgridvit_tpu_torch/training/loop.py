"""Epoch-level training (twin of ``outgridvit_tpu/training/loop.py``).

``train_model`` keeps the JAX loop's arguments, its per-epoch order (train
-> save last -> val -> save best -> early stop), its history dict, its
resume and best-tracking semantics and its printed log lines, format for
format. On the port:

- it runs on one device a rank, the card unless the caller asks for the
  CPU; on a mesh (``parallel/mesh.py``, ``mesh=``) every rank runs this
  same loop on its rows of each global batch (per-rank loaders), the state
  placed on the mesh by ``shard_train_state`` at the start and at a resume,
  and only rank 0 logs and writes checkpoints (every rank calls the save,
  whose gather of tensor-parallel blocks is a collective);
- a step's augment, mix and drop-path draws come from a generator seeded
  from ``(seed, state.step)`` (``training/steps.py:step_generator``), so a
  resumed run is bitwise the run it resumes;
- with ``steps_per_dispatch`` K > 1 the loop groups K full batches into a
  ``[K, B, ...]`` superbatch, one host-to-device copy, and runs each
  through the train superstep, K steps in one CUDA graph on the card
  (``steps.py:TrainSuperstep``), bitwise K single steps, as the JAX loop
  runs its scan; eval runs each full K-group through one CUDA graph
  (``steps.py:EvalSuperstep``); ragged tails and fewer than K batches run
  as single eager steps;
- step metrics stay on the device, and a print or an epoch end fetches
  them in one transfer;
- memory is ``torch.cuda.max_memory_allocated`` / ``max_memory_reserved``
  (nan on the CPU); the JAX loop has one number for both;
- with ``OUTGRIDVIT_PROFILE_DIR`` set, the first trained epoch's train
  steps are traced by ``torch.profiler`` (the card's kernels too on
  CUDA) into a Chrome trace there, as the JAX loop writes a JAX trace.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional

import numpy as np
import torch

from outgridvit_tpu_torch.data.pipeline import Prefetcher, peek_loader
from outgridvit_tpu_torch.parallel.distributed import is_main_process
from outgridvit_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_train_state,
)
from outgridvit_tpu_torch.training.checkpoints import (
    load_checkpoint,
    save_checkpoint,
)
from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    make_eval_step,
    make_eval_superstep,
    make_train_step,
    make_train_superstep,
)
from outgridvit_tpu_torch.training.train_state import TrainState

_TRAIN_KEYS = ("loss", "top1", "top3", "top5", "grad_norm", "clipped",
               "nonfinite", "lr")
_EVAL_KEYS = ("loss", "top1", "top3", "top5")


def _group_batches(it, k: int, full_bs: int):
    """Stack runs of ``k`` full-size host batches into ``[k, B, ...]``
    superbatches; anything irregular (the ragged tail, the remainder of
    fewer than ``k``) passes through as single batches."""
    buf = []

    def flush():
        nonlocal buf
        if len(buf) == k:
            yield np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf])
        else:
            yield from buf
        buf = []

    for x, y in it:
        if y.shape[0] != full_bs:
            yield from flush()
            yield x, y
            continue
        buf.append((x, y))
        if len(buf) == k:
            yield from flush()
    yield from flush()


def _super_iter(loader, k: int):
    """The loader's batches for a K-batch eval: full-size batches grouped
    into ``[K, B, ...]`` superbatches, ragged tails passed through."""
    it = iter(loader)
    try:
        first = next(it)
    except StopIteration:
        return iter(())
    return _group_batches(itertools.chain([first], it), k,
                          first[1].shape[0])


def _device_mem_gib(device: torch.device):
    """(peak allocated, peak reserved) GiB on a CUDA device; nan on the
    CPU."""
    if device.type != "cuda":
        return float("nan"), float("nan")
    gib = 1024.0 ** 3
    return (torch.cuda.max_memory_allocated(device) / gib,
            torch.cuda.max_memory_reserved(device) / gib)


def _dtype_from_cfg(autocast_dtype: str, use_amp: bool) -> torch.dtype:
    """The config's autocast knob as a compute dtype: fp16 / bf16 ->
    bfloat16 (no fp16 GradScaler, as in JAX), fp32 or amp off ->
    float32."""
    if not use_amp:
        return torch.float32
    return {
        "fp16": torch.bfloat16,
        "float16": torch.bfloat16,
        "bf16": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "fp32": torch.float32,
        "float32": torch.float32,
    }.get(str(autocast_dtype).lower(), torch.bfloat16)


def _fetch(metrics, keys):
    """A list of metric dicts (0-d or [K] device tensors) -> one dict of
    floats per step, in one device-to-host transfer."""
    if not metrics:
        return []
    cols = torch.stack([
        torch.cat([torch.atleast_1d(m[k]).float() for m in metrics])
        for k in keys]).cpu().numpy()
    return [{k: float(cols[j, i]) for j, k in enumerate(keys)}
            for i in range(cols.shape[1])]


def train_model(
    model,
    train_loader,
    epochs: int = 100,
    val_loader=None,
    device: str = "cuda",
    lr: float = 5e-4,
    weight_decay: float = 0.05,
    autocast_dtype: str = "bf16",
    use_amp: bool = True,
    grad_clip_norm: Optional[float] = 1.0,
    warmup_ratio: float = 0.05,
    min_lr: float = 0.0,
    label_smoothing: float = 0.1,
    print_every: int = 100,
    save_path: str = "best_model.ckpt",
    last_path: str = "last_model.ckpt",
    resume_path: Optional[str] = None,
    mixup_alpha: float = 0.0,
    cutmix_alpha: float = 0.0,
    mix_prob: float = 1.0,
    num_classes: int = 100,
    channels_last: bool = False,  # NHWC throughout: accepted and ignored
    early_stop: bool = True,
    early_stop_metric: str = "top1",
    early_stop_patience: int = 6,
    early_stop_min_delta: float = 0.05,
    early_stop_require_monotonic: bool = False,
    seed: int = 7,
    mesh=None,
    state: Optional[TrainState] = None,
    steps_per_dispatch: int = 1,
):
    """Train ``model`` (built at the compute dtype on ``device``, e.g. by
    ``models/build.py:build_model``); returns ``(history, state)``.

    ``state``: a ``TrainState`` to start from (its model is trained and its
    optimizer used); else a fresh one of ``model`` and AdamW with the
    warmup-cosine schedule. ``mesh``: a ``parallel.Mesh`` (default
    ``make_mesh()``: every rank on ``data``; without a process group, one
    device as before); the loaders must yield each data rank's rows of the
    global batches (``parallel/distributed.py:shard_loader_for_process``),
    as in JAX: a loader split for another data rank, or not split for a
    data axis of several ranks, raises."""
    if mesh is None:
        mesh = make_mesh()
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be the port's parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    for what, loader in (("train", train_loader), ("val", val_loader)):
        if loader is None:
            continue
        split = (getattr(loader, "process_id", 0),
                 getattr(loader, "process_count", 1))
        if split != (mesh.data.index, mesh.data.size):
            raise ValueError(
                f"the {what} loader yields data rank {split[0]} of "
                f"{split[1]}'s rows; mesh {mesh.shape} puts this rank at "
                f"data index {mesh.data.index} of {mesh.data.size} "
                "(shard_loader_for_process)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no "
                           "CUDA device; pass device='cpu' for the CPU")
    log = print if is_main_process() else (lambda *a, **k: None)
    n_data = mesh.data.size

    steps_per_epoch = len(train_loader)
    total_steps = epochs * steps_per_epoch
    warmup_steps = int(total_steps * warmup_ratio)
    schedule = warmup_cosine_lr(lr, total_steps, warmup_steps, min_lr)

    compute_dtype = _dtype_from_cfg(autocast_dtype, use_amp)
    if state is not None:
        model = state.model
    if getattr(model, "dtype", None) != compute_dtype:
        raise ValueError(
            f"the model computes in {getattr(model, 'dtype', None)}, the "
            f"config asks for {compute_dtype} (autocast_dtype="
            f"{autocast_dtype}, use_amp={use_amp}); build it with "
            "build_model(model_cfg, dtype=...)")
    param_device = next(model.parameters()).device
    if param_device.type != device.type or (
            device.index is not None and param_device != device):
        raise ValueError(f"the model is on {param_device}, training asked "
                         f"for {device}")
    device = param_device

    # the first batch's shape, without losing it from a one-shot iterator
    (x0, y0), train_iterable = peek_loader(train_loader)
    bs0 = x0.shape[0]
    img_shape = (bs0, x0.shape[3], x0.shape[1], x0.shape[2])  # print NCHW

    if state is None:
        state = TrainState.create(
            model, AdamW(schedule, weight_decay, grad_clip_norm))
    state = shard_train_state(state, mesh)

    # loaders built with device_augment yield raw uint8 and carry the
    # AugmentConfig; the recipe then runs in the train step
    aug_cfg = getattr(train_loader, "device_augment", None)
    step_cfg = StepConfig(
        num_classes=num_classes, label_smoothing=label_smoothing,
        mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
        mix_prob=mix_prob, grad_clip_norm=grad_clip_norm, augment=aug_cfg)
    train_step = make_train_step(step_cfg, lr_schedule=schedule)
    kdisp = max(1, int(steps_per_dispatch))
    train_superstep = (make_train_superstep(step_cfg, schedule, kdisp)
                       if kdisp > 1 else None)
    eval_norm = getattr(val_loader, "device_normalize", None)
    eval_step = make_eval_step(model, label_smoothing=0.0,
                               normalize=eval_norm)
    eval_superstep = (make_eval_superstep(model, label_smoothing=0.0,
                                          normalize=eval_norm, k=kdisp)
                      if kdisp > 1 else None)

    # ---- resume / best tracking
    start_epoch = 0
    best_val_top1 = -float("inf")
    best_val_loss = float("inf")
    best_epoch = 0
    metric = early_stop_metric.lower()
    assert metric in ("top1", "loss")
    mode = "max" if metric == "top1" else "min"
    best_metric = -float("inf") if mode == "max" else float("inf")

    if resume_path is not None:
        ckpt = load_checkpoint(resume_path, state)  # takes its blocks
        state = shard_train_state(ckpt["state"], mesh)
        start_epoch = int(ckpt.get("epoch", 0))
        best_val_top1 = float(ckpt.get("best_top1", best_val_top1))
        extra = ckpt.get("extra", {}) or {}
        best_val_loss = float(extra.get("best_val_loss", best_val_loss))
        best_epoch = int(extra.get("best_epoch", best_epoch))
        best_metric = float(extra.get("best_metric", best_metric))
        log(
            f"Resumed from {resume_path} at epoch {start_epoch} | "
            f"best_top1 {best_val_top1:.2f}% | best_loss {best_val_loss:.4f} | "
            f"best_{metric} {best_metric:.6f}"
        )

    history = {
        "train_loss": [], "train_top1": [], "train_top3": [], "train_top5": [],
        "val_loss": [], "val_top1": [], "val_top3": [], "val_top5": [],
        "lr": [],
        "train_grad_norm": [], "train_clip_frac": [], "train_amp_overflows": [],
        "train_nonfinite_loss_steps": [], "train_scaler_scale": [],
        "train_mem_alloc_gib": [], "train_mem_res_gib": [],
        "val_mem_alloc_gib": [], "val_mem_res_gib": [],
    }

    patience = int(early_stop_patience)
    bad_epochs = 0
    last_vals = []

    def _is_improvement(curr, best):
        d = float(early_stop_min_delta)
        return (curr > best + d) if mode == "max" else (curr < best - d)

    def _degradation_monotonic(vals):
        if not early_stop_require_monotonic or len(vals) < 2:
            return True
        if mode == "max":
            return all(vals[i] >= vals[i + 1] for i in range(len(vals) - 1))
        return all(vals[i] <= vals[i + 1] for i in range(len(vals) - 1))

    # ---- run-config banner
    n_dev = (mesh.devices.size if mesh.active else
             torch.cuda.device_count() if device.type == "cuda" else 1)
    log("=== Run config ===")
    log(
        f"device={device.type}x{n_dev} | amp={use_amp} | "
        f"autocast_dtype={autocast_dtype} "
        f"(compute={str(compute_dtype).removeprefix('torch.')}) | "
        f"mesh={mesh.shape}"
    )
    log(
        f"epochs={epochs} | steps/epoch={steps_per_epoch} | "
        f"total_steps={total_steps} | warmup_steps={warmup_steps}"
    )
    log(f"batch_size={bs0 * n_data}"
        + (f" ({n_data} data ranks x {bs0} local)" if n_data > 1 else "")
        + f" | input_shape={img_shape} | num_classes={num_classes}")
    log(f"opt=AdamW | lr={lr} | wd={weight_decay} | grad_clip_norm={grad_clip_norm}")
    log(
        f"aug: mix_prob={mix_prob} | mixup_alpha={mixup_alpha} | "
        f"cutmix_alpha={cutmix_alpha} | label_smoothing={label_smoothing}"
        + (" | device_augment=on" if aug_cfg is not None else "")
    )
    if val_loader is not None:
        log(
            f"early_stop={early_stop} | metric={metric} | patience={patience} | "
            f"min_delta={early_stop_min_delta}"
        )
    else:
        log("val_loader=None => no early-stop / no best saving by val metric.")
    log("==================")

    # optional profiler trace of the first trained epoch (set
    # OUTGRIDVIT_PROFILE_DIR to capture)
    profile_dir = os.environ.get("OUTGRIDVIT_PROFILE_DIR")
    profiler = None

    for epoch in range(start_epoch + 1, epochs + 1):
        log(f"\n=== Epoch {epoch}/{epochs} ===")
        t_epoch = time.time()
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if profile_dir and epoch == start_epoch + 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        # ---------------- train epoch
        t0 = time.time()
        device_metrics = []  # not yet fetched
        host_metrics = []  # fetched plain-float dicts
        total = 0
        nsteps = len(train_loader)

        def drain():
            nonlocal device_metrics
            host_metrics.extend(_fetch(device_metrics, _TRAIN_KEYS))
            device_metrics = []

        epoch_iter = iter(train_iterable)
        train_iterable = train_loader  # the peeked batch is consumed once
        host_iter = (_group_batches(epoch_iter, kdisp, bs0) if kdisp > 1
                     else epoch_iter)

        step = 0
        last_print_bucket = 0
        for xb, yb in Prefetcher(host_iter, device):
            if yb.dim() == 2:  # [K, B] superbatch
                state, m = train_superstep(state, (xb, yb), seed=seed)
                step += yb.shape[0]
                total += yb.shape[0] * yb.shape[1]
            else:
                state, m = train_step(state, (xb, yb), seed=seed)
                step += 1
                total += yb.shape[0]
            device_metrics.append(m)
            bucket = step // print_every if print_every else 0
            if print_every and (bucket > last_print_bucket or step == nsteps):
                last_print_bucket = bucket
                drain()
                # skipped (non-finite) steps are left out of the means
                finite_ms = [s for s in host_metrics
                             if s["nonfinite"] == 0.0] or host_metrics
                mm = {
                    k: float(np.mean([s[k] for s in finite_ms]))
                    for k in ("loss", "top1", "top3", "top5", "grad_norm")
                }
                oflow = int(sum(s["nonfinite"] for s in host_metrics))
                clip_pct = 100.0 * float(
                    np.mean([s["clipped"] for s in host_metrics])
                )
                lr_now = host_metrics[-1]["lr"]
                dt = time.time() - t0
                log(
                    f"[train step {step}/{nsteps}] "
                    f"loss {mm['loss']:.4f} | "
                    f"top1 {mm['top1']:.2f}% | top3 {mm['top3']:.2f}% | "
                    f"top5 {mm['top5']:.2f}% | "
                    f"{total / max(dt, 1e-9):.1f} img/s | lr {lr_now:.2e} | "
                    f"gnorm {mm['grad_norm']:.3f} | clip {clip_pct:.1f}% | "
                    f"oflow 0 | nonfinite {oflow} | scale 1.0"
                )

        if profiler is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, f"train_epoch{epoch}.json")
            profiler.export_chrome_trace(trace)
            profiler = None
            log(f"[profile] wrote torch trace to {trace}")

        drain()
        finite_ms = [s for s in host_metrics
                     if s["nonfinite"] == 0.0] or host_metrics
        tr = {
            k: float(np.mean([s[k] for s in finite_ms]))
            for k in ("loss", "top1", "top3", "top5", "grad_norm", "clipped")
        }
        nonfinite_steps = int(sum(s["nonfinite"] for s in host_metrics))
        lr_now = host_metrics[-1]["lr"]
        mem_alloc, mem_res = _device_mem_gib(device)

        history["train_loss"].append(tr["loss"])
        history["train_top1"].append(tr["top1"])
        history["train_top3"].append(tr["top3"])
        history["train_top5"].append(tr["top5"])
        history["lr"].append(lr_now)
        history["train_grad_norm"].append(tr["grad_norm"])
        history["train_clip_frac"].append(tr["clipped"])
        history["train_amp_overflows"].append(0.0)
        history["train_nonfinite_loss_steps"].append(float(nonfinite_steps))
        history["train_scaler_scale"].append(1.0)
        history["train_mem_alloc_gib"].append(mem_alloc)
        history["train_mem_res_gib"].append(mem_res)

        log(
            f"[Train] loss {tr['loss']:.4f} | top1 {tr['top1']:.2f}% | "
            f"top3 {tr['top3']:.2f}% | top5 {tr['top5']:.2f}% | "
            f"lr {lr_now:.2e} | "
            f"grad_norm {tr['grad_norm']:.3f} | clip {100 * tr['clipped']:.1f}% | "
            f"amp_overflows 0 | nonfinite_loss {nonfinite_steps} | scale 1.0"
        )
        if np.isfinite(mem_alloc):
            log(f"[Train] mem_peak alloc {mem_alloc:.2f} GiB | reserved "
                f"{mem_res:.2f} GiB")

        # save "last" every epoch
        save_checkpoint(
            last_path, state, epoch=epoch, best_top1=best_val_top1,
            extra={
                "autocast_dtype": autocast_dtype,
                "use_amp": use_amp,
                "best_val_loss": best_val_loss,
                "best_epoch": best_epoch,
                "best_metric": best_metric,
                "early_stop_metric": metric,
                "early_stop_patience": patience,
                "early_stop_min_delta": float(early_stop_min_delta),
            },
        )

        stop_now = False

        # ---------------- validation
        if val_loader is not None:
            if hasattr(val_loader, "set_epoch"):
                val_loader.set_epoch(epoch)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            va = _run_eval(eval_step, val_loader, device,
                           eval_superstep=eval_superstep, k=kdisp)
            val_alloc, val_res = _device_mem_gib(device)
            history["val_loss"].append(va["loss"])
            history["val_top1"].append(va["top1"])
            history["val_top3"].append(va["top3"])
            history["val_top5"].append(va["top5"])
            history["val_mem_alloc_gib"].append(val_alloc)
            history["val_mem_res_gib"].append(val_res)

            log(
                f"[Val]   loss {va['loss']:.4f} | top1 {va['top1']:.2f}% | "
                f"top3 {va['top3']:.2f}% | top5 {va['top5']:.2f}%"
            )
            if np.isfinite(val_alloc):
                log(f"[Val]   mem_peak alloc {val_alloc:.2f} GiB | reserved "
                    f"{val_res:.2f} GiB")

            if va["top1"] > best_val_top1:
                best_val_top1 = va["top1"]
            if va["loss"] < best_val_loss:
                best_val_loss = va["loss"]
            curr_metric = va["top1"] if metric == "top1" else va["loss"]

            if _is_improvement(curr_metric, best_metric):
                best_metric = curr_metric
                best_epoch = int(epoch)
                save_checkpoint(
                    save_path, state, epoch=epoch, best_top1=best_val_top1,
                    extra={
                        "autocast_dtype": autocast_dtype,
                        "use_amp": use_amp,
                        "best_val_loss": best_val_loss,
                        "best_epoch": best_epoch,
                        "best_metric": best_metric,
                        "best_metric_name": metric,
                    },
                )
                log(f"Best saved to {save_path} (val {metric} = {best_metric:.6f})")
                bad_epochs = 0
            else:
                bad_epochs += 1

            if early_stop:
                last_vals.append(curr_metric)
                if len(last_vals) > patience:
                    last_vals = last_vals[-patience:]
                if bad_epochs >= patience and _degradation_monotonic(last_vals):
                    log(
                        f"Early-stop: no improvement on val_{metric} for "
                        f"{patience} epochs."
                    )
                    stop_now = True

        if stop_now:
            break
        dt = time.time() - t_epoch
        log(f"Epoch time: {dt / 60:.2f} min")

    return history, state


def _run_eval(eval_step, loader, device, eval_superstep=None, k: int = 1):
    """Batch-size-weighted mean eval metrics over a loader. The metrics
    stay on the device and come back in one transfer; with
    ``eval_superstep`` and ``k`` > 1, each full K-group of batches is one
    superstep (ragged tails and fewer than K batches run as single
    steps)."""
    if eval_superstep is not None and k > 1:
        host_iter = _super_iter(loader, k)
    else:
        host_iter = iter(loader)
    device_metrics = []
    sizes = []  # one weight per step
    for images, labels in Prefetcher(host_iter, device):
        if labels.dim() == 2:  # [K, B] superbatch
            device_metrics.append(eval_superstep((images, labels)))
            sizes.extend([labels.shape[1]] * labels.shape[0])
        else:
            device_metrics.append(eval_step((images, labels)))
            sizes.append(labels.shape[0])
    if not device_metrics:
        return {"loss": 0.0, "top1": 0.0, "top3": 0.0, "top5": 0.0}
    fetched = _fetch(device_metrics, _EVAL_KEYS)
    w = np.asarray(sizes, dtype=np.float64)
    return {key: float(sum(float(m[key]) * b for m, b in zip(fetched, w)))
            / max(1.0, float(w.sum())) for key in _EVAL_KEYS}
