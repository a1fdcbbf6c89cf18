"""Train OutGridViT models with the PyTorch port (twin of
``scripts/train.py``): the same flags, YAML schema and override logic.

    python -m outgridvit_tpu_torch.train --config configs/<x>.yaml [flags]

``runtime.device`` (``--device``) defaults to ``cuda``; ``cpu`` is the only
way onto the CPU (``tpu``, ``auto`` and an empty value mean the card). A
CUDA device without a card exits non-zero; nothing falls back.
``--device-augment auto`` runs the augmentation recipe in the train step on
the card and on the host on the CPU; ``--steps-per-dispatch`` defaults to 8
on the card and 1 on the CPU. The configs are read by
``utils/config.py:load_config`` (no PyYAML needed).

Data × model parallelism, as the JAX script: one process per rank, the same
flags everywhere but ``--dist-process-id`` (or ``torchrun``'s environment,
or ``OUTGRIDVIT_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``);
``--mesh D,M`` lays the ranks out as data × model (default: all on data).
Each rank computes on ``cuda:(LOCAL_RANK % cards)`` with NCCL (which
takes one rank a card), or on the CPU with gloo. The process group is
joined before any CUDA work, the loaders yield each data rank's rows of the
global batch, and only rank 0 logs and writes.

    torchrun --nproc-per-node 2 -m outgridvit_tpu_torch.train \
        --config configs/cifar100_model_a_7m.yaml --mesh 2,1
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train Outlook-Grid models (PyTorch port, CUDA)")
    parser.add_argument("--config", default="configs/train.yaml",
                        help="Path to YAML config")
    parser.add_argument("--model", choices=["a", "b", "model_a", "model_b"],
                        help="Override model type")
    parser.add_argument("--device", help="Override runtime device (cuda|cpu)")
    parser.add_argument("--epochs", type=int, help="Override training epochs")
    parser.add_argument("--batch-size", type=int, help="Override batch size")
    parser.add_argument("--data-dir", help="Override dataset root")
    parser.add_argument("--num-workers", type=int,
                        help="Override dataloader workers")
    parser.add_argument("--img-size", type=int,
                        help="Override input image size")
    parser.add_argument("--val-split", type=float,
                        help="Override val split (0..1)")
    parser.add_argument("--output-dir", help="Override output directory")
    parser.add_argument("--resume", help="Path to resume checkpoint")
    parser.add_argument("--no-amp", action="store_true",
                        help="Disable mixed precision (use fp32)")
    parser.add_argument("--seed", type=int, help="Override random seed")
    parser.add_argument("--mesh",
                        help="Device mesh as data,model (e.g. '4,2')")
    parser.add_argument(
        "--device-augment", choices=["auto", "on", "off"], default="auto",
        help="run the train augmentation recipe in the step on the device "
             "(auto: on for CUDA, off on the CPU)")
    parser.add_argument(
        "--steps-per-dispatch", type=int, default=None,
        help="group K full batches per host-to-device copy and K eval "
             "batches per CUDA graph (default: 8 on CUDA, 1 on the CPU)")
    # multi-process execution: one process per rank, the same flags
    # everywhere except --dist-process-id; defaults also come from the
    # OUTGRIDVIT_* and torchrun environments (parallel/distributed.py)
    parser.add_argument(
        "--dist-coordinator", default=None,
        help="host:port of rank 0's store (enables torch.distributed)")
    parser.add_argument(
        "--dist-num-processes", type=int, default=None,
        help="total number of processes in the distributed run")
    parser.add_argument(
        "--dist-process-id", type=int, default=None,
        help="this process's rank in [0, num_processes)")
    parser.add_argument(
        "--history-out", default=None,
        help="pickle the training history dict after the run "
             "(utils/history.py loads it)")
    return parser.parse_args(argv)


def resolve_device(name: str):
    """The torch device ``runtime.device`` (or ``--device``) names: cpu, or
    the card; a RuntimeError when the card is asked for and torch sees
    none (the port's CLIs exit 2 on it)."""
    import torch

    name = str(name).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("tpu", "auto", ""):
        name = "cuda"
    device = torch.device(name)
    if device.type != "cuda":
        raise ValueError(f"runtime.device {name!r}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"runtime.device {name!r} asks for the card, but torch sees no "
            "CUDA device; pass --device cpu to run on the CPU")
    return device


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from outgridvit_tpu_torch.utils.config import load_config

    cfg = load_config(Path(args.config))
    model_cfg = cfg.get("model", {})
    data_cfg = cfg.get("data", {})
    train_cfg = cfg.get("training", {})
    runtime_cfg = cfg.get("runtime", {})

    if args.model:
        model_cfg["type"] = args.model
    if args.epochs is not None:
        train_cfg["epochs"] = args.epochs
    if args.batch_size is not None:
        data_cfg["batch_size"] = args.batch_size
    if args.data_dir is not None:
        data_cfg["data_dir"] = args.data_dir
    if args.num_workers is not None:
        data_cfg["num_workers"] = args.num_workers
    if args.img_size is not None:
        data_cfg["img_size"] = args.img_size
    if args.val_split is not None:
        data_cfg["val_split"] = args.val_split
    if args.device is not None:
        runtime_cfg["device"] = args.device
    if args.output_dir is not None:
        runtime_cfg["output_dir"] = args.output_dir
    if args.resume is not None:
        train_cfg["resume_path"] = args.resume
    if args.no_amp:
        train_cfg["use_amp"] = False
    if args.seed is not None:
        runtime_cfg["seed"] = args.seed

    try:
        device = resolve_device(runtime_cfg.get("device", "cuda"))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # the process group before any CUDA work; the rank's device after it
    from outgridvit_tpu_torch.parallel import distributed

    if distributed.initialize(
            coordinator_address=args.dist_coordinator,
            num_processes=args.dist_num_processes,
            process_id=args.dist_process_id, device=device.type):
        device = distributed.device()
        distributed.warmup_collectives()
    try:
        return _train(args, cfg, device)
    finally:
        distributed.shutdown()


def _train(args, cfg, device) -> int:
    from outgridvit_tpu_torch.parallel import distributed

    model_cfg = cfg.get("model", {})
    data_cfg = cfg.get("data", {})
    train_cfg = cfg.get("training", {})
    runtime_cfg = cfg.get("runtime", {})
    on_card = device.type == "cuda"

    if "device_augment" not in data_cfg:
        if args.device_augment == "auto":
            data_cfg["device_augment"] = on_card
        else:
            data_cfg["device_augment"] = args.device_augment == "on"
    elif args.device_augment != "auto":
        data_cfg["device_augment"] = args.device_augment == "on"

    if args.steps_per_dispatch is not None:
        train_cfg["steps_per_dispatch"] = args.steps_per_dispatch
    if "steps_per_dispatch" not in train_cfg:
        train_cfg["steps_per_dispatch"] = 8 if on_card else 1

    from outgridvit_tpu_torch.data import build_dataloaders
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.parallel import make_mesh
    from outgridvit_tpu_torch.training.loop import _dtype_from_cfg, train_model

    seed = int(runtime_cfg.get("seed", 7))
    output_dir = Path(runtime_cfg.get("output_dir", "outputs"))
    output_dir.mkdir(parents=True, exist_ok=True)

    use_amp = bool(train_cfg.get("use_amp", True))
    autocast_dtype = str(train_cfg.get("autocast_dtype", "bf16"))
    model = build_model(model_cfg,
                        dtype=_dtype_from_cfg(autocast_dtype, use_amp),
                        device=device, seed=seed)
    num_classes = int(model_cfg.get("num_classes", 100))
    train_loader, val_loader, _ = build_dataloaders(data_cfg, num_classes,
                                                    seed=seed)
    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(","))
                     if args.mesh else None)
    # per-rank input pipelines: each data rank's rows of every global batch
    train_loader = distributed.shard_loader_for_process(train_loader, mesh)
    val_loader = distributed.shard_loader_for_process(val_loader, mesh)

    save_path = Path(train_cfg.get("save_path", "best_model.ckpt"))
    last_path = Path(train_cfg.get("last_path", "last_model.ckpt"))
    if not save_path.is_absolute():
        save_path = output_dir / save_path
    if not last_path.is_absolute():
        last_path = output_dir / last_path

    history, _ = train_model(
        model=model,
        train_loader=train_loader,
        epochs=int(train_cfg.get("epochs", 1)),
        val_loader=val_loader,
        device=device,
        lr=float(train_cfg.get("lr", 5e-4)),
        weight_decay=float(train_cfg.get("weight_decay", 0.05)),
        autocast_dtype=autocast_dtype,
        use_amp=use_amp,
        grad_clip_norm=train_cfg.get("grad_clip_norm", 1.0),
        warmup_ratio=float(train_cfg.get("warmup_ratio", 0.05)),
        min_lr=float(train_cfg.get("min_lr", 0.0)),
        label_smoothing=float(train_cfg.get("label_smoothing", 0.1)),
        print_every=int(train_cfg.get("print_every", 100)),
        save_path=str(save_path),
        last_path=str(last_path),
        resume_path=train_cfg.get("resume_path", None),
        mixup_alpha=float(train_cfg.get("mixup_alpha", 0.0)),
        cutmix_alpha=float(train_cfg.get("cutmix_alpha", 0.0)),
        mix_prob=float(train_cfg.get("mix_prob", 1.0)),
        num_classes=num_classes,
        channels_last=bool(train_cfg.get("channels_last", False)),
        early_stop=bool(train_cfg.get("early_stop", True)),
        early_stop_metric=str(train_cfg.get("early_stop_metric", "top1")),
        early_stop_patience=int(train_cfg.get("early_stop_patience", 10)),
        early_stop_min_delta=float(train_cfg.get("early_stop_min_delta",
                                                 0.0)),
        early_stop_require_monotonic=bool(
            train_cfg.get("early_stop_require_monotonic", False)),
        seed=seed,
        mesh=mesh,
        steps_per_dispatch=int(train_cfg.get("steps_per_dispatch", 1)),
    )

    if distributed.is_main_process():
        if args.history_out:
            from outgridvit_tpu_torch.utils.history import save_history

            save_history(history, args.history_out)
            print(f"History saved to {args.history_out}")
        print("Training complete. History keys:", sorted(history.keys()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
