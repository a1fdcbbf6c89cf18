"""Train the baseline zoo under the OutGridViT recipe with the PyTorch port
(twin of ``scripts/train_cifar32_baselines.py``): the same flags and
defaults, one model per ``--models`` entry, through the same
``train_model`` arguments, the same summary lines.

    python -m outgridvit_tpu_torch.train_cifar32_baselines \\
        [--models maxvit_nano_cifar resnet18_cifar ...] [--device cuda|cpu]

``--device`` defaults to the card; ``cpu`` is the only way onto the CPU,
and a card asked for but absent exits 2, as the port's other CLIs do. On
the card the augmentation recipe runs in the train step (the port's train
CLI's ``--device-augment auto``), on the CPU on the host. Each model is
built (``models/baselines.py:build_baseline``) at the loop's compute
dtype, bf16, as ``train_model``'s defaults ask.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="CIFAR-32 baseline comparisons (PyTorch port, CUDA)")
    ap.add_argument("--models", nargs="+",
                    default=["deit_tiny_patch4", "deit_small_patch4",
                             "swin_tiny_patch2", "maxvit_nano_cifar",
                             "maxvit_tiny_cifar", "resnet18_cifar"],
                    help="baseline names (models/baselines.py); the default "
                         "is the reference's six-model comparison set")
    ap.add_argument("--dataset", default="cifar100")
    ap.add_argument("--data-dir", default="./data")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--img-size", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=100)
    ap.add_argument("--val-split", type=float, default=0.1)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--output-dir", default="outputs/baselines")
    ap.add_argument("--seed", type=int, default=7)
    # the shared recipe
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--warmup-ratio", type=float, default=0.05)
    ap.add_argument("--mix-prob", type=float, default=0.5)
    ap.add_argument("--mixup-alpha", type=float, default=0.8)
    ap.add_argument("--cutmix-alpha", type=float, default=1.0)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--print-every", type=int, default=200)
    ap.add_argument("--num-samples", type=int, default=512,
                    help="synthetic dataset size (dataset=synthetic)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)

    from outgridvit_tpu_torch.train import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from outgridvit_tpu_torch.data import build_dataloaders
    from outgridvit_tpu_torch.models.baselines import build_baseline
    from outgridvit_tpu_torch.training.loop import _dtype_from_cfg, train_model

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    data_cfg = {
        "dataset": args.dataset,
        "data_dir": args.data_dir,
        "batch_size": args.batch_size,
        "num_workers": args.num_workers,
        "val_split": args.val_split,
        "img_size": args.img_size,
        "num_samples": args.num_samples,
        "seed": args.seed,
        # the augmentation recipe in the step on the card, as the port's
        # train CLI runs it (the card's machine has no PIL for the host's
        # RandAugment); on the host on the CPU
        "device_augment": device.type == "cuda",
    }
    train_loader, val_loader, _ = build_dataloaders(
        data_cfg, args.num_classes, seed=args.seed)

    summaries = {}
    for name in args.models:
        print(f"\n##### Baseline: {name} #####")
        model = build_baseline(name, args.num_classes,
                               dtype=_dtype_from_cfg("bf16", True),
                               device=device, seed=args.seed,
                               img_size=args.img_size)
        history, _ = train_model(
            model=model,
            train_loader=train_loader,
            epochs=args.epochs,
            val_loader=val_loader,
            device=device,
            lr=args.lr,
            weight_decay=args.weight_decay,
            warmup_ratio=args.warmup_ratio,
            label_smoothing=args.label_smoothing,
            mixup_alpha=args.mixup_alpha,
            cutmix_alpha=args.cutmix_alpha,
            mix_prob=args.mix_prob,
            num_classes=args.num_classes,
            print_every=args.print_every,
            save_path=str(out_dir / f"best_{name}.ckpt"),
            last_path=str(out_dir / f"last_{name}.ckpt"),
            early_stop=False,
            seed=args.seed,
        )
        best_val = max(history["val_top1"]) if history["val_top1"] else None
        summaries[name] = {
            "final_train_top1": history["train_top1"][-1],
            "best_val_top1": best_val,
        }

    print("\n===== Baseline summary =====")
    for name, s in summaries.items():
        bv = (f"{s['best_val_top1']:.2f}%" if s["best_val_top1"] is not None
              else "n/a")
        print(f"{name}: train top1 {s['final_train_top1']:.2f}% | best val "
              f"top1 {bv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
