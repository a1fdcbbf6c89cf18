"""Ablation suite (twin of ``scripts/run_ablations.py``): the full
OutGridBlock vs no-Outlooker vs no-GridAttn vs plain-MBConv vs no-MBConv,
under one recipe, each trained by the port's ``train_model``.

    python -m outgridvit_tpu_torch.run_ablations \\
        --config configs/cifar100_model_a_7m.yaml --epochs 1 \\
        --output-dir outputs/ablations --json-out ablations.json
    python -m outgridvit_tpu_torch.run_ablations \\
        --config configs/smoke_synthetic.yaml --device cpu

The JAX script's ``ABLATIONS`` table and flags, plus ``--device`` (the
card by default; ``cpu`` is the only way onto the CPU, and a card asked
for and not found exits 2). A zero head count or ``use_mbconv: false``
skips its branch in every stage (``models/blocks.py:OutGridBlock``). As
the train CLI does, the model computes in the config's compute dtype, the
train augmentation runs in the step on the card (``data.device_augment``
unless the config sets it) and full groups of
``training.steps_per_dispatch`` batches (8 on the card, 1 on the CPU,
unless set) run through the train and eval CUDA graphs. Each ablation
writes ``best_<name>.ckpt``, ``last_<name>.ckpt`` and
``history_<name>.pkl`` under ``--output-dir``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

ABLATIONS = {
    "full": {},
    "no_outlooker": {"outlook_heads": 0},
    "no_grid": {"num_heads": 0},
    "plain_mbconv": {"outlook_heads": 0, "num_heads": 0},
    "no_mbconv": {"use_mbconv": False},
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="OutGridBlock ablations")
    ap.add_argument("--config", required=True, help="base YAML config")
    ap.add_argument("--ablations", nargs="+", default=list(ABLATIONS),
                    choices=list(ABLATIONS))
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--output-dir", default="outputs/ablations")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from outgridvit_tpu_torch.data import build_dataloaders
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.train import resolve_device
    from outgridvit_tpu_torch.training.loop import (
        _dtype_from_cfg,
        train_model,
    )
    from outgridvit_tpu_torch.utils.config import load_config
    from outgridvit_tpu_torch.utils.history import save_history

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"

    cfg = load_config(Path(args.config))
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    num_classes = int(cfg["model"].get("num_classes", 100))
    seed = int(cfg.get("runtime", {}).get("seed", 7))
    data_cfg = dict(cfg.get("data", {}))
    data_cfg.setdefault("device_augment", on_card)
    train_loader, val_loader, _ = build_dataloaders(
        data_cfg, num_classes, seed=seed)
    tcfg = cfg.get("training", {})
    epochs = args.epochs or int(tcfg.get("epochs", 1))
    autocast_dtype = str(tcfg.get("autocast_dtype", "bf16"))
    use_amp = bool(tcfg.get("use_amp", True))
    k = int(tcfg.get("steps_per_dispatch", 8 if on_card else 1))

    summary = {}
    for name in args.ablations:
        print(f"\n##### Ablation: {name} #####")
        model_cfg = json.loads(json.dumps(cfg["model"]))  # deep copy
        for stage in model_cfg["stages"]:
            stage.update(ABLATIONS[name])
        model = build_model(model_cfg,
                            dtype=_dtype_from_cfg(autocast_dtype, use_amp),
                            device=device, seed=seed)
        history, _ = train_model(
            model=model,
            train_loader=train_loader,
            epochs=epochs,
            val_loader=val_loader,
            device=device,
            lr=float(tcfg.get("lr", 5e-4)),
            weight_decay=float(tcfg.get("weight_decay", 0.05)),
            autocast_dtype=autocast_dtype,
            use_amp=use_amp,
            label_smoothing=float(tcfg.get("label_smoothing", 0.1)),
            mixup_alpha=float(tcfg.get("mixup_alpha", 0.0)),
            cutmix_alpha=float(tcfg.get("cutmix_alpha", 0.0)),
            mix_prob=float(tcfg.get("mix_prob", 1.0)),
            num_classes=num_classes,
            print_every=int(tcfg.get("print_every", 100)),
            save_path=str(out_dir / f"best_{name}.ckpt"),
            last_path=str(out_dir / f"last_{name}.ckpt"),
            early_stop=False,
            seed=seed,
            steps_per_dispatch=k,
        )
        save_history(history, str(out_dir / f"history_{name}.pkl"))
        summary[name] = {
            "final_train_top1": history["train_top1"][-1],
            "best_val_top1": (max(history["val_top1"])
                              if history["val_top1"] else None),
        }

    print("\n===== Ablation summary =====")
    for name, s in summary.items():
        bv = (f"{s['best_val_top1']:.2f}%" if s["best_val_top1"] is not None
              else "n/a")
        print(f"{name}: train top1 {s['final_train_top1']:.2f}% | "
              f"best val {bv}")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
