"""Attention analysis CLI (twin of ``scripts/run_attention_analysis.py``):
outlooker locality plots, grid query heatmaps, MAD metrics (JSON + CSV).

    python -m outgridvit_tpu_torch.run_attention_analysis \\
        --config configs/cifar100_model_a_7m.yaml \\
        --checkpoint outputs/best_cifar100_model_a_7m.pt --split test \\
        --out-dir analysis_out --skip-plots --entropy
    python -m outgridvit_tpu_torch.run_attention_analysis \\
        --config configs/smoke_synthetic.yaml --device cpu --entropy

The JAX script's flags, plus ``--device`` (the card by default; ``cpu`` is
the only way onto the CPU, and a card asked for and not found exits 2).
The model is built in fp32 with ``model.use_pallas: false`` (the XLA-only
path) unless the YAML sets ``model.use_pallas``, as the JAX script's
``use_pallas=False`` yields to the YAML key; its weights are random from
seed 0, or ``--checkpoint``'s (a checkpoint of the port,
``training/checkpoints.py``). The plots need matplotlib, which the card
lacks: pass ``--skip-plots`` there. Model B's front outlookers are swept
under the stage key ``"front"``.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

# per-dataset normalization stats (reference `run_attention_analysis.py:20-25`)
_STATS = {
    "cifar100": ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)),
    "svhn": ((0.4377, 0.4438, 0.4728), (0.1980, 0.2010, 0.1970)),
    "tinyimagenet200": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "tinyimagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "synthetic": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    # datasets.get_synthetic_structured_dataloaders normalizes with
    # mean 0.5 / std 0.25
    "synthetic_structured": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
}


def _pick_loader(loaders, split: str):
    train, val, test = loaders
    if split == "train":
        return train
    if split == "val":
        return val if val is not None else test
    return test if test is not None else train


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="OutGridViT attention analysis")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="trained checkpoint (optional)")
    ap.add_argument("--split", default="test",
                    choices=["train", "val", "test"])
    ap.add_argument("--out-dir", default="analysis_out")
    ap.add_argument("--n-images", type=int, default=8)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--block", default="0",
                    help="block index within each stage, or 'all' to sweep "
                         "every captured block (plots only; MAD metrics use "
                         "block 0 when 'all')")
    ap.add_argument("--skip-plots", action="store_true")
    ap.add_argument("--entropy", action="store_true",
                    help="also compute entropy")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from outgridvit_tpu_torch.data import build_dataloaders
    from outgridvit_tpu_torch.experiments.heatmaps import (
        plot_grid_attention_random,
        plot_outlooker_locality_random,
    )
    from outgridvit_tpu_torch.experiments.mad_entropy import (
        compute_grid_and_outlooker_mad_by_stage,
        compute_grid_and_outlooker_mad_entropy_by_stage,
        print_mad_abs_by_stage_simple,
    )
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.train import resolve_device
    from outgridvit_tpu_torch.utils.config import load_config

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    cfg = load_config(Path(args.config))
    model_cfg = cfg.get("model", {})
    data_cfg = cfg.get("data", {})
    num_classes = int(model_cfg.get("num_classes", 100))

    model = build_model({"use_pallas": False, **model_cfg},
                        dtype=torch.float32, device=device)
    loaders = build_dataloaders(data_cfg, num_classes,
                                seed=int(cfg.get("runtime", {}).get("seed", 7)))
    loader = _pick_loader(loaders, args.split)
    if args.checkpoint:
        from outgridvit_tpu_torch.training.checkpoints import (
            load_model_variables,
        )

        load_model_variables(args.checkpoint, model)
        print(f"Loaded checkpoint {args.checkpoint}")

    dataset = str(data_cfg.get("dataset", "cifar100")).lower()
    mean, std = _STATS.get(dataset, _STATS["cifar100"])

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    plot_block = args.block if args.block == "all" else int(args.block)
    metric_block = 0 if args.block == "all" else int(args.block)
    if not args.skip_plots:
        p1 = plot_outlooker_locality_random(
            model, loader, n_images=min(2, args.n_images),
            seed=args.seed, mean=mean, std=std, out_dir=str(out_dir),
            block_idx=plot_block)
        p2 = plot_grid_attention_random(
            model, loader, n_images=min(2, args.n_images),
            seed=args.seed, mean=mean, std=std, out_dir=str(out_dir),
            block_idx=plot_block)
        print("Saved plots:", *p1, *p2, sep="\n  ")

    stages = tuple(range(len(model_cfg.get("stages", []))))
    # Model B: front Outlooker blocks capture under the "front" stage key
    # (experiments/capture.py) — include them in the MAD/entropy sweep
    if int(model_cfg.get("outlooker_front_depth", 0) or 0) > 0:
        stages = ("front",) + stages
    compute = (compute_grid_and_outlooker_mad_entropy_by_stage
               if args.entropy else compute_grid_and_outlooker_mad_by_stage)
    rows = compute(
        model, loader, block_idx=metric_block, stages=stages,
        n_images=args.n_images, seed=args.seed)

    # write JSON + CSV (reference `run_attention_analysis.py:146-158`)
    (out_dir / "mad_metrics.json").write_text(json.dumps(rows, indent=2))
    if rows:
        with open(out_dir / "mad_metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    print(f"Wrote {out_dir / 'mad_metrics.json'} and .csv ({len(rows)} rows)")
    print_mad_abs_by_stage_simple(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
