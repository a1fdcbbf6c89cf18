"""Corruption-robustness evaluation (twin of ``scripts/eval_robustness.py``):
CIFAR-100-C / Tiny-ImageNet-C sweeps of a checkpoint in one command.

    python -m outgridvit_tpu_torch.eval_robustness \\
        --config configs/cifar100_model_a_7m.yaml \\
        --checkpoint outputs/best_cifar100_model_a_7m.pt --suite cifar100c \\
        --data-dir ./data
    python -m outgridvit_tpu_torch.eval_robustness \\
        --config configs/tinyimagenet200_model_a.yaml \\
        --checkpoint outputs/best.pt --suite tinyc --severities 1 3 5

The model computes in bf16 on the card unless ``--device cpu`` (or the
config's ``runtime.device: cpu``) asks for the CPU. One eval step and one
eval superstep serve the whole sweep, so the eval graph is captured once
per input shape, not once per setting. Batches travel as uint8 and are
normalized in the step unless ``--host-normalize``. The Tiny-ImageNet-C
suite needs PIL and the HF ``datasets`` package (for the clean wnid map),
which the GPU machine lacks. ``--json-out`` gets ``{"rows": [...],
"summary": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Corruption robustness eval")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--suite", required=True, choices=["cifar100c", "tinyc"])
    ap.add_argument("--data-dir", default=None,
                    help="corruption dataset root (default: data.data_dir)")
    ap.add_argument("--corruptions", nargs="*", default=None)
    ap.add_argument("--severities", nargs="*", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--eval-k", type=int, default=8,
                    help="batches per eval graph replay")
    ap.add_argument("--host-normalize", action="store_true",
                    help="normalize on the host (float32 wire) instead of "
                    "the default uint8 wire + normalize in the step")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="override the config's runtime.device")
    ap.add_argument("--json-out", default="robustness_results.json")
    args = ap.parse_args(argv)

    import torch

    from outgridvit_tpu_torch.data.corruptions import (
        CIFAR100_MEAN,
        CIFAR100_STD,
        IMAGENET_MEAN,
        IMAGENET_STD,
        evaluate_cifar100c_suite,
        evaluate_tinyc_suite,
        summarize_corruption_results,
    )
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.train import resolve_device
    from outgridvit_tpu_torch.training.bench_eval import (
        evaluate_one_epoch_logs,
    )
    from outgridvit_tpu_torch.training.steps import (
        make_eval_step,
        make_eval_superstep,
    )
    from outgridvit_tpu_torch.utils.config import load_config

    cfg = load_config(Path(args.config))
    try:
        device = resolve_device(
            args.device or cfg.get("runtime", {}).get("device", "cuda"))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    model_cfg = cfg.get("model", {})
    data_dir = args.data_dir or str(cfg.get("data", {}).get("data_dir",
                                                            "./data"))
    img_size = int(cfg.get("data", {}).get("img_size", 32))

    model = build_model(model_cfg, dtype=torch.bfloat16, device=device)
    if args.checkpoint:
        from outgridvit_tpu_torch.training.checkpoints import (
            load_model_variables,
        )

        load_model_variables(args.checkpoint, model)  # before any capture
        print(f"Loaded {args.checkpoint}")

    # default: the uint8 wire + normalize in the step (4x less transfer)
    # and K batches per eval graph replay
    device_normalize = not args.host_normalize
    norm = None
    if device_normalize:
        norm = ((CIFAR100_MEAN, CIFAR100_STD) if args.suite == "cifar100c"
                else (IMAGENET_MEAN, IMAGENET_STD))
    k = max(1, args.eval_k)
    eval_step = make_eval_step(model, normalize=norm)
    eval_superstep = (make_eval_superstep(model, normalize=norm, k=k)
                      if k > 1 else None)

    def evaluate_one_epoch_fn(loader):
        m = evaluate_one_epoch_logs(
            eval_step, model, loader, data_shard=device, warmup_batches=0,
            verbose=False, eval_superstep=eval_superstep, k=k)
        return m["loss"], {key: m[key] for key in ("top1", "top3", "top5")}

    if args.suite == "cifar100c":
        rows = evaluate_cifar100c_suite(
            evaluate_one_epoch_fn, data_dir,
            corruptions=args.corruptions or None,
            severities=tuple(args.severities or (1, 2, 3, 4, 5)),
            batch_size=args.batch_size, device_normalize=device_normalize)
    else:
        from outgridvit_tpu_torch.data.datasets import (
            tinyimagenet_wnid_to_label,
        )

        wnid_map = tinyimagenet_wnid_to_label(
            str(cfg.get("data", {}).get("data_dir", "./data")))
        rows = evaluate_tinyc_suite(
            evaluate_one_epoch_fn, wnid_map, data_dir,
            corruptions=args.corruptions or None,
            severities=tuple(args.severities or (1, 3, 5)),
            batch_size=args.batch_size, img_size=img_size,
            device_normalize=device_normalize)

    summary = summarize_corruption_results(rows)
    print("\n=== Robustness summary ===")
    print(f"overall top1 {summary['overall_top1']:.2f}% over "
          f"{summary['n_settings']} settings")
    for s, v in summary["by_severity"].items():
        print(f"  severity {s}: {v:.2f}%")
    Path(args.json_out).write_text(
        json.dumps({"rows": rows, "summary": summary}, indent=2))
    print(f"Wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
