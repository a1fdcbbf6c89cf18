"""Timed evaluation benchmark (twin of ``scripts/benchmark_eval.py``): the
CLI surface of ``training/bench_eval.py:evaluate_one_epoch_logs``.

    python -m outgridvit_tpu_torch.benchmark_eval \\
        --config configs/cifar100_model_a_7m.yaml \\
        --checkpoint outputs/best_cifar100_model_a_7m.pt --split test
    python -m outgridvit_tpu_torch.benchmark_eval \\
        --config configs/smoke_synthetic.yaml --device cpu

The model computes in bf16, as the JAX script's does, on the card unless
``--device cpu`` (or the config's ``runtime.device: cpu``) asks for the CPU;
a card asked for and not found exits 2. ``--checkpoint`` is a checkpoint of
the port (``training/checkpoints.py``), restored in place before the eval
graph is captured. ``--eval-k -1`` runs 8 batches per eval graph on the
uint8 wire and 1 otherwise. FLOPs are counted over the plain path on the
``meta`` device (``bench_eval.py``). ``--json-out`` writes the metric dict.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Timed eval benchmark")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--split", default="test",
                    choices=["train", "val", "test"])
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--eval-k", type=int, default=-1,
                    help="batches per eval graph replay "
                    "(-1 auto: 8 on the uint8 wire, 1 otherwise)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="override the config's runtime.device")
    args = ap.parse_args(argv)

    import torch

    from outgridvit_tpu_torch.data import build_dataloaders, peek_loader
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
    data_cfg = dict(cfg.get("data", {}))
    if args.batch_size:
        data_cfg["batch_size"] = args.batch_size
    num_classes = int(model_cfg.get("num_classes", 100))

    model = build_model(model_cfg, dtype=torch.bfloat16, device=device)
    train, val, test = build_dataloaders(
        data_cfg, num_classes, seed=int(cfg.get("runtime", {}).get("seed", 7)))
    loader = {"train": train, "val": val or test or train,
              "test": test or train}[args.split]

    (x0, _), loader_iter = peek_loader(loader)  # shape probe, no batch lost
    if args.checkpoint:
        from outgridvit_tpu_torch.training.checkpoints import (
            load_model_variables,
        )

        load_model_variables(args.checkpoint, model)  # before any capture
        print(f"Loaded {args.checkpoint}")

    normalize = getattr(loader, "device_normalize", None)
    eval_step = make_eval_step(model, normalize=normalize)
    k = args.eval_k
    if k < 0:  # auto: the graph path for the light uint8 wire only
        k = 8 if normalize is not None else 1
    eval_superstep = (make_eval_superstep(model, normalize=normalize, k=k)
                      if k > 1 else None)
    plain = build_model(model_cfg, dtype=torch.bfloat16, use_kernels=False,
                        device="meta")
    metrics = evaluate_one_epoch_logs(
        eval_step, model, loader_iter, data_shard=device,
        model_fn=plain,
        example_batch=torch.zeros(x0.shape, dtype=torch.float32,
                                  device="meta"),
        eval_superstep=eval_superstep, k=k,
    )
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(metrics, indent=2))
        print(f"Wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
