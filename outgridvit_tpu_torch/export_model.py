"""Export a trained model as a standalone serving artifact (twin of
``scripts/export_model.py``): ``serving.py:export_predictor``, a
``torch.export`` program with the weights in it; loading it needs neither
the model code nor the checkpoint, only this package's ``ogvt::`` op
library (``ops/library.py``).

    python -m outgridvit_tpu_torch.export_model \\
        --config configs/cifar100_model_a_7m.yaml \\
        --checkpoint outputs/best_cifar100_model_a_7m.pt --batch-size 64 \\
        --out model.ogvt
    # the portable artifact (plain path on the CPU), with a round trip:
    python -m outgridvit_tpu_torch.export_model \\
        --config configs/smoke_synthetic.yaml --device cpu --out /tmp/m.ogvt \\
        --selfcheck

The default exports the kernel path on the card (bf16, kernels as ops);
``--device cpu`` (or the config's ``runtime.device: cpu``) exports the plain
path on the CPU, as the JAX script's XLA-only export is its portable one.
The normalization baked into the artifact comes from the config's dataset
(``data.mean`` / ``data.std`` where set); an unknown dataset without them is
refused. ``--selfcheck`` reloads the artifact and requires the live
predictor's labels and probabilities within 1e-6.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Export a serving artifact")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", required=True)
    ap.add_argument("--selfcheck", action="store_true",
                    help="reload the artifact and verify it reproduces the "
                    "live predictor's outputs")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="override the config's runtime.device: cuda "
                    "exports the kernel path, cpu the portable plain path")
    args = ap.parse_args(argv)

    import numpy as np

    from outgridvit_tpu_torch.data import datasets as D
    from outgridvit_tpu_torch.serving import (
        build_predictor,
        export_predictor,
        load_predictor,
    )
    from outgridvit_tpu_torch.train import resolve_device
    from outgridvit_tpu_torch.utils.config import load_config

    cfg = load_config(Path(args.config))
    # the artifact bakes the normalization in: the stats must match what
    # the model was trained with, so they come from the config's dataset
    # (the loaders' mapping), never a silent cross-dataset default
    stats = {
        "cifar100": (D.CIFAR100_MEAN, D.CIFAR100_STD),
        "svhn": (D.SVHN_MEAN, D.SVHN_STD),
        "tinyimagenet200": (D.IMAGENET_MEAN, D.IMAGENET_STD),
        "food101": (D.IMAGENET_MEAN, D.IMAGENET_STD),
        "pets": (D.IMAGENET_MEAN, D.IMAGENET_STD),
        "synthetic": ((0.5,) * 3, (0.25,) * 3),
    }
    data_cfg = cfg.get("data", {})
    if "mean" in data_cfg and "std" in data_cfg:
        mean, std = data_cfg["mean"], data_cfg["std"]
    else:
        dataset = str(data_cfg.get("dataset", "")).lower()
        if dataset not in stats:
            ap.error(f"unknown dataset {dataset!r}: set data.mean/data.std "
                     "in the config so the artifact bakes the right "
                     "normalization")
        mean, std = stats[dataset]

    try:
        device = resolve_device(
            args.device or cfg.get("runtime", {}).get("device", "cuda"))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    img = int(data_cfg.get("img_size", 32))
    pred = build_predictor(
        cfg["model"], checkpoint=args.checkpoint,
        batch_size=args.batch_size, img_size=img, mean=mean, std=std,
        device=device)
    t0 = time.perf_counter()
    export_predictor(pred, args.out)
    seconds = time.perf_counter() - t0
    print(f"Exported {args.out} "
          f"({Path(args.out).stat().st_size / 1e6:.1f} MB, "
          f"batch {pred.batch_size}, {img}px, {pred.num_classes} classes, "
          f"{device.type}, kernels {'on' if pred.kernels else 'off'}) in "
          f"{seconds:.2f} s")

    if args.selfcheck:
        rng = np.random.default_rng(0)
        x = rng.integers(0, 255, (3, img, img, 3), dtype=np.uint8)
        l1, p1 = pred.predict(x)
        l2, p2 = load_predictor(args.out).predict(x)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_allclose(p1, p2, rtol=1e-6, atol=1e-6)
        print("selfcheck OK: reloaded artifact matches the live predictor")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
