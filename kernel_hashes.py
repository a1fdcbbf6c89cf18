#!/usr/bin/env python3
"""Whether two trees' kernels give bitwise-equal outputs on the card.

    python3 kernel_hashes.py OUT.json [--root TREE]
    python3 kernel_hashes.py --compare A.json B.json

The first form builds the kernels of the repository at TREE (this file's
own by default, e.g. a ``git archive`` checkout of another commit), calls
every kernel wrapper of ``chip_smoke.py`` once at every stage shape of its
cases (the forward at batch 64, the backward at 128, both at a case's
``compare_batch`` where it has one, in fp32 and bf16;
the outlook kernels at the outlookers' shapes, the depthwise ones at the
MBConvs'; the outlook forward and backward also at every
``OUTLOOK_SHAPES`` entry, at batch 64 and 128, and #9 at every
``OUTLOOK_SHAPES`` entry (K = 3) and at Model B's front with K = 5, at
batch 64, through the kernel their dtype, K and shape route to), on inputs
drawn from a seed fixed per (case, direction, dtype) or (shape, kernel,
dtype),
and writes the SHA-256 of each output's bytes, keyed by case, kernel, shape
and dtype. The inputs depend only on ``chip_smoke.py``'s shapes and its
input makers, so two trees that share those get the same inputs. The
second form lists the calls only one file hashes (a case one tree lacks),
then, of the calls both hash, those whose outputs differ and the kernels
whose every call is bitwise equal. Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path


def hashes(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from outgridvit_tpu_torch.ops import kernel_build

    if not Path(kernel_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {kernel_build.__file__}, not {root}'s")
    kernel_build.build()
    kernel_build.load()
    kernel_build.load_layouts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = cs.Smoke(torch.device("cuda"), "")
    out = {}

    def record(key, got):
        got = (got,) if torch.is_tensor(got) else got
        out[key] = [hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                   .numpy().tobytes()).hexdigest()
                    for t in got]

    for ci, case in enumerate(cs.CASES):
        outlook = (("outlook_agg", "outlook_branch", "outlook_softmax")
                   if case.front else ())
        # (an older tree's cases have no compare_batch)
        small = getattr(case, "compare_batch", None)
        for backward, batch in ((False, small or cs.BATCH),
                                (True, small or cs.TRAIN_BATCH)):
            shapes = cs.stage_shapes(case, batch)
            for di, dtype in enumerate((torch.float32, torch.bfloat16)):
                smoke.gen.manual_seed(1000 * ci + 10 * backward + di)
                for name, args, label, *_ in smoke.cases(
                        shapes, backward, dtype, outlook, dw=True):
                    kern = smoke.launch.get(name, smoke.kernels[name][0])
                    record(f"{case.tag}|{name}|{label}|{dtype}", kern(*args))
                torch.cuda.empty_cache()
    shapes = [(cfg, sh) for cfg, shs in cs.OUTLOOK_SHAPES.items()
              for sh in shs]
    for si, (cfg, (H, C, heads)) in enumerate(shapes):
        for ki, base in enumerate(cs.OUTLOOK):
            for backward, batch, seed in ((True, cs.TRAIN_BATCH, 100_000),
                                          (False, cs.BATCH, 200_000)):
                name = base + ("_bwd" if backward else "")
                for di, dtype in enumerate((torch.float32, torch.bfloat16)):
                    smoke.gen.manual_seed(seed + 100 * si + 10 * ki + di)
                    args = smoke.outlook_args(base, batch, H, C, heads, dtype,
                                              backward=backward)
                    record(f"{cfg}|{name}|B={batch} H=W={H} C={C} "
                           f"heads={heads}|{dtype}",
                           smoke.kernels[name][0](*args))
                    del args
                torch.cuda.empty_cache()
    # #9 at every outlooker shape (K = 3) and at Model B's front with K = 5,
    # through the kernel its dtype, K and shape route to
    softmax = [(cfg, *sh, 3) for cfg, sh in shapes]
    softmax.append(("model_b front", *cs.OUTLOOK_SHAPES["model_b front"][0],
                    5))
    for si, (cfg, H, C, heads, k) in enumerate(softmax):
        for di, dtype in enumerate((torch.float32, torch.bfloat16)):
            smoke.gen.manual_seed(300_000 + 10 * si + di)
            args = smoke.softmax_args(cs.BATCH, H, C, heads, k, dtype)
            record(f"{cfg}|outlook_softmax|B={cs.BATCH} H=W={H} C={C} "
                   f"heads={heads} K={k}|{dtype}",
                   smoke.kernels["outlook_softmax"][0](*args))
            del args
    return out


def compare(a: dict, b: dict) -> None:
    for label, only in (("A", set(a) - set(b)), ("B", set(b) - set(a))):
        for k in sorted(only):
            print(f"only in {label}: {k}")
    both = [k for k in a if k in b]
    diff = [k for k in both if a[k] != b[k]]
    print(f"{len(both)} kernel calls in both: {len(both) - len(diff)} "
          f"bitwise equal, {len(diff)} differ")
    for k in diff:
        print(f"differs: {k}")
    names = {k.split("|")[1] for k in both}
    print("kernels whose every call is bitwise equal:",
          sorted(n for n in names
                 if not any(k.split("|")[1] == n for k in diff)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", help="where to write the hashes")
    p.add_argument("--root", default=str(Path(__file__).resolve().parent),
                   help="the repository whose kernels are hashed")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    a = p.parse_args()
    if a.compare:
        compare(*(json.loads(Path(f).read_text()) for f in a.compare))
        return 0
    if not a.out:
        p.error("give OUT.json or --compare A B")
    import torch

    if not torch.cuda.is_available():
        print("kernel_hashes: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    got = hashes(Path(a.root).resolve())
    Path(a.out).write_text(json.dumps(got, indent=0))
    print(f"{a.root}: {len(got)} kernel calls hashed in "
          f"{time.perf_counter() - t0:.1f} s -> {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
