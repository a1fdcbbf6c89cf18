"""Every layout of the fused outlook softmax's bf16 row kernel
(``csrc/outlook_softmax_rows.cu``, TPU kernel #9 at K = 3) timed against
``csrc/outlook_softmax.cu`` at every ``chip_smoke.py:OUTLOOK_SHAPES``
entry (batch 64; Model B's front also at 128). Per shape: the old kernel,
then each (rows, pix) layout the kernel takes (tiles of 1, 2, 3, 4, 6, 8,
12, 16, ... rows up to H; runs of 4 and 2 pixels), each in device time
(``chip_smoke.graph_ms``: calls in one CUDA graph) with its share of the
bound, and each output held bit for bit to the old kernel's and the plain
version's; the plan's choice (``ops/outlook_softmax.py:
outlook_softmax_plan``) marked. Ends with one JSON line of the same. Needs
nvcc and one card; imports no JAX; run from the repository's root::

    python -m outgridvit_tpu_torch.ops.outlook_softmax_sweep
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops import outlook_softmax as osm

ROWS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def sweep(B: int, H: int, C: int, heads: int, gpu: str, iters=20):
    """{layout: µs a launch} at one shape, the old kernel's as "old"."""
    g = torch.Generator().manual_seed(B + H + C)
    v = torch.randn(B, H, H, C, generator=g).to("cuda", torch.bfloat16)
    logits = (2 * torch.randn(B, H, H, heads * 9, generator=g)).to(
        "cuda", torch.bfloat16)
    rows_entry, old_entry = osm.ENTRIES
    want = osm.outlook_softmax_agg_reference(v, logits, heads)
    old = osm._launch(old_entry, v, logits, heads)
    if not torch.equal(old, want):
        raise RuntimeError(f"B={B} H=W={H} C={C}: the old kernel is not "
                           "bitwise the plain version")
    bound = max(cs.bound_ms("outlook_softmax", (v, logits, heads, 3), old,
                            torch.bfloat16))
    chosen = osm.outlook_softmax_plan(B, H, H, C, heads)
    res = {"old": cs.graph_ms(lambda: osm._launch(old_entry, v, logits,
                                                  heads), 4) * 1e3}
    for pix in osm.PIX_RUNS:
        for rows in (r for r in ROWS if r <= H):
            plan = osm._rows_plan(B, H, H, C, heads, rows, pix)
            if plan is None:
                continue
            got = osm._launch(rows_entry, v, logits, heads, plan=plan)
            if not torch.equal(got, want):
                raise RuntimeError(f"B={B} H=W={H} C={C} rows={rows} "
                                   f"pix={pix}: not bitwise the plain "
                                   "version")
            key = f"rows={rows} pix={pix}"
            res[key] = cs.graph_ms(lambda p=plan: osm._launch(
                rows_entry, v, logits, heads, plan=p), iters) * 1e3
            mark = " <- plan" if plan == chosen else ""
            print(f"[sweep] B={B} H=W={H} C={C} heads={heads} {key} "
                  f"({plan.tiles} tiles, {plan.blocks} blocks, "
                  f"{plan.smem} B): {res[key]:.2f} us, "
                  f"{bound * 1e3 / res[key]:.1%} of the bound{mark} [{gpu}]")
    best = min((k for k in res if k != "old"), key=res.get)
    print(f"[sweep] B={B} H=W={H} C={C} heads={heads}: old kernel "
          f"{res['old']:.2f} us; best {best} {res[best]:.2f} us; plan "
          f"rows={chosen.rows} pix={chosen.pix} "
          f"{res[f'rows={chosen.rows} pix={chosen.pix}']:.2f} us; bound "
          f"{bound * 1e3:.2f} us [{gpu}]")
    return {"bound_us": bound * 1e3, "plan": [chosen.rows, chosen.pix],
            "us": res}


def main() -> int:
    if not torch.cuda.is_available():
        print("outlook_softmax_sweep: no CUDA device", file=sys.stderr)
        return 1
    kernel_build.load()
    gpu = cs.gpu_name_and_power_limit()
    shapes = [(cs.BATCH, *sh) for shs in cs.OUTLOOK_SHAPES.values()
              for sh in shs]
    shapes.append((cs.TRAIN_BATCH, *cs.OUTLOOK_SHAPES["model_b front"][0]))
    out = {f"B={B} H=W={H} C={C} heads={heads}": sweep(B, H, C, heads, gpu)
           for B, H, C, heads in shapes}
    print(json.dumps({"gpu": gpu, "sweep": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
