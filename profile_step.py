"""Where the device time of one bf16 train step of the port goes on the
card: the kernel-path step that ``chip_smoke.py`` drives (its cases, random
weights from its seed, its train batch: 128, or 32 for ``a7m_192``; one
step's draws sampled beforehand),
traced by ``torch.profiler`` over 3 steps after 3 warm-up ones.

Prints, per step: the wall time (CUDA events), the device busy time (the
union of the traced device intervals) and idle share (1 - busy / wall),
the device kernels launched, the device time of each of the port's kernel
sources (``csrc/``: the file that defines the ``__global__`` function a
kernel's symbol names) and of each kind of PyTorch kernel, and the 15
costliest kernels; then one JSON line of the same. The profiler's own host
work lengthens the step, so the idle share reads high. Needs one card::

    python3 profile_step.py [tin200|model_b|a7m|...]   # default tin200
"""

from __future__ import annotations

import json
import re
import sys
from collections import defaultdict

import chip_smoke as cs

STEPS, WARMUP = 3, 3
# kinds of PyTorch kernel, by their symbol (first match)
KINDS = (("gemm", r"gemm|cutlass|xmma|cublas|nvjet|sm90_"),
         ("convolution", r"conv|cudnn|implicit"),
         ("reduction", r"reduce|norm|softmax|sum|argmax"),
         ("copy / cast / fill", r"copy|memcpy|memset|fill|cat|index"),
         ("elementwise", r"elementwise|vectorized|unrolled"),
         ("other", r""))


def port_kernels() -> dict:
    """{kernel: its source} of every ``__global__`` function in ``csrc/``."""
    from outgridvit_tpu_torch.ops.kernel_build import CSRC_DIR

    out = {}
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\("
                             r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
                             src.read_text()):
            out[m.group(1)] = f"csrc/{src.name}"
    return out


def group(name: str, port: dict) -> str:
    """The port's source of a kernel of ``csrc/`` (by the function its
    demangled symbol names), else the kind of PyTorch kernel."""
    m = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::|ogvt::"
                 r"(?:\w+::)*)(\w+)", name)
    if m and m.group(1) in port:
        return port[m.group(1)]
    low = name.lower()
    return next(kind for kind, pat in KINDS if re.search(pat, low))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.models.layers import DropPath
    from outgridvit_tpu_torch.ops.augment import AugmentConfig
    from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
    from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        make_train_step,
        sample_step_draws,
    )
    from outgridvit_tpu_torch.training.train_state import TrainState

    if not torch.cuda.is_available():
        print("profile_step.py: no CUDA device", file=sys.stderr)
        return 1
    tag = sys.argv[1] if len(sys.argv) > 1 else "tin200"
    case = next(c for c in cs.CASES if c.tag == tag)
    gpu = cs.gpu_name_and_power_limit()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED)
    T, B = case.train, case.train_batch
    classes = case.model["num_classes"]
    step_cfg = StepConfig(
        num_classes=classes, label_smoothing=T["label_smoothing"],
        mixup_alpha=T["mixup_alpha"], cutmix_alpha=T["cutmix_alpha"],
        mix_prob=T["mix_prob"], grad_clip_norm=T["grad_clip_norm"],
        augment=AugmentConfig(mean=case.mean, std=case.std,
                              crop_pad=case.crop_pad))
    lr = warmup_cosine_lr(T["lr"], 10_000, 500, T["min_lr"])
    step = make_train_step(step_cfg, lr)
    images = torch.randint(0, 256, (B, case.img, case.img, 3),
                           dtype=torch.uint8, generator=gen).to(dev)
    labels = torch.randint(0, classes, (B,), generator=gen).to(dev)
    model = build_model(case.model, dtype=torch.bfloat16, use_kernels=True,
                        device=dev, seed=cs.SEED, dwconv=case.dwconv,
                        attn_nhwc=case.attn_nhwc)
    state = TrainState.create(model, AdamW(lr, T["weight_decay"],
                                           T["grad_clip_norm"]))
    draws = sample_step_draws(gen, step_cfg, tuple(images.shape), dev)
    draws = draws._replace(drop_masks=DropPathMasks({
        m.path: torch.rand(B, generator=gen) < 1.0 - m.rate
        for m in model.modules() if isinstance(m, DropPath) and m.rate > 0}))

    for _ in range(WARMUP):
        step(state, (images, labels), draws)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(STEPS):
            step(state, (images, labels), draws)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / STEPS

    port = port_kernels()
    spans, by_group, by_name = [], defaultdict(float), defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_group[group(e.name, port)] += (t1 - t0) / 1e3 / STEPS
        by_name[e.name] += (t1 - t0) / 1e3 / STEPS
    busy, last = 0.0, None
    for t0, t1 in sorted(spans):  # the union of the device intervals
        if last is None or t0 > last:
            busy += t1 - t0
            last = t1
        elif t1 > last:
            busy += t1 - last
            last = t1
    busy /= 1e3 * STEPS
    if not spans:
        print(f"[profile] {tag}: the trace holds no device time (not "
              f"measured); step {wall:.3f} ms [{gpu}]")
        return 1
    out = {"case": tag, "batch": B, "dtype": "bfloat16", "gpu": gpu,
           "step_ms": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall,
           "device_kernels": len(spans) / STEPS,
           "by_group_ms": dict(sorted(by_group.items(),
                                      key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:15])}
    print(f"[profile] {tag} bf16 train step, batch {B}, kernel path, "
          f"{STEPS} steps after {WARMUP}: {wall:.3f} ms a step, device busy "
          f"{busy:.3f} ms, idle share {out['idle_share']:.3f}, "
          f"{out['device_kernels']:.0f} device kernels [{gpu}]")
    for name, ms in out["by_group_ms"].items():
        print(f"[profile]   {name}: {ms:.3f} ms ({ms / busy:.1%} of busy)")
    for name, ms in out["top_kernels_ms"].items():
        print(f"[profile]   top {ms:.3f} ms {name[:140]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
