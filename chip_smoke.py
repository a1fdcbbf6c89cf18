#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``outgridvit_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version at every
Model A-7M stage shape in fp32 and bf16, serves requests through
``Predictor`` at the flagship's full width (CIFAR-100 32px, batch 64, bf16,
random weights from a seed), checks that the serving path launched every
kernel, checks the kernel path's logits against the plain path's, and times
kernels and the predictor. Then the train step (batch 128, raw uint8 in,
the full augmentation and mixup/cutmix recipe, AdamW): the backward kernels
against their plain versions at every stage shape (twice, bitwise equal),
one step through the kernels against one through the plain path, the launch
counts per step, 30 steps on one batch (the loss must fall), the non-finite
guard, and timings.

Output: per-phase lines, then the card's ``nvidia-smi`` name and power
limit, then a JSON line ``{"kernels": [...]}`` (forward kernels: launches
and ms per batch-64 serving forward; backward kernels: per batch-128 train
step), then the last line ``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without the last line. Without a CUDA device it exits 1
before doing anything. Imports no JAX and no yaml.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

# The `model:` section of configs/cifar100_model_a_7m.yaml (a test checks
# that the two agree).
FLAGSHIP_MODEL_CFG = {
    "type": "model_a",
    "num_classes": 100,
    "in_ch": 3,
    "stem_dim": 64,
    "dpr_max": 0.07,
    "stages": [
        {"dim": 48, "depth": 1, "num_heads": 2, "grid_size": 8,
         "outlook_heads": 2},
        {"dim": 96, "depth": 2, "num_heads": 3, "grid_size": 8,
         "outlook_heads": 3},
        {"dim": 192, "depth": 3, "num_heads": 6, "grid_size": 4,
         "outlook_heads": 6},
        {"dim": 256, "depth": 1, "num_heads": 8, "grid_size": 2,
         "outlook_heads": 8},
    ],
}
FLAGSHIP_PARAMS = 7_518_102
BATCH = 64
IMG = 32
SEED = 0
DEVICE = "cuda"

# Kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|:
# fp32 differs only by summation order (errors ~1e-6 at these sums of
# <= 1024 O(1) terms); bf16 may flip one final rounding, one bf16 ulp of an
# O(1) value being 2^-8..2^-7 relative.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Logits, as a fraction of max(1, max |plain fp32 logits|): the fp32 kernel
# path reorders fp32 sums only; bf16 carries ~3 significant digits through
# 7 blocks (a half-width model on the CPU measured 1.5% of max |logits|).
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}

# Train step: configs/cifar100_model_a_7m.yaml's `training:` values, with
# bench.py's batch, schedule and augmentation (bench.py:82-123).
TRAIN_BATCH = 128
TRAIN = {"lr": 5e-4, "weight_decay": 0.05, "grad_clip_norm": 1.0,
         "min_lr": 1e-6, "label_smoothing": 0.1, "mixup_alpha": 0.8,
         "cutmix_alpha": 1.0, "mix_prob": 0.5}
MEAN, STD, CROP_PAD = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761), 4
# Parameter gradients of a backward kernel (sums over all M tokens), as a
# fraction of max |plain grad|: fp32 reorders the sums; in bf16 a flipped
# rounding of dh moves a sum by a bf16 ulp of one term, and the result is
# rounded to bf16 once (2^-8 relative).
WGRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# One fp32 train step, kernel path vs plain path (same state and draws):
# loss relative; every param grad as a fraction of the global grad norm;
# params after the update within STEP_PARAM_TOL x the step's lr (Adam moves
# a param by about lr, and a leaf whose exact gradient is 0 gets noise that
# Adam can move either way); BN statistics relative to (1 + |plain|).
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_PARAM_TOL, STEP_STAT_TOL = (
    1e-5, 1e-4, 4.0, 1e-4)
# bf16 kernel step vs the fp32 plain step: loss relative (bf16 keeps ~3
# significant digits through 7 blocks).
BF16_LOSS_TOL = 3e-2
LOSS_STEPS = 30

SOURCES = {
    "grid_mhsa": ("outgridvit_tpu_torch/csrc/grid_mhsa.cu",
                  "outgridvit_tpu/ops/grid_attention_pallas_t.py:270"),
    "mlp_branch": ("outgridvit_tpu_torch/csrc/mlp_branch.cu",
                   "outgridvit_tpu/ops/mlp_branch_pallas_t.py:182"),
    "grid_mhsa_bwd": ("outgridvit_tpu_torch/csrc/grid_mhsa.cu",
                      "outgridvit_tpu/ops/grid_attention_pallas_t.py:319"),
    "mlp_branch_bwd": ("outgridvit_tpu_torch/csrc/mlp_branch_bwd.cu",
                       "outgridvit_tpu/ops/mlp_branch_pallas_t.py:248"),
}


class CheckFailed(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def stage_shapes(batch: int = BATCH):
    """Per stage: the kernels' shapes at ``batch`` and how often one forward
    launches them."""
    out = []
    for si, s in enumerate(FLAGSHIP_MODEL_CFG["stages"]):
        hw = IMG >> si
        g, C = s["grid_size"], s["dim"]
        out.append({
            "stage": si, "blocks": s["depth"], "C": C,
            "G": batch * g * g, "N": (hw // g) ** 2, "heads": s["num_heads"],
            "M": batch * hw * hw, "H_outlook": 2 * C, "H_block": 4 * C,
        })
    return out


def time_ms(fn, args, iters=50, warmup=5):
    """Mean ms per call on the card: CUDA events around ``iters`` calls
    after ``warmup`` ones."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def train_phases(dev, gpu: str) -> dict:
    """Phases 8-13: the train step of Model A-7M at TRAIN_BATCH. Returns the
    backward kernels' launches per step, max errors and per-step times."""
    import torch

    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.models.layers import DropPath
    from outgridvit_tpu_torch.ops.augment import AugmentConfig
    from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
    from outgridvit_tpu_torch.ops.grid_attention import (
        grid_mhsa,
        grid_mhsa_backward,
        grid_mhsa_backward_reference,
    )
    from outgridvit_tpu_torch.ops.mlp_branch import (
        mlp_branch,
        mlp_branch_backward,
        mlp_branch_backward_reference,
    )
    from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        make_train_step,
        sample_step_draws,
    )
    from outgridvit_tpu_torch.training.train_state import TrainState

    shapes = stage_shapes(TRAIN_BATCH)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def grid_args(sh, dtype):
        return (randn(sh["G"], sh["N"], 3 * sh["C"]).to(dtype),
                randn(sh["G"], sh["N"], sh["C"]).to(dtype), sh["heads"])

    def mlp_args(sh, H, dtype, act="gelu", apply_ln=True):
        C, M = sh["C"], sh["M"]
        return (randn(M, C).to(dtype), randn(C, scale=0.1, shift=1.0),
                randn(C, scale=0.1), randn(C, H, scale=C ** -0.5).to(dtype),
                randn(H, scale=0.02).to(dtype),
                randn(H, C, scale=H ** -0.5).to(dtype),
                randn(C, scale=0.02).to(dtype),
                randn(M, C, scale=0.01).to(dtype), act, 1e-5, apply_ln)

    # -- phase 8: each backward kernel against its plain version ----------
    max_err = {"grid_mhsa_bwd": 0.0, "mlp_branch_bwd": 0.0}
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")

    def compare_bwd(name, kernel, plain, args, dtype, label):
        dt = str(dtype).split(".")[-1]
        got = kernel(*args)
        again = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got, again, want = ((t,) if torch.is_tensor(t) else t
                            for t in (got, again, want))
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{name} {label}: two calls differ")
        worst = []
        for gname, g, w in zip(names if len(got) > 1 else ("dqkv",), got,
                               want):
            require(torch.isfinite(g.float()).all().item(),
                    f"{name} {label} {gname}: non-finite")
            diff = (g.float() - w.float()).abs()
            if gname in ("dx", "dqkv"):  # per-element, as the forward
                tol = KERNEL_TOL[dt]
                ok = bool((diff <= tol + tol * w.float().abs()).all())
                max_err[name] = max(max_err[name], diff.max().item())
                worst.append(f"{gname}={diff.max().item():.2e}")
            else:  # sums over all tokens, relative to max |plain grad|
                scale = w.float().abs().max().item()
                rel = diff.max().item() / max(scale, 1e-30)
                ok = rel <= WGRAD_TOL[dt]
                worst.append(f"{gname}={rel:.1e}")
            require(ok, f"{name} {label} {gname}: kernel disagrees with "
                    "plain version")
        print(f"[compare-bwd] {name} {label} {dt} " + " ".join(worst)
              + f" (dx/dqkv abs, tol {KERNEL_TOL[dt]:g} abs+rel; param "
              f"grads rel to max, tol {WGRAD_TOL[dt]:g}) deterministic ok")

    for dtype in (torch.float32, torch.bfloat16):
        for sh in shapes:
            tag = f"stage{sh['stage']}"
            compare_bwd("grid_mhsa_bwd", grid_mhsa_backward,
                        grid_mhsa_backward_reference, grid_args(sh, dtype),
                        dtype, f"{tag} G={sh['G']} N={sh['N']} C={sh['C']} "
                        f"heads={sh['heads']}")
            for H in (sh["H_outlook"], sh["H_block"]):
                compare_bwd("mlp_branch_bwd", mlp_branch_backward,
                            mlp_branch_backward_reference,
                            mlp_args(sh, H, dtype), dtype,
                            f"{tag} M={sh['M']} C={sh['C']} H={H} gelu ln")
        sh = shapes[0]
        for act in ("silu", "relu"):
            compare_bwd("mlp_branch_bwd", mlp_branch_backward,
                        mlp_branch_backward_reference,
                        mlp_args(sh, sh["H_block"], dtype, act, False), dtype,
                        f"stage0 M={sh['M']} C={sh['C']} act={act} ln=False")

    # -- phase 9: one train step, kernel path vs plain path ---------------
    step_cfg = StepConfig(
        num_classes=FLAGSHIP_MODEL_CFG["num_classes"],
        label_smoothing=TRAIN["label_smoothing"],
        mixup_alpha=TRAIN["mixup_alpha"], cutmix_alpha=TRAIN["cutmix_alpha"],
        mix_prob=TRAIN["mix_prob"], grad_clip_norm=TRAIN["grad_clip_norm"],
        augment=AugmentConfig(mean=MEAN, std=STD, crop_pad=CROP_PAD))
    bench_lr = warmup_cosine_lr(TRAIN["lr"], 10_000, 500, TRAIN["min_lr"])
    step = make_train_step(step_cfg, bench_lr)
    images = torch.randint(0, 256, (TRAIN_BATCH, IMG, IMG, 3),
                           dtype=torch.uint8, generator=gen).to(dev)
    labels = torch.randint(0, FLAGSHIP_MODEL_CFG["num_classes"],
                           (TRAIN_BATCH,), generator=gen).to(dev)

    def new_state(dtype, use_kernels, lr=bench_lr):
        model = build_model(FLAGSHIP_MODEL_CFG, dtype=dtype,
                            use_kernels=use_kernels, device=dev, seed=SEED)
        return TrainState.create(model, AdamW(
            lr, TRAIN["weight_decay"], TRAIN["grad_clip_norm"]))

    def fixed_draws(model):
        draws = sample_step_draws(gen, step_cfg, tuple(images.shape), dev)
        return draws._replace(drop_masks=DropPathMasks({
            m.path: torch.rand(TRAIN_BATCH, generator=gen) < 1.0 - m.rate
            for m in model.modules() if isinstance(m, DropPath)
            and m.rate > 0}))

    runs = {}
    draws = None
    for label, dtype, kern in (("fp32 kernel", torch.float32, True),
                               ("fp32 plain", torch.float32, False),
                               ("bf16 kernel", torch.bfloat16, True)):
        state = new_state(dtype, kern)
        draws = draws or fixed_draws(state.model)
        state, m = step(state, (images, labels), draws)
        torch.cuda.synchronize()
        runs[label] = (state, {k: v.item() for k, v in m.items()})
        print(f"[train-step] {label}: " + " ".join(
            f"{k}={v:.6g}" for k, v in runs[label][1].items()))
    (ks, km), (ps, pm) = runs["fp32 kernel"], runs["fp32 plain"]
    require(km["nonfinite"] == 0.0 and pm["nonfinite"] == 0.0,
            "train step: non-finite loss")
    loss_err = abs(km["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm = pm["grad_norm"]
    grad_err = max((kp.grad - pp.grad).abs().max().item()
                   for kp, pp in zip(ks.model.parameters(),
                                     ps.model.parameters())) / gnorm
    lr0 = pm["lr"]
    param_err = max((kp - pp).abs().max().item()
                    for kp, pp in zip(ks.model.parameters(),
                                      ps.model.parameters()))
    stat_err = max(((kb - pb).abs() / (1 + pb.abs())).max().item()
                   for kb, pb in zip(ks.model.buffers(), ps.model.buffers()))
    print(f"[train-step] fp32 kernel vs plain: loss rel err {loss_err:.2e} "
          f"(tol {STEP_LOSS_TOL:g}); max grad err / grad norm {grad_err:.2e} "
          f"(tol {STEP_GRAD_TOL:g}, grad norm {gnorm:.4f}); params after "
          f"the step max abs err {param_err:.2e} (tol {STEP_PARAM_TOL:g} x "
          f"lr {lr0:.3g}); BN stats rel err {stat_err:.2e} "
          f"(tol {STEP_STAT_TOL:g})")
    require(loss_err <= STEP_LOSS_TOL, "train step: loss disagrees")
    require(grad_err <= STEP_GRAD_TOL, "train step: grads disagree")
    require(param_err <= STEP_PARAM_TOL * lr0, "train step: params disagree")
    require(stat_err <= STEP_STAT_TOL, "train step: BN stats disagree")
    bf_err = abs(runs["bf16 kernel"][1]["loss"] - pm["loss"]) / pm["loss"]
    print(f"[train-step] bf16 kernel vs fp32 plain: loss rel err "
          f"{bf_err:.2e} (tol {BF16_LOSS_TOL:g})")
    require(bf_err <= BF16_LOSS_TOL, "bf16 train step: loss disagrees")
    del runs, ks, ps

    # -- phases 10-11: the main path, 30 steps on one batch ---------------
    counters = {"grid_mhsa": grid_mhsa, "grid_mhsa_bwd": grid_mhsa_backward,
                "mlp_branch": mlp_branch,
                "mlp_branch_bwd": mlp_branch_backward}
    blocks = sum(sh["blocks"] for sh in shapes)
    per_step = {"grid_mhsa": blocks, "grid_mhsa_bwd": blocks,
                "mlp_branch": 2 * blocks, "mlp_branch_bwd": 2 * blocks}
    require(per_step == {"grid_mhsa": 7, "grid_mhsa_bwd": 7,
                         "mlp_branch": 14, "mlp_branch_bwd": 14},
            f"unexpected per-step launch plan {per_step}")
    state = new_state(torch.bfloat16, True, warmup_cosine_lr(
        TRAIN["lr"], LOSS_STEPS, 3, TRAIN["min_lr"]))
    loss_step = make_train_step(step_cfg, state.tx.learning_rate)
    sampler = torch.Generator(device="cpu").manual_seed(SEED + 2)
    losses = []
    launches = {}
    for i in range(LOSS_STEPS):
        for fn in counters.values():
            fn.launches = 0
        state, m = loss_step(state, (images, labels), generator=sampler)
        launches = {k: fn.launches for k, fn in counters.items()}
        require(launches == per_step,
                f"step {i}: launches {launches}, expected {per_step}")
        losses.append(m["loss"].item())
        require(m["nonfinite"].item() == 0.0 and math.isfinite(losses[-1]),
                f"step {i}: non-finite loss")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[train] launches per step {launches} (every one of "
          f"{LOSS_STEPS} steps)")
    print(f"[train] {LOSS_STEPS} bf16 kernel-path steps on one batch of "
          f"{TRAIN_BATCH}: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; mean of first 5 {first:.4f}, of last 5 {last:.4f}")
    require(last < first, "the loss did not fall over 30 steps")

    # -- phase 12: the non-finite guard -----------------------------------
    nan_step = make_train_step(dataclasses.replace(step_cfg, augment=None),
                               state.tx.learning_rate)
    bad = images.float()
    bad[0, 0, 0, 0] = float("nan")
    before = ([t.clone() for t in state.model.state_dict().values()],
              [t.clone() for t in state.opt_state.mu.values()],
              [t.clone() for t in state.opt_state.nu.values()],
              state.opt_state.count.clone())
    state, m = nan_step(state, (bad, labels), generator=sampler)
    after = (list(state.model.state_dict().values()),
             list(state.opt_state.mu.values()),
             list(state.opt_state.nu.values()), state.opt_state.count)
    same = all(torch.equal(a, b) for a, b in zip(before[0], after[0])) and \
        all(torch.equal(a, b) for a, b in zip(before[1], after[1])) and \
        all(torch.equal(a, b) for a, b in zip(before[2], after[2])) and \
        torch.equal(before[3], after[3])
    print(f"[guard] NaN batch: nonfinite={m['nonfinite'].item():g} "
          f"loss={m['loss'].item():g} grad_norm={m['grad_norm'].item():g}; "
          f"params, BN stats, AdamW mu/nu/count bitwise unchanged: {same}; "
          f"state.step {state.step}")
    require(m["nonfinite"].item() == 1.0 and m["loss"].item() == 0.0,
            "guard: NaN loss not reported")
    require(same, "guard: the state changed on a non-finite step")

    # -- phase 13: timings ------------------------------------------------
    bf16 = torch.bfloat16
    step_ms = {"grid_mhsa_bwd": [0.0, 0.0], "mlp_branch_bwd": [0.0, 0.0]}
    for sh in shapes:
        cases = [("grid_mhsa_bwd", grid_mhsa_backward,
                  grid_mhsa_backward_reference, grid_args(sh, bf16),
                  f"G={sh['G']} N={sh['N']} C={sh['C']}")]
        cases += [("mlp_branch_bwd", mlp_branch_backward,
                   mlp_branch_backward_reference, mlp_args(sh, H, bf16),
                   f"M={sh['M']} C={sh['C']} H={H}")
                  for H in (sh["H_outlook"], sh["H_block"])]
        for name, kern, plain, args, what in cases:
            k_ms = time_ms(kern, args, iters=10, warmup=2)
            p_ms = time_ms(plain, args, iters=10, warmup=2)
            step_ms[name][0] += sh["blocks"] * k_ms
            step_ms[name][1] += sh["blocks"] * p_ms
            print(f"[time] {name} stage{sh['stage']} {what} bf16: kernel "
                  f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"({k_ms and p_ms / k_ms:.2f}x) [{gpu}]")
    for name, (k, p) in step_ms.items():
        print(f"[time] {name} per batch-{TRAIN_BATCH} train step: kernel "
              f"{k:.4f} ms, plain {p:.4f} ms [{gpu}]")
    draws = fixed_draws(state.model)
    for label, st in (("kernel path", state),
                      ("plain path", new_state(bf16, False))):
        def one(st=st):
            step(st, (images, labels), draws)
        ms = time_ms(one, (), iters=10, warmup=3)
        print(f"[time] Model A-7M train step bs{TRAIN_BATCH} bf16 {label} "
              f"(uint8 in, augment + mix + fwd + bwd + AdamW; draws "
              f"sampled beforehand): {ms:.3f} ms/step, "
              f"{TRAIN_BATCH / ms * 1e3:.1f} imgs/s [{gpu}]")
    return {"launches": launches, "max_err": max_err, "ms": step_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1

    import numpy as np

    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.ops import kernel_build
    from outgridvit_tpu_torch.ops.augment import normalize_batch
    from outgridvit_tpu_torch.ops.grid_attention import (
        grid_mhsa,
        grid_mhsa_reference,
    )
    from outgridvit_tpu_torch.ops.mlp_branch import (
        mlp_branch,
        mlp_branch_reference,
    )
    from outgridvit_tpu_torch.serving import build_predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gpu = gpu_name_and_power_limit()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"gpu: {gpu}")

    # -- phase 2: build the kernels from the checkout --------------------
    build = kernel_build.build()
    kernel_build.load()
    print(f"[build] nvcc {kernel_build.find_nvcc()} built={build.built} "
          f"seconds={build.seconds:.2f} -> {build.path.name}")
    for line in build.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")

    # -- phase 3: each kernel against its plain version -------------------
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def grid_inputs(sh, dtype):
        return (randn(sh["G"], sh["N"], 3 * sh["C"]).to(dtype),
                sh["heads"])

    def mlp_inputs(sh, H, dtype, act="gelu", apply_ln=True):
        C, M = sh["C"], sh["M"]
        return (randn(M, C).to(dtype), randn(C, scale=0.1, shift=1.0),
                randn(C, scale=0.1), randn(C, H, scale=C ** -0.5).to(dtype),
                randn(H, scale=0.02).to(dtype),
                randn(H, C, scale=H ** -0.5).to(dtype),
                randn(C, scale=0.02).to(dtype), act, 1e-5, apply_ln)

    max_err = {"grid_mhsa": 0.0, "mlp_branch": 0.0}

    def compare(name, kernel, plain, args, dtype, label):
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        require(torch.isfinite(got.float()).all().item(),
                f"{name} {label}: non-finite output")
        print(f"[compare] {name} {label} {str(dtype).split('.')[-1]} "
              f"max_abs_err={err:.3e} tol={tol:g}(abs+rel) "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {label}: kernel disagrees with plain version")
        max_err[name] = max(max_err[name], err)

    shapes = stage_shapes()
    for dtype in (torch.float32, torch.bfloat16):
        for sh in shapes:
            tag = f"stage{sh['stage']}"
            compare("grid_mhsa", grid_mhsa, grid_mhsa_reference,
                    grid_inputs(sh, dtype), dtype,
                    f"{tag} G={sh['G']} N={sh['N']} C={sh['C']} "
                    f"heads={sh['heads']}")
            for H in (sh["H_outlook"], sh["H_block"]):
                compare("mlp_branch", mlp_branch, mlp_branch_reference,
                        mlp_inputs(sh, H, dtype), dtype,
                        f"{tag} M={sh['M']} C={sh['C']} H={H} gelu ln")
        sh = shapes[0]  # every activation and the no-LN form, once
        for act in ("silu", "relu", "gelu"):
            compare("mlp_branch", mlp_branch, mlp_branch_reference,
                    mlp_inputs(sh, sh["H_block"], dtype, act, act != "gelu"),
                    dtype, f"stage0 M={sh['M']} C={sh['C']} act={act} "
                    f"ln={act != 'gelu'}")

    # -- phase 4: the flagship predictor on the card ----------------------
    pred = build_predictor(FLAGSHIP_MODEL_CFG, batch_size=BATCH, img_size=IMG,
                           device=dev, seed=SEED)
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"[predictor] Model A-7M params={n_params} batch={BATCH} "
          f"dtype={pred.model.dtype}")
    require(n_params == FLAGSHIP_PARAMS, f"param count {n_params}")

    # -- phase 5: serve requests; the counters must show the kernels ran --
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (200, IMG, IMG, 3), dtype=np.uint8)
    requests = [("full batch", images[:BATCH]), ("ragged 3", images[:3]),
                ("200 images", images)]
    per_forward = {"grid_mhsa": sum(s["blocks"] for s in shapes),
                   "mlp_branch": 2 * sum(s["blocks"] for s in shapes)}
    require(per_forward == {"grid_mhsa": 7, "mlp_branch": 14},
            f"unexpected per-forward launch plan {per_forward}")
    counters = {"grid_mhsa": grid_mhsa, "mlp_branch": mlp_branch}
    results = {}
    for fn in counters.values():
        fn.launches = 0
    for label, req in requests:
        before = {k: fn.launches for k, fn in counters.items()}
        labels, probs = pred.predict_many(req)
        forwards = -(-len(req) // BATCH)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        print(f"[serve] {label}: labels {labels.shape} probs {probs.shape} "
              f"forwards={forwards} launches={delta}")
        require(labels.shape == (len(req),) and labels.dtype == np.int32,
                f"{label}: labels {labels.shape} {labels.dtype}")
        require(probs.shape == (len(req), 100), f"{label}: probs shape")
        require(np.isfinite(probs).all(), f"{label}: non-finite probs")
        require(np.allclose(probs.sum(-1), 1.0, atol=1e-4),
                f"{label}: probs do not sum to 1")
        require((labels == probs.argmax(-1)).all(), f"{label}: argmax")
        require(delta == {k: v * forwards for k, v in per_forward.items()},
                f"{label}: launches {delta}, expected "
                f"{per_forward} x {forwards}")
        results[label] = (labels, probs)
    launches = {k: fn.launches for k, fn in counters.items()}
    require(all(v > 0 for v in launches.values()), f"launches {launches}")
    full_l, full_p = results["full batch"]
    rag_l, rag_p = results["ragged 3"]
    require((rag_l == full_l[:3]).all()
            and np.allclose(rag_p, full_p[:3], atol=1e-3),
            "ragged request disagrees with the same rows of a full batch")
    require((results["200 images"][0][:BATCH] == full_l).all(),
            "predict_many disagrees with predict")

    # -- phase 6: kernel path vs plain path, same weights and inputs -------
    state = pred.model.state_dict()

    def model(dtype, use_kernels):
        m = build_model(FLAGSHIP_MODEL_CFG, dtype=dtype,
                        use_kernels=use_kernels, device=dev)
        m.load_state_dict(state)
        return m

    plain32 = model(torch.float32, False)
    kern32 = model(torch.float32, True)
    plainbf = model(torch.bfloat16, False)
    x = normalize_batch(torch.from_numpy(images[:BATCH]).to(dev),
                        pred.mean, pred.std)
    with torch.inference_mode():
        ref = plain32(x)
        outs = {"fp32 kernel path": (kern32(x), "float32"),
                "bf16 kernel path (served)": (pred.model(x), "bfloat16"),
                "bf16 plain path": (plainbf(x), "bfloat16")}
    scale = max(1.0, ref.abs().max().item())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    for label, (logits, dt) in outs.items():
        require(torch.isfinite(logits).all().item(), f"{label}: non-finite")
        err = (logits.float() - ref).abs().max().item()
        tol = LOGIT_TOL[dt] * scale
        decided = margin > 2 * tol
        agree = logits.argmax(-1) == ref.argmax(-1)
        print(f"[logits] {label} vs fp32 plain path: max_abs_err={err:.4e} "
              f"tol={tol:.4e} (max|logit|={scale:.3f}); labels agree "
              f"{int(agree.sum())}/{BATCH}; on the {int(decided.sum())} rows "
              f"with top-2 margin > 2*tol: {int((agree & decided).sum())}")
        require(err <= tol, f"{label}: logits off by {err}")
        require(bool(agree[decided].all()), f"{label}: labels disagree")

    # -- phase 7: timings (CUDA events after warm-up) ---------------------

    kernel_ms = {"grid_mhsa": [0.0, 0.0], "mlp_branch": [0.0, 0.0]}
    bf16 = torch.bfloat16
    for sh in shapes:
        cases = [("grid_mhsa", grid_mhsa, grid_mhsa_reference,
                  grid_inputs(sh, bf16), f"N={sh['N']} C={sh['C']}")]
        cases += [("mlp_branch", mlp_branch, mlp_branch_reference,
                   mlp_inputs(sh, H, bf16), f"C={sh['C']} H={H}")
                  for H in (sh["H_outlook"], sh["H_block"])]
        for name, kern, plain, args, what in cases:
            k_ms, p_ms = time_ms(kern, args), time_ms(plain, args)
            kernel_ms[name][0] += sh["blocks"] * k_ms
            kernel_ms[name][1] += sh["blocks"] * p_ms
            print(f"[time] {name} stage{sh['stage']} {what} bf16: kernel "
                  f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"({k_ms and p_ms / k_ms:.2f}x) [{gpu}]")
    for name, (k, p) in kernel_ms.items():
        print(f"[time] {name} per batch-{BATCH} forward: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms [{gpu}]")

    with torch.inference_mode():
        fwd_k = time_ms(pred.model, (x,), iters=20, warmup=3)
        fwd_p = time_ms(plainbf, (x,), iters=20, warmup=3)
    print(f"[time] Model A-7M forward bs{BATCH} bf16: kernel path "
          f"{fwd_k:.3f} ms, plain path {fwd_p:.3f} ms [{gpu}]")
    full = images[:BATCH]
    for _ in range(3):
        pred.predict(full)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(full)
    secs = time.perf_counter() - t0
    print(f"[time] predictor bs{BATCH} bf16 (uint8 in, labels+probs out): "
          f"{reps * BATCH / secs:.1f} imgs/s, {secs / reps * 1e3:.3f} "
          f"ms/request [{gpu}]")

    train = train_phases(dev, gpu)
    launches.update((k, train["launches"][k]) for k in train["ms"])
    max_err.update(train["max_err"])
    kernel_ms.update(train["ms"])
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": max_err[name], "ms": kernel_ms[name][0],
        "plain_ms": kernel_ms[name][1],
    } for name in SOURCES]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
