#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``outgridvit_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version at every
Model A-7M stage shape in fp32 and bf16, serves requests through
``Predictor`` at the flagship's full width (CIFAR-100 32px, batch 64, bf16,
random weights from a seed), checks that the serving path launched every
kernel, checks the kernel path's logits against the plain path's, and times
kernels and the predictor.

Output: per-phase lines, then the card's ``nvidia-smi`` name and power
limit, then a JSON line ``{"kernels": [...]}``, then the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without the last line. Without a CUDA device it exits 1
before doing anything. Imports no JAX and no yaml.
"""

from __future__ import annotations

import json
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

SOURCES = {
    "grid_mhsa": ("outgridvit_tpu_torch/csrc/grid_mhsa.cu",
                  "outgridvit_tpu/ops/grid_attention_pallas_t.py:270"),
    "mlp_branch": ("outgridvit_tpu_torch/csrc/mlp_branch.cu",
                   "outgridvit_tpu/ops/mlp_branch_pallas_t.py:182"),
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


def stage_shapes():
    """Per stage: the kernels' shapes at BATCH and how often one forward
    launches them."""
    out = []
    batch = BATCH
    for si, s in enumerate(FLAGSHIP_MODEL_CFG["stages"]):
        hw = IMG >> si
        g, C = s["grid_size"], s["dim"]
        out.append({
            "stage": si, "blocks": s["depth"], "C": C,
            "G": batch * g * g, "N": (hw // g) ** 2, "heads": s["num_heads"],
            "M": batch * hw * hw, "H_outlook": 2 * C, "H_block": 4 * C,
        })
    return out


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
    def time_ms(fn, args, iters=50, warmup=5):
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

    per_fwd_ms = {"grid_mhsa": [0.0, 0.0], "mlp_branch": [0.0, 0.0]}
    bf16 = torch.bfloat16
    for sh in shapes:
        cases = [("grid_mhsa", grid_mhsa, grid_mhsa_reference,
                  grid_inputs(sh, bf16), f"N={sh['N']} C={sh['C']}")]
        cases += [("mlp_branch", mlp_branch, mlp_branch_reference,
                   mlp_inputs(sh, H, bf16), f"C={sh['C']} H={H}")
                  for H in (sh["H_outlook"], sh["H_block"])]
        for name, kern, plain, args, what in cases:
            k_ms, p_ms = time_ms(kern, args), time_ms(plain, args)
            per_fwd_ms[name][0] += sh["blocks"] * k_ms
            per_fwd_ms[name][1] += sh["blocks"] * p_ms
            print(f"[time] {name} stage{sh['stage']} {what} bf16: kernel "
                  f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"({k_ms and p_ms / k_ms:.2f}x) [{gpu}]")
    for name, (k, p) in per_fwd_ms.items():
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

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": max_err[name], "ms": per_fwd_ms[name][0],
        "plain_ms": per_fwd_ms[name][1],
    } for name in SOURCES]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
