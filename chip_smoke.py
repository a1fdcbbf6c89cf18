#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``outgridvit_tpu_torch/csrc`` (nvcc,
sm_90a), then drives three models at their full width with random weights
from a seed:

- Model A-7M (``configs/cifar100_model_a_7m.yaml``, CIFAR-100 32px): grid
  attention on N <= 16 token grids (``grid_mhsa``), MLP branches
  (``mlp_branch``);
- Model A on Tiny-ImageNet-200 (``configs/tinyimagenet200_model_a.yaml``,
  64px): stage 0 runs grids of N=64 through the fused attention branch
  (``attn_branch``) and its MLPs at the shapes of the row-layout TPU kernel;
  stages 1-3 run the N=16 grids of the head-chunked TPU kernel;
- Model B (``configs/cifar100_model_b.yaml``, CIFAR-100 32px) with
  ``model.use_pallas: fused_agg``: its three front outlookers run the fused
  outlook aggregate + projection (``outlook_agg``), its grid-only stages
  ``grid_mhsa`` and ``mlp_branch``; then again with ``fused_agg_v``, the
  value projection folded in (``outlook_branch``); then with
  ``use_pallas: fused_outlook`` and ``dwconv="t"``: the front runs the fused
  outlook softmax + aggregate (``outlook_softmax``), every MBConv the
  depthwise kernels (``dwconv3x3``, ``dwconv3x3_bwd`` tagged "t");
- Model A-7M again with ``dwconv="bwd"``, train phase only: the grouped
  conv forward and the depthwise backward kernel (tagged "bwd");
- Model A-7M at 48 px (``a7m_48``, the same model, crop pad 6): stage 0 runs
  grids of N=36 through the block-packed core (``grid_mhsa_packed``),
  stages 1-3 the N=9 grids of ``grid_mhsa``;
- the default Model A (``configs/cifar100_model_a.yaml``, ``a_base``, 32
  px) built with ``attn_nhwc=True``: stage 0 runs its N=64 grids through
  the fused branch on the NHWC map (``attn_branch_nhwc``), stages 1-3 the
  wide N=16 grids (C = 160/320/448) of ``grid_mhsa`` tagged "th". The same
  phase holds ``attn_branch_nhwc`` against partition -> ``attn_branch`` ->
  unpartition on the same inputs and times the two, interleaved (the A/B
  of the switch);
- Model A-7M at 96 px (``a7m_96``, crop pad 12): stage 0 has grids of
  N=144 (C=48, 2 heads) that the fused branch cannot hold, so they run the
  block-packed core's kernel for long grids (``grid_mhsa_long``), as the
  JAX model falls back to its #6 there; stages 1-3 the N=36 grids of
  ``grid_mhsa_packed`` at C = 96/192/256.

Every bf16 launch of the grid core, tagged "t" (#1: the 7M model's,
Model B's and ``a7m_48``'s grids of N <= 16) or "th" (#3: Tiny-ImageNet's
and ``a_base``'s stages 1-3), runs ``csrc/grid_mhsa_th.cu``, every fp32
one ``csrc/grid_mhsa.cu``;
the block-packed core's bf16 launches of N <= 63 (``a7m_48``'s stage 0,
``a7m_96``'s stages 1-3) run ``csrc/grid_mhsa_packed_mma.cu``, its fp32
ones ``csrc/grid_mhsa_packed.cu``, and its launches of 64 <= N <= 256 in
both dtypes ``csrc/grid_mhsa_long.cu`` (the kernels line's
``grid_mhsa_long`` row). The MLP branch's bf16 launches (every main
path's shapes) run ``csrc/mlp_branch_mma.cu`` forward and
``csrc/mlp_branch_bwd_mma.cu`` backward, its fp32 ones
``csrc/mlp_branch.cu`` and ``csrc/mlp_branch_bwd.cu``. The fused
attention branch's bf16 launches (Tiny-ImageNet's and ``a_base``'s stage
0) run ``csrc/attn_branch_mma.cu`` forward and
``csrc/attn_branch_bwd_mma.cu`` backward, its fp32 ones
``csrc/attn_branch.cu``. The fused outlook projection (#7 ``outlook_agg``
and #8 ``outlook_branch``) runs, for every bf16 forward launch its plan
takes (Model B's front and every ``OUTLOOK_SHAPES`` entry of C <= 192
with the fold, C <= 256 without), ``csrc/outlook_agg_fwd_mma.cu`` (CUDA
C++, x.Wv and y.Wp on ``mma.sync`` tiles, staged by 16-byte ``cp.async``
on the backward's layout), and for every bf16 backward launch its plan
takes (every outlooker of C <= 128) ``csrc/outlook_agg_bwd_mma.cu`` (its
five products on ``mma.sync`` tiles, one pass a tile with the halo rows'
dyag recomputed); its fp32 and wider launches ``csrc/outlook_agg.cu``.
The fused outlook softmax (#9 ``outlook_softmax``) runs every bf16 launch
at K = 3 its plan takes (every outlooker) on
``csrc/outlook_softmax_rows.cu`` (whole image rows staged by
``cp.async``, a thread a run of adjacent pixels of one 16-byte channel
chunk), its fp32 and K = 5 launches on ``csrc/outlook_softmax.cu``.
The served and trained main paths (bf16) must launch them through the
matching C entry points, and the fp32 step through the FMA ones;
``attn_branch_nhwc``'s y and parameter grads must equal ``attn_branch``'s
on the partitioned inputs bit for bit.

For each model: every kernel against its plain PyTorch version at every
stage shape (forward at the serving batch 64, backward at the train batch
128, fp32 and bf16; each backward and each forward of the fused
attention branch twice, bitwise equal, through the entry point its dtype
routes to, and so does the outlook forward; the bf16 MLP and outlook
forwards with at least 90% of their outputs bitwise equal to the plain
version's; the share of the fused branch's bf16 y bitwise the plain
version's reported), requests through
``Predictor`` at batch 64 with the launch counts of each forward, the kernel
path's logits against the plain path's, one fp32 train step through the
kernels against one through the plain path (batch 128, raw uint8 in, the
config's augmentation and mixing recipe, AdamW), bf16 steps on one batch in
which the loss must fall (launch counts of each step), and timings. The 7M
path also checks the non-finite guard. Model B's phase also holds both outlook
kernels against their plain versions at every outlooker shape of the three
configurations; the ``fused_outlook`` phase holds ``outlook_softmax`` there
(K = 3, and K = 5 at one shape; bit for bit, twice, through the entry
point its dtype and K route to) and the depthwise kernels at every MBConv
depthwise shape of the five configurations and of ``a7m_96`` (the
forward bit for bit); ``a7m_48`` and ``a_base`` time
only their new kernels. Phase ``ab_vs_library`` (after the
``fused_outlook`` phase) times kernels against the one PyTorch call that
computes the same function, in turns, in device time (CUDA graphs) and
eager, with their shares of the bound (``AB_LIBRARY``): the depthwise
backward against ``aten.convolution_backward`` (cuDNN) at the MBConv shapes
of Model B and the 7M model and at the Tiny-ImageNet stage 0, the
depthwise forward against ``F.conv2d(groups=C)`` at Model B's and at the
stage 0 of Tiny-ImageNet and ``a7m_96``, the grid core's tensor-core
kernel against SDPA at the "t" shapes of the 7M model and Model B (#1;
forward at batch 64, backward at 128) and at #3's six "th" shapes, and #6
against SDPA at ``a7m_48``'s stage 0
and, for long grids, at ``a7m_96``'s (forward at batch 64 and 128,
backward at 128); per shape and per forward or train step. Phase
``ab_mlp`` (``AB_MLP``) then times the MLP branch's tensor-core kernels
against the FMA kernels they replace at every MLP shape of the
Tiny-ImageNet, Model B, 7M and ``a7m_96`` paths, the same way: the
forward at batch 64, per forward, the backward at 128, per train step.
Phase ``ab_attn`` (``AB_ATTN``) times the attention branch's tensor-core
kernels against the FMA kernels they replace at the stage 0 of
Tiny-ImageNet (#5), ``a_base`` (#12) and the default Model A through #5:
the forward at batch 64 per forward and at batch 128 per train step, the
backward at batch 128 per train step, per launch too, beside the same
function composed of library calls (LN, linear, SDPA, linear; for scale
only). Phase ``ab_grid`` (``AB_GRID``) times the grid core's tensor-core
kernel against the FMA kernel it replaces for #1 at every "t" stage shape
of the 7M model, Model B and ``a7m_48`` the same way: the forward at batch
64, per forward, the backward at 128, per train step, per launch too.
Phase ``ab_outlook`` (``Smoke.ab_outlook``) times in device time #9's
row kernel (``csrc/outlook_softmax_rows.cu``) against the kernel it
replaces (``csrc/outlook_softmax.cu``) in turns at Model B's front (batch
64, per launch and per forward) and at every other ``OUTLOOK_SHAPES``
entry its plan takes, then the outlook forward's tensor-core kernel
against the FMA kernel it replaces the same way, then the backward's
(batch 128, per launch and per train step), each with its share of the
bound. The share of the grid core's bf16
outputs bitwise the plain version's is reported at every compare, not
gated, and so are the outlook backward's shares of dv / dx and da.

Phase ``loop`` (last, ``Smoke.loop``) drives the training entry point as a
user runs it: ``outgridvit_tpu_torch/train.py:main`` in-process with
``configs/cifar100_model_a_7m.yaml`` at full width, bf16, batch 128, on a
CIFAR-100 pickle fixture of random images (10,000 train, 10,000 test, 100
classes), ``--steps-per-dispatch 4``: 2 epochs, then ``--resume`` from
the last checkpoint for a third. It checks the exit codes, finite
``[Train]`` / ``[Val]`` losses, the resume line, both checkpoints, that
the grid and MLP kernels (forward and backward) launched on their
tensor-core entry points and that the eval graph replayed; it prints each
epoch's img/s and seconds. Then the 7M eval superstep at K = 4 is held
bitwise to 4 eager eval steps before and after one train step, and the
two are timed in turns (``Smoke.eval_graph``).

Phase ``evaluate`` (``Smoke.evaluate``) drives the eval and export
entry points on the loop's best checkpoint, bf16: ``benchmark_eval.main``
over the fixture's test split (batch 128, K = 8: the metric dict's keys,
finite metrics, the 7M's parameter count, eval graph replays, #1 and #2 on
their tensor-core entry points); ``eval_robustness.main`` over a
CIFAR-100-C fixture of random images it writes (2 corruptions x 5
severities x 10,000 images: 10 rows, a finite summary, one eval graph
capture, seconds a setting); ``export_model.main --selfcheck`` at batch 64
and ``load_predictor``, the loaded program against the live predictor
(labels equal, probabilities within 1e-6, one loaded forward's launches
those of one live forward); ``model_b_o`` exported whole and held the same
way; each ``ogvt::`` op of ``ops/library.py`` exported alone at a stage
shape of a case that reaches it, bitwise a direct launch. Live and loaded
predictors are timed in turns at batch 64.

Phase ``analyze`` (last, ``Smoke.analyze``) drives the analysis and
ablation entry points and per-block remat: ``run_attention_analysis.main``
on the loop's best checkpoint (``--skip-plots --entropy --block all``: a
row per stage, MAD and entropy within their bounds, JSON and CSV);
``capture_attention`` on the 7M and Model B (``fused_agg``) kernel paths
against their plain paths (#2 and #7 launched, no grid core, fused branch
or fused softmax; the captures and their MAD / entropy rows within
``CAPTURE_TOL`` / ``ROWS_TOL``); ``run_ablations.main``, each of the five
ablations for 1 epoch of a small fixture (finite histories, a train graph
replay, the kernel families launched or absent); and ``Smoke.remat``: one
7M and one Tiny-ImageNet-200 train step per ``model.remat`` policy,
bitwise the step without remat eagerly and through the K = 2 train graph,
with each policy's peak memory and step time.

Output: per-phase lines, then the card's ``nvidia-smi`` name and power
limit, then a JSON line ``{"kernels": [...]}`` (launch counts of the main
paths; ms per batch-64 forward for the forward kernels and per batch-128
train step for the backward ones, of Tiny-ImageNet for the grid and MLP
kernels, of Model B for the outlook and depthwise ones, of ``a7m_48``,
``a7m_96`` and ``a_base`` for the block-packed core, its kernel for long
grids and the NHWC branch: the kernel, its
plain version, one
PyTorch call computing the same function where there is one, and the bound
from the bytes and operations of the same launches), then the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
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
# The `model:` section of configs/tinyimagenet200_model_a.yaml (a test
# checks that the two agree, and the count against the JAX build).
TIN_MODEL_CFG = {
    "type": "model_a",
    "num_classes": 200,
    "in_ch": 3,
    "stem_dim": 64,
    "dpr_max": 0.11,
    "stages": [
        {"dim": 64, "depth": 2, "num_heads": 2, "grid_size": 8,
         "outlook_heads": 2},
        {"dim": 128, "depth": 3, "num_heads": 4, "grid_size": 8,
         "outlook_heads": 4},
        {"dim": 256, "depth": 4, "num_heads": 8, "grid_size": 4,
         "outlook_heads": 8},
        {"dim": 384, "depth": 2, "num_heads": 6, "grid_size": 2,
         "outlook_heads": 6},
    ],
}
TIN_PARAMS = 22_542_628
# The `model:` section of configs/cifar100_model_b.yaml plus the fused
# outlook mode of the main run (a test checks the two agree, and the count
# against the JAX build).
MODEL_B_MODEL_CFG = {
    "type": "model_b",
    "num_classes": 100,
    "in_ch": 3,
    "stem_dim": 64,
    "outlooker_front_depth": 3,
    "dpr_max": 0.1,
    "stages": [
        {"dim": 64, "depth": 2, "num_heads": 2, "grid_size": 8,
         "outlook_heads": 2},
        {"dim": 128, "depth": 2, "num_heads": 4, "grid_size": 8,
         "outlook_heads": 4},
        {"dim": 256, "depth": 3, "num_heads": 8, "grid_size": 4,
         "outlook_heads": 8},
        {"dim": 384, "depth": 1, "num_heads": 6, "grid_size": 2,
         "outlook_heads": 6},
    ],
    "use_pallas": "fused_agg",
}
MODEL_B_PARAMS = 12_266_266
# The `model:` section of configs/cifar100_model_a.yaml, the config that
# configs/train.yaml and scripts/train.py use (a test checks the two agree,
# and the count against the JAX build).
A_BASE_MODEL_CFG = {
    "type": "model_a",
    "num_classes": 100,
    "in_ch": 3,
    "stem_dim": 64,
    "dpr_max": 0.12,
    "stages": [
        {"dim": 80, "depth": 2, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 160, "depth": 3, "num_heads": 5, "grid_size": 4,
         "outlook_heads": 5},
        {"dim": 320, "depth": 4, "num_heads": 10, "grid_size": 2,
         "outlook_heads": 10},
        {"dim": 448, "depth": 2, "num_heads": 8, "grid_size": 1,
         "outlook_heads": 8},
    ],
}
A_BASE_PARAMS = 32_974_583
BATCH = 64
TRAIN_BATCH = 128
SEED = 0
DEVICE = "cuda"
# phase loop: the CIFAR-100 fixture's images, the eval graph's K, the
# timed K-groups
LOOP_TRAIN, LOOP_TEST, LOOP_K, LOOP_TIMED = 10_000, 10_000, 4, 10
# phase evaluate: the eval benchmark's K; the CIFAR-100-C fixture's
# corruptions and rows a file (severities 1-5, 10,000 rows each); the
# predictor timing's turns (live, loaded, loaded, live) and calls a turn
EVAL_K = 8
# phase analyze: the ablation fixture (train / test images) and the bar of a
# bf16 kernel-path capture against the plain path's (LOGIT_TOL's)
ABL_TRAIN, ABL_TEST = 2_048, 512
CAPTURE_TOL = 5e-2
# the MAD / entropy rows of the two captures: |kernel - plain| <= ROWS_TOL
# x (1 + |plain|)
ROWS_TOL = 2e-2
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")
SWEEP = ("gaussian_noise", "fog")
SWEEP_ROWS = 50_000
SERVE_ROUNDS, SERVE_CALLS = 3, 10
# the keys of the JAX package's evaluate_one_epoch_logs metric dict
BENCH_KEYS = ("loss", "top1", "top3", "top5", "imgs_per_sec", "ms_per_batch",
              "epoch_seconds", "num_images", "params", "param_size_mb",
              "flops_fwd", "mem_gib", "mem_peak_gib")


def write_cifar_fixture(data_dir, n_train: int, n_test: int, classes: int,
                        seed: int) -> None:
    """Random uint8 images in the ``cifar-100-python/{train,test}`` pickle
    layout that ``outgridvit_tpu_torch/data/datasets.py`` reads (the
    fixture of ``tests/test_cli.py``)."""
    import pickle

    import numpy as np

    base = data_dir / "cifar-100-python"
    base.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        payload = {b"data": rng.integers(0, 255, (n, 3072), dtype=np.uint8),
                   b"fine_labels": (np.arange(n) % classes).tolist()}
        with open(base / split, "wb") as f:
            pickle.dump(payload, f)


class StampedLines:
    """A text stream that writes through to ``out`` and keeps each
    complete line with the ``time.perf_counter()`` at which it ended."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, text: str) -> int:
        self.out.write(text)
        now = time.perf_counter()
        *done, self._part = (self._part + text).split("\n")
        self.lines.extend((now, line) for line in done)
        return len(text)

    def flush(self):
        self.out.flush()


@dataclasses.dataclass(frozen=True)
class ModelCase:
    """One configuration: its model, input and train recipe (the yaml's
    ``training:`` values, with ``bench.py``'s schedule, and the dataset's
    statistics and crop pad, ``scripts/bench_config.py:32, 75``)."""

    tag: str
    config: str
    model: dict
    params: int
    img: int
    mean: tuple
    std: tuple
    crop_pad: int
    train: dict
    loss_steps: int
    fixed_draws_loss: bool  # the loss loop reuses one step's draws
    dwconv: str = "xla"  # every MBConv's depthwise mode (build_model)
    attn_nhwc: bool = False  # the N >= 64 grids through #12 (build_model)

    @property
    def front(self) -> int:
        """Model B's front outlookers (at stage 0's shape)."""
        return (int(self.model.get("outlooker_front_depth", 2))
                if self.model["type"] == "model_b" else 0)

    @property
    def outlook_kernel(self):
        """The kernel of the outlook value path, None on the XLA path."""
        return OUTLOOK_KERNELS.get(self.model.get("use_pallas"))


FLAGSHIP = ModelCase(
    "a7m", "configs/cifar100_model_a_7m.yaml", FLAGSHIP_MODEL_CFG,
    FLAGSHIP_PARAMS, 32, (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761),
    4, {"lr": 5e-4, "weight_decay": 0.05, "grad_clip_norm": 1.0,
        "min_lr": 1e-6, "label_smoothing": 0.1, "mixup_alpha": 0.8,
        "cutmix_alpha": 1.0, "mix_prob": 0.5}, 30, False)
TIN = ModelCase(
    "tin200", "configs/tinyimagenet200_model_a.yaml", TIN_MODEL_CFG,
    TIN_PARAMS, 64, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 8,
    {"lr": 5e-4, "weight_decay": 0.05, "grad_clip_norm": 1.0,
     "min_lr": 1e-6, "label_smoothing": 0.0, "mixup_alpha": 0.0,
     "cutmix_alpha": 1.0, "mix_prob": 0.5}, 10, True)
MODEL_B = ModelCase(
    "model_b", "configs/cifar100_model_b.yaml", MODEL_B_MODEL_CFG,
    MODEL_B_PARAMS, 32, (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761),
    4, {"lr": 5e-4, "weight_decay": 0.05, "grad_clip_norm": 1.0,
        "min_lr": 1e-6, "label_smoothing": 0.0, "mixup_alpha": 0.0,
        "cutmix_alpha": 1.0, "mix_prob": 0.5}, 10, True)
# the same model with the value projection folded into the outlook kernel
MODEL_B_V = dataclasses.replace(
    MODEL_B, tag="model_b_v", model=dict(MODEL_B_MODEL_CFG,
                                         use_pallas="fused_agg_v"),
    loss_steps=4)
# the fused outlook softmax at the front and the depthwise kernels in every
# MBConv (TPU kernels #9 and #10)
MODEL_B_O = dataclasses.replace(
    MODEL_B, tag="model_b_o", model=dict(MODEL_B_MODEL_CFG,
                                         use_pallas="fused_outlook"),
    loss_steps=4, dwconv="t")
# the 7M train step with the conv forward and the depthwise backward kernel
# (#11)
A7M_DWB = dataclasses.replace(FLAGSHIP, tag="a7m_dwb", loss_steps=4,
                              fixed_draws_loss=True, dwconv="bwd")
# the 7M model at 48 px: grids of N=36 at stage 0 (#6); the crop pad of
# scripts/bench_config.py:75-76 at that size
A7M_48 = dataclasses.replace(FLAGSHIP, tag="a7m_48", img=48, crop_pad=6,
                             loss_steps=6, fixed_draws_loss=True)
# the default Model A with the yaml's recipe (cutmix only, no label
# smoothing) and the N=64 grids of stage 0 through #12
A_BASE = ModelCase(
    "a_base", "configs/cifar100_model_a.yaml", A_BASE_MODEL_CFG,
    A_BASE_PARAMS, 32, (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761),
    4, {"lr": 5e-4, "weight_decay": 0.05, "grad_clip_norm": 1.0,
        "min_lr": 1e-6, "label_smoothing": 0.0, "mixup_alpha": 0.0,
        "cutmix_alpha": 1.0, "mix_prob": 0.5}, 6, True, attn_nhwc=True)
# the 7M model at 96 px: grids of N=144 at stage 0 that #5 cannot hold
# (#6 for long grids), N=36 at stages 1-3 (#6); the crop pad of
# scripts/bench_config.py:75-76 at that size
A7M_96 = dataclasses.replace(FLAGSHIP, tag="a7m_96", img=96, crop_pad=12)
CASES = (FLAGSHIP, TIN, MODEL_B, MODEL_B_V, MODEL_B_O, A7M_DWB, A7M_48,
         A_BASE, A7M_96)
OUTLOOK_KERNELS = {"fused_agg": "outlook_agg", "fused_agg_v": "outlook_branch",
                   "fused_outlook": "outlook_softmax"}
# Every outlooker shape of the three configurations: (H=W, C, heads).
OUTLOOK_SHAPES = {
    "model_b front": [(32, 64, 2)],
    "a7m": [(32, 48, 2), (16, 96, 3), (8, 192, 6), (4, 256, 8)],
    "tin200": [(64, 64, 2), (32, 128, 4), (16, 256, 8), (8, 384, 6)],
}

# Kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|:
# fp32 differs only by summation order (errors ~1e-6 at these sums of
# <= 1024 O(1) terms); bf16 may flip one final rounding, one bf16 ulp of an
# O(1) value being 2^-8..2^-7 relative.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Logits, as a fraction of max(1, max |plain fp32 logits|): the fp32 kernel
# path reorders fp32 sums only; bf16 carries ~3 significant digits through
# 7-11 blocks (a half-width 7M model on the CPU measured 1.5% of max
# |logits|).
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# Parameter gradients of a backward kernel (sums over all tokens), as a
# fraction of max |plain grad|: fp32 reorders the sums; in bf16 a flipped
# rounding of an intermediate moves a sum by a bf16 ulp of one term, and the
# result is rounded to bf16 once (2^-8 relative).
WGRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The H100 SXM's published rates for the bounds: HBM
# bytes/s; matrix products at the bf16 tensor-core peak; every other
# operation at the fp32 peak outside the tensor cores (the kernels compute
# in fp32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "fp32": 67e12}
# One fp32 train step, kernel path vs plain path (same state and draws):
# loss relative; every param grad as a fraction of the global grad norm;
# params after the update within STEP_PARAM_TOL x the step's lr (Adam moves
# a param by about lr, and a leaf whose exact gradient is 0 gets noise that
# Adam can move either way); BN statistics relative to (1 + |plain|).
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_PARAM_TOL, STEP_STAT_TOL = (
    1e-5, 1e-4, 4.0, 1e-4)
# bf16 kernel step vs the fp32 plain step: loss relative (bf16 keeps ~3
# significant digits through the blocks).
BF16_LOSS_TOL = 3e-2

# name -> (source, or sources, the TPU kernel it replaces, the JAX entry
# points it covers). grid_mhsa: csrc/grid_mhsa_th.cu for every bf16 launch
# at 1 <= N <= 16 and a head width that is a multiple of 8 up to 64, of
# either tag ("t", #1; "th", #3: every main path's), csrc/grid_mhsa.cu for
# fp32 ones (and a bf16 "t" launch at another head width).
# mlp_branch / mlp_branch_bwd: csrc/mlp_branch_mma.cu /
# csrc/mlp_branch_bwd_mma.cu for bf16 launches whose C and H are multiples
# of 16 (every main path's), csrc/mlp_branch.cu / csrc/mlp_branch_bwd.cu
# for fp32 ones.
# attn_branch / attn_branch_nhwc and their _bwd: csrc/attn_branch_mma.cu and
# csrc/attn_branch_bwd_mma.cu for bf16 launches at the shapes they are
# instantiated at (every main path's), csrc/attn_branch.cu for fp32 ones.
# grid_mhsa_packed: csrc/grid_mhsa_packed_mma.cu for bf16 launches, the main
# paths' (#6), csrc/grid_mhsa_packed.cu for fp32 ones, both for N <= 63;
# grid_mhsa_long: the same wrapper's launches of 64 <= N <= 256 (#6 where
# JAX falls back to it from #5), csrc/grid_mhsa_long.cu in both dtypes.
# outlook_agg / outlook_branch: csrc/outlook_agg_fwd_mma.cu for bf16
# launches its plan takes (Wp, and Wv with the fold, resident beside one
# tile: every main path's), csrc/outlook_agg.cu for fp32 ones and wider bf16
# ones. outlook_agg_bwd / outlook_branch_bwd: csrc/outlook_agg_bwd_mma.cu for
# bf16 launches its plan takes (every outlooker of C <= 128: every main
# path's), csrc/outlook_agg.cu for fp32 ones and wider bf16 ones.
# outlook_softmax: csrc/outlook_softmax_rows.cu for bf16 launches at K = 3
# its plan takes (every outlooker), csrc/outlook_softmax.cu for fp32 and
# K != 3.
SOURCES = {
    "grid_mhsa": (
        ("outgridvit_tpu_torch/csrc/grid_mhsa_th.cu",
         "outgridvit_tpu_torch/csrc/grid_mhsa.cu"),
        "outgridvit_tpu/ops/grid_attention_pallas_t.py:270",
        ["outgridvit_tpu/ops/grid_attention_pallas_t.py:270 "
         "grid_mhsa_pallas_t (#1, variant t)",
         "outgridvit_tpu/ops/grid_attention_pallas_t.py:344 "
         "grid_mhsa_pallas_th (#3, variant th)"]),
    "mlp_branch": (
        ("outgridvit_tpu_torch/csrc/mlp_branch_mma.cu",
         "outgridvit_tpu_torch/csrc/mlp_branch.cu"),
        "outgridvit_tpu/ops/mlp_branch_pallas_t.py:182",
        ["outgridvit_tpu/ops/mlp_branch_pallas_t.py:182 mlp_branch_pallas_t "
         "(#2, variant t)",
         "outgridvit_tpu/ops/mlp_branch_pallas.py:199 mlp_branch_pallas "
         "(#4, variant row)"]),
    "attn_branch": (
        ("outgridvit_tpu_torch/csrc/attn_branch_mma.cu",
         "outgridvit_tpu_torch/csrc/attn_branch.cu"),
        "outgridvit_tpu/ops/attn_branch_pallas.py:324",
        ["outgridvit_tpu/ops/attn_branch_pallas.py:324 attn_branch_pallas "
         "(#5, forward :349)"]),
    "grid_mhsa_bwd": (
        ("outgridvit_tpu_torch/csrc/grid_mhsa_th.cu",
         "outgridvit_tpu_torch/csrc/grid_mhsa.cu"),
        "outgridvit_tpu/ops/grid_attention_pallas_t.py:319",
        ["outgridvit_tpu/ops/grid_attention_pallas_t.py:319 "
         "grid_mhsa_pallas_t backward (#1)",
         "outgridvit_tpu/ops/grid_attention_pallas_t.py:412 "
         "grid_mhsa_pallas_th backward (#3)"]),
    "mlp_branch_bwd": (
        ("outgridvit_tpu_torch/csrc/mlp_branch_bwd_mma.cu",
         "outgridvit_tpu_torch/csrc/mlp_branch_bwd.cu"),
        "outgridvit_tpu/ops/mlp_branch_pallas_t.py:248",
        ["outgridvit_tpu/ops/mlp_branch_pallas_t.py:248 mlp_branch_pallas_t "
         "backward (#2)",
         "outgridvit_tpu/ops/mlp_branch_pallas.py:266 mlp_branch_pallas "
         "backward (#4)"]),
    "attn_branch_bwd": (
        ("outgridvit_tpu_torch/csrc/attn_branch_bwd_mma.cu",
         "outgridvit_tpu_torch/csrc/attn_branch.cu"),
        "outgridvit_tpu/ops/attn_branch_pallas.py:396",
        ["outgridvit_tpu/ops/attn_branch_pallas.py:396 attn_branch_pallas "
         "backward (#5)"]),
    "outlook_agg": (
        ("outgridvit_tpu_torch/csrc/outlook_agg_fwd_mma.cu",
         "outgridvit_tpu_torch/csrc/outlook_agg.cu"),
        "outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:499",
        ["outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:499 "
         "outlook_attention_proj_pallas (#7, forward: whole image :426, "
         "row-chunked :333)"]),
    "outlook_agg_bwd": (
        ("outgridvit_tpu_torch/csrc/outlook_agg_bwd_mma.cu",
         "outgridvit_tpu_torch/csrc/outlook_agg.cu"),
        "outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:461",
        ["outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:461 "
         "outlook_attention_proj_pallas backward (#7, row-chunked :374)"]),
    "outlook_branch": (
        ("outgridvit_tpu_torch/csrc/outlook_agg_fwd_mma.cu",
         "outgridvit_tpu_torch/csrc/outlook_agg.cu"),
        "outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:809",
        ["outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:809 "
         "outlook_branch_pallas (#8, forward: whole image :693, "
         "row-chunked :710)"]),
    "outlook_branch_bwd": (
        ("outgridvit_tpu_torch/csrc/outlook_agg_bwd_mma.cu",
         "outgridvit_tpu_torch/csrc/outlook_agg.cu"),
        "outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:746",
        ["outgridvit_tpu/ops/experimental/outlook_agg_pallas.py:746 "
         "outlook_branch_pallas backward (#8, row-chunked :773)"]),
    "outlook_softmax": (
        ("outgridvit_tpu_torch/csrc/outlook_softmax_rows.cu",
         "outgridvit_tpu_torch/csrc/outlook_softmax.cu"),
        "outgridvit_tpu/ops/experimental/outlook_pallas.py:141",
        ["outgridvit_tpu/ops/experimental/outlook_pallas.py:141 "
         "outlook_attention_pallas (#9, forward :157; its backward is XLA's "
         "vjp, autograd in the port)"]),
    "dwconv3x3": (
        "outgridvit_tpu_torch/csrc/dwconv.cu",
        "outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:160",
        ["outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:160 "
         "dwconv3x3_t (#10, forward :181)"]),
    "dwconv3x3_bwd": (
        "outgridvit_tpu_torch/csrc/dwconv.cu",
        "outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:211",
        ["outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:160 "
         "dwconv3x3_t backward (#10, :211, variant t)",
         "outgridvit_tpu/ops/experimental/dwconv_bwd_pallas.py:201 "
         "dwconv3x3 backward (#11, :170, variant bwd)"]),
    "grid_mhsa_packed": (
        ("outgridvit_tpu_torch/csrc/grid_mhsa_packed_mma.cu",
         "outgridvit_tpu_torch/csrc/grid_mhsa_packed.cu"),
        "outgridvit_tpu/ops/grid_attention_pallas.py:183",
        ["outgridvit_tpu/ops/grid_attention_pallas.py:183 grid_mhsa_pallas "
         "(#6, forward :202)"]),
    "grid_mhsa_packed_bwd": (
        ("outgridvit_tpu_torch/csrc/grid_mhsa_packed_mma.cu",
         "outgridvit_tpu_torch/csrc/grid_mhsa_packed.cu"),
        "outgridvit_tpu/ops/grid_attention_pallas.py:244",
        ["outgridvit_tpu/ops/grid_attention_pallas.py:227 grid_mhsa_pallas "
         "backward (#6, :244)"]),
    "grid_mhsa_long": (
        "outgridvit_tpu_torch/csrc/grid_mhsa_long.cu",
        "outgridvit_tpu/ops/grid_attention_pallas.py:183",
        ["outgridvit_tpu/ops/grid_attention_pallas.py:183 grid_mhsa_pallas "
         "(#6, forward :202) at N >= 64, where "
         "outgridvit_tpu/models/blocks.py:283-291 falls back to it"]),
    "grid_mhsa_long_bwd": (
        "outgridvit_tpu_torch/csrc/grid_mhsa_long.cu",
        "outgridvit_tpu/ops/grid_attention_pallas.py:244",
        ["outgridvit_tpu/ops/grid_attention_pallas.py:227 grid_mhsa_pallas "
         "backward (#6, :244) at N >= 64"]),
    "attn_branch_nhwc": (
        ("outgridvit_tpu_torch/csrc/attn_branch_mma.cu",
         "outgridvit_tpu_torch/csrc/attn_branch.cu"),
        "outgridvit_tpu/ops/experimental/attn_branch_nhwc_pallas.py:127",
        ["outgridvit_tpu/ops/experimental/attn_branch_nhwc_pallas.py:127 "
         "attn_branch_nhwc_pallas (#12, forward :158)"]),
    "attn_branch_nhwc_bwd": (
        ("outgridvit_tpu_torch/csrc/attn_branch_bwd_mma.cu",
         "outgridvit_tpu_torch/csrc/attn_branch.cu"),
        "outgridvit_tpu/ops/experimental/attn_branch_nhwc_pallas.py:188",
        ["outgridvit_tpu/ops/experimental/attn_branch_nhwc_pallas.py:178 "
         "attn_branch_nhwc_pallas backward (#12, :188)"]),
}
FWD = ("grid_mhsa", "attn_branch", "mlp_branch", "outlook_agg",
       "outlook_branch", "outlook_softmax", "dwconv3x3", "grid_mhsa_packed",
       "attn_branch_nhwc", "grid_mhsa_long")
# #9 has no backward kernel (its backward is autograd of plain PyTorch)
BWD = tuple(name + "_bwd" for name in FWD if name + "_bwd" in SOURCES)
OUTLOOK = ("outlook_agg", "outlook_branch")
GRID_CORES = ("grid_mhsa", "grid_mhsa_packed", "grid_mhsa_long")
# the case whose forward / train step each kernel's ms are taken on
TIMED_ON = {"outlook_agg": "model_b", "outlook_branch": "model_b",
            "outlook_softmax": "model_b_o", "dwconv3x3": "model_b_o",
            "grid_mhsa_packed": "a7m_48", "attn_branch_nhwc": "a_base",
            "grid_mhsa_long": "a7m_96"}
# the kernel each kind of grid attention (stage_shapes' "attn") launches
ATTN_KERNEL = {"grid": "grid_mhsa", "packed": "grid_mhsa_packed",
               "branch": "attn_branch", "nhwc": "attn_branch_nhwc",
               "long": "grid_mhsa_long"}
# rows of the kernels line whose launches go through another row's wrapper,
# told apart by C entry point: row -> (the wrapper's row, its entry point)
ENTRY_ROWS = {"grid_mhsa_long": ("grid_mhsa_packed", "ogvt_grid_mhsa_long"),
              "grid_mhsa_long_bwd": ("grid_mhsa_packed_bwd",
                                     "ogvt_grid_mhsa_long_bwd")}
# The A/Bs of Smoke.ab_vs_library: (kernel, case, batch, which of the
# case's stage shapes), in this order, and the key of each kernel's A/B in
# the kernels line.
AB_SHAPES = {
    "all": lambda sh: True,
    "stage0": lambda sh: sh["stage"] == 0,
    "t": lambda sh: sh["attn"] == "grid" and sh["grid_variant"] == "t",
    "th": lambda sh: sh["attn"] == "grid" and sh["grid_variant"] == "th",
    "packed": lambda sh: sh["attn"] == "packed",
    "long": lambda sh: sh["attn"] == "long",
}
AB_LIBRARY = (
    ("dwconv3x3_bwd", MODEL_B_O, TRAIN_BATCH, "all"),
    ("dwconv3x3_bwd", A7M_DWB, TRAIN_BATCH, "all"),
    ("dwconv3x3_bwd", TIN, TRAIN_BATCH, "stage0"),
    ("dwconv3x3", MODEL_B_O, BATCH, "all"),
    ("dwconv3x3", TIN, BATCH, "stage0"),
    ("dwconv3x3", A7M_96, BATCH, "stage0"),
    ("grid_mhsa", FLAGSHIP, BATCH, "t"), ("grid_mhsa", MODEL_B, BATCH, "t"),
    ("grid_mhsa_bwd", FLAGSHIP, TRAIN_BATCH, "t"),
    ("grid_mhsa_bwd", MODEL_B, TRAIN_BATCH, "t"),
    ("grid_mhsa", TIN, BATCH, "th"), ("grid_mhsa", A_BASE, BATCH, "th"),
    ("grid_mhsa_bwd", TIN, TRAIN_BATCH, "th"),
    ("grid_mhsa_bwd", A_BASE, TRAIN_BATCH, "th"),
    ("grid_mhsa_packed", A7M_48, BATCH, "packed"),
    ("grid_mhsa_packed", A7M_48, TRAIN_BATCH, "packed"),
    ("grid_mhsa_packed_bwd", A7M_48, TRAIN_BATCH, "packed"),
    ("grid_mhsa_long", A7M_96, BATCH, "long"),
    ("grid_mhsa_long", A7M_96, TRAIN_BATCH, "long"),
    ("grid_mhsa_long_bwd", A7M_96, TRAIN_BATCH, "long"),
)
# the paths whose every MLP forward and backward Smoke.ab_mlp times, the
# tensor-core kernels against the FMA kernels they replace
AB_MLP = (TIN, MODEL_B, FLAGSHIP, A7M_96)
# the C entry points of the MLP kernels' A/B, tensor-core side first
MLP_ENTRIES = {"mlp_branch": ("ogvt_mlp_branch_mma", "ogvt_mlp_branch"),
               "mlp_branch_bwd": ("ogvt_mlp_branch_bwd_mma",
                                  "ogvt_mlp_branch_bwd")}
# the C entry points of the fused attention branch backward's A/B,
# tensor-core side first, and the paths it is timed on: TIN's stage 0
# (#5), a_base's (#12) and the default Model A's stage 0 through #5
ATTN_BWD_ENTRIES = {
    "attn_branch_bwd": ("ogvt_attn_branch_bwd_mma", "ogvt_attn_branch_bwd"),
    "attn_branch_nhwc_bwd": ("ogvt_attn_branch_nhwc_bwd_mma",
                             "ogvt_attn_branch_nhwc_bwd")}
# the same for the forward
ATTN_FWD_ENTRIES = {
    "attn_branch": ("ogvt_attn_branch_mma", "ogvt_attn_branch"),
    "attn_branch_nhwc": ("ogvt_attn_branch_nhwc_mma",
                         "ogvt_attn_branch_nhwc")}
# the C entry points of the grid core's A/B, tensor-core side first (the
# entry each dtype routes to at every shipped shape), and the paths whose
# every "t" launch Smoke.ab_grid times (#1)
GRID_ENTRIES = {"grid_mhsa": ("ogvt_grid_mhsa_th", "ogvt_grid_mhsa"),
                "grid_mhsa_bwd": ("ogvt_grid_mhsa_th_bwd",
                                  "ogvt_grid_mhsa_bwd")}
AB_GRID = (FLAGSHIP, MODEL_B, A7M_48)
# the C entry points of the outlook forward's and backward's A/Bs,
# tensor-core side first (bf16 launches their plans take; fp32 and the rest
# take the FMA one)
OUTLOOK_FWD_ENTRIES = {
    "outlook_agg": ("ogvt_outlook_agg_fwd_mma", "ogvt_outlook_agg"),
    "outlook_branch": ("ogvt_outlook_agg_fwd_mma", "ogvt_outlook_agg")}
OUTLOOK_BWD_ENTRIES = {
    "outlook_agg_bwd": ("ogvt_outlook_agg_bwd_mma", "ogvt_outlook_agg_bwd"),
    "outlook_branch_bwd": ("ogvt_outlook_agg_bwd_mma",
                           "ogvt_outlook_agg_bwd")}
# the C entry points of #9's A/B, the row kernel first (bf16 launches at K
# = 3 its plan takes; fp32 and K = 5 take the other)
SOFTMAX_ENTRIES = {"outlook_softmax": ("ogvt_outlook_softmax_rows",
                                       "ogvt_outlook_softmax")}
AB_ATTN = (("attn_branch_bwd", TIN), ("attn_branch_nhwc_bwd", A_BASE),
           ("attn_branch_bwd", A_BASE))
AB_ATTN_FWD = (("attn_branch", TIN), ("attn_branch_nhwc", A_BASE),
               ("attn_branch", A_BASE))
AB_KEY = {"dwconv3x3": "ab_vs_conv2d_ms",
          "dwconv3x3_bwd": "ab_vs_convolution_backward_ms"}
# the key of a redesign's A/B against the kernel it replaces (default
# ab_vs_fma_kernel_ms)
AB_OLD_KEY = {"outlook_softmax": "ab_vs_old_kernel_ms"}
LIBRARY = {"cudnn": "cuDNN", "sdpa": "SDPA"}
# kernels whose outputs equal their plain versions bit for bit on the card
BITWISE = ("dwconv3x3", "outlook_softmax")
# the least share of a bf16 kernel's outputs that must equal its plain
# version's bit for bit: the MLP and outlook forwards' sums differ only in
# fp32 order, which flips a rounding in well under 1% of their outputs (a
# wrong kernel may pass KERNEL_TOL, not this)
BITWISE_SHARE = {"mlp_branch": 0.9, "outlook_agg": 0.9,
                 "outlook_branch": 0.9}
# bf16 kernels whose share of outputs bitwise equal to the plain version's
# is reported, not gated (they are held to KERNEL_TOL): the fused attention
# branch's forward and the grid core, whose softmax takes the card's expf
SHARE_REPORTED = ("attn_branch", "attn_branch_nhwc", "grid_mhsa",
                  "grid_mhsa_bwd")
# outputs of a backward kernel held per element (the others are parameter
# gradients, sums over every pixel): dx, or dv / dx and da
PER_ELEMENT = {"outlook_agg_bwd": (0, 1), "outlook_branch_bwd": (0, 1)}
# their shares bitwise equal to the plain version's in bf16, reported (not
# gated) for the outlook backward, by output
SHARE_OUTPUTS = {"outlook_agg_bwd": ("dv", "da"),
                 "outlook_branch_bwd": ("dx", "da")}


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


def stage_shapes(case: ModelCase = FLAGSHIP, batch: int = BATCH):
    """Per stage: the kernels' shapes at ``batch``, how often one forward
    launches them (``blocks`` grid attentions, ``outlook`` outlookers, each
    with an MLP of hidden width ``H_outlook``, ``blocks`` MLPs of width
    ``H_block``, ``blocks`` MBConvs whose depthwise 3x3 is ``mid`` wide),
    and the JAX kernels the port's dispatch stands for (as
    ``models/blocks.py`` and ``models/layers.py`` pick them)."""
    from outgridvit_tpu_torch.ops.attn_branch import (
        MIN_TOKENS,
        attn_branch_fits,
    )
    from outgridvit_tpu_torch.ops.grid_attention import (
        MAX_TOKENS,
        PACKED_MAX_TOKENS,
        grid_mhsa_variant,
    )
    from outgridvit_tpu_torch.ops.mlp_branch import mlp_branch_variant

    out = []
    for si, s in enumerate(case.model["stages"]):
        hw = case.img >> si
        g, C, heads = s["grid_size"], s["dim"], s["num_heads"]
        N = (hw // g) ** 2
        if N >= MIN_TOKENS and attn_branch_fits(N, C, heads):
            attn = "nhwc" if case.attn_nhwc else "branch"
        else:
            attn = ("long" if N > PACKED_MAX_TOKENS else "packed"
                    if N > MAX_TOKENS else "grid")
        out.append({
            "stage": si, "batch": batch, "blocks": s["depth"], "C": C,
            "outlook": (case.front if si == 0 else 0) if case.front
            else s["depth"], "H_img": hw, "outlook_heads": s["outlook_heads"],
            "G": batch * g * g, "N": N, "heads": heads,
            "M": batch * hw * hw, "H_outlook": 2 * C, "H_block": 4 * C,
            "mid": 4 * C,
            "g": g, "attn": attn,
            "grid_variant": grid_mhsa_variant(N, C),
            "mlp_variant": mlp_branch_variant(hw * hw, C),
        })
    return out


def launch_plan(case, shapes, backward=False):
    """Launches of one forward (or one backward): per kernel, and per
    variant of the kernels whose launches are tagged."""
    sfx = "_bwd" if backward else ""
    plan = {name: 0 for name in (BWD if backward else FWD)}
    variants = {"grid_mhsa" + sfx: {}, "mlp_branch" + sfx: {}}
    if backward:
        variants["dwconv3x3_bwd"] = {}
    for sh in shapes:
        n = sh["blocks"]
        todo = [(ATTN_KERNEL[sh["attn"]], n, sh["grid_variant"]),
                ("mlp_branch", n + sh["outlook"], sh["mlp_variant"])]
        if case.outlook_kernel:
            todo.append((case.outlook_kernel, sh["outlook"], None))
        # "t": kernel forward and backward; "bwd": the backward only
        if case.dwconv == "t" or (backward and case.dwconv == "bwd"):
            todo.append(("dwconv3x3", n, case.dwconv))
        for name, count, variant in todo:
            if name + sfx not in plan:  # no backward kernel (#9)
                continue
            plan[name + sfx] += count
            if name + sfx in variants:
                tags = variants[name + sfx]
                tags[variant] = tags.get(variant, 0) + count
    return plan, {k: v for k, v in variants.items() if v}


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


def graph_ms(fn, iters=20, stream=None):
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph
    and replayed between CUDA events, so no host time lies between the
    launches. ``stream``: the one to warm up and capture on (that of an
    autograd graph whose backward ``fn`` runs), else a new one."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def outlook_entry(name, args):
    """The C entry point the outlook forward or backward ``name`` takes on
    its arguments ((v, a, wp, bp) or (x, a, wv, bv, wp, bp); the backward's
    with g for bp): by dtype and shape
    (``ops/outlook_agg.py:forward_entry``, ``backward_entry``)."""
    from outgridvit_tpu_torch.ops.outlook_agg import (
        TAPS,
        backward_entry,
        forward_entry,
    )

    x, a, wp = args[0], args[1], args[-2]
    B, H, W, Cin = x.shape
    pick = backward_entry if name.endswith("_bwd") else forward_entry
    return pick(B, H, W, Cin, wp.shape[0], a.shape[-1] // TAPS,
                name.startswith("outlook_branch"), x.dtype)


def softmax_entry(args):
    """The C entry point #9 takes on its arguments (v, logits, heads, k):
    by dtype, K and shape (``ops/outlook_softmax.py:softmax_entry``)."""
    from outgridvit_tpu_torch.ops import outlook_softmax as osm

    v, logits, heads, k = args
    return osm.softmax_entry(*v.shape, heads, k, v.dtype)


def nhwc_via_tokens(args, backward):
    """#12's function (``attn_branch_nhwc`` or its backward, on their
    arguments) computed as partition -> #5 -> unpartition, the two copies
    included."""
    from outgridvit_tpu_torch.ops.attn_branch import (
        _tokens,
        _untokens,
        attn_branch,
        attn_branch_backward,
    )

    g = args[-1]
    x, meta = _tokens(args[0], g)
    if not backward:  # x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, heads, g
        return _untokens(attn_branch(x, *args[1:8]), meta)
    # x, ..., bp, dy, heads, g
    dx, *grads = attn_branch_backward(x, *args[1:7], _tokens(args[7], g)[0],
                                      args[8])
    return (_untokens(dx, meta), *grads)


def work(name, args, outs):
    """(bytes, matrix-product flop, other flop) of one launch: each input
    read once and each output written once; the operations the function
    needs (an attention or MLP backward recomputes what it differentiates
    through)."""
    import torch

    outs = (outs,) if torch.is_tensor(outs) else outs
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *outs) if torch.is_tensor(t))
    base, bwd = name.removesuffix("_bwd"), name.endswith("_bwd")
    x = args[0]
    if base in GRID_CORES:  # softmax(q.k^T).v
        G, N, C = x.shape[0], x.shape[1], x.shape[2] // 3
        return nbytes, (10 if bwd else 4) * G * N * N * C, \
            5 * G * args[-1] * N * N
    if base in ("attn_branch", "attn_branch_nhwc"):  # + LN, projections
        if base == "attn_branch":
            (G, N, C), heads = x.shape, args[-1]
        else:  # x [B, H, W, C], ..., heads, g
            heads, g = args[-2], args[-1]
            G, N, C = (x.shape[0] * g * g, x.shape[1] * x.shape[2] // g // g,
                       x.shape[3])
        return nbytes, ((22 if bwd else 8) * G * N * C * C
                        + (10 if bwd else 4) * G * N * N * C), \
            5 * G * heads * N * N + 10 * G * N * C
    if base == "mlp_branch":  # LN, fc1, activation, fc2
        M, C = x.shape
        H = args[3].shape[1]
        return nbytes, (10 if bwd else 4) * M * C * H, 10 * M * (C + H)
    if base in OUTLOOK:  # 9 taps, the projections
        P, C = x.numel() // x.shape[-1], args[-2].shape[0]
        fold = (6 if bwd else 2) * P * x.shape[-1] * C \
            if base == "outlook_branch" else 0
        return nbytes, (4 if bwd else 2) * P * C * C + fold, \
            (54 if bwd else 18) * P * C
    if base == "outlook_softmax":  # K*K taps, a softmax per pixel and head
        heads, k = args[2], args[3]
        return nbytes, 0, 2 * k * k * x.numel() \
            + 4 * k * k * heads * (x.numel() // x.shape[-1])
    if base == "dwconv3x3":  # 9 taps; dx and dw
        return nbytes, 0, (36 if bwd else 18) * x.numel()
    raise KeyError(name)


def bound_ms(name, args, outs, dtype):
    """(ms bound by bytes, ms bound by operations) of one launch on the
    H100 SXM: bytes over HBM_BYTES_PER_S; matrix products at the tensor-core
    peak in bf16 (the fp32 one otherwise), the rest at the fp32 peak."""
    import torch

    nbytes, mm, other = work(name, args, outs)
    mm_peak = PEAK_FLOPS["bf16 tensor" if dtype == torch.bfloat16
                         else "fp32"]
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            (mm / mm_peak + other / PEAK_FLOPS["fp32"]) * 1e3)


def library_call(name, args):
    """One PyTorch call computing the same function on the same inputs, as
    a no-argument callable, or None where there is none: SDPA on the grids'
    heads (and its autograd backward), the grouped conv (and
    ``aten.convolution_backward``). Timed beside the kernels only; the port
    never calls them."""
    import torch
    import torch.nn.functional as F

    if name.startswith("grid_mhsa"):
        qkv, heads = args[0], args[-1]
        G, N, C = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
        q, k, v = (t.contiguous() for t in qkv.reshape(
            G, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4))
        if not name.endswith("_bwd"):
            return lambda: F.scaled_dot_product_attention(q, k, v)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        dout = args[1].reshape(G, N, heads, C // heads).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), dout,
                                           retain_graph=True)
    if name.startswith("dwconv3x3"):
        x, w9 = args[0], args[1]
        C = x.shape[-1]
        xn, w = x.permute(0, 3, 1, 2), w9.t().reshape(C, 1, 3, 3)
        if name == "dwconv3x3":
            return lambda: F.conv2d(xn, w, padding=1, groups=C)
        dyn = args[2].permute(0, 3, 1, 2)
        return lambda: torch.ops.aten.convolution_backward(
            dyn, xn, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], C,
            [True, True, False])
    return None


def _composed_branch(x, ls, lb, wqkv, bqkv, wp, bp, heads):
    """The fused branch's y on tokens x [G, N, C] composed of library calls:
    ``F.layer_norm`` -> ``F.linear`` -> SDPA over the heads ->
    ``F.linear``."""
    import torch.nn.functional as F

    G, N, C = x.shape
    qkv = F.linear(F.layer_norm(x, (C,), ls, lb), wqkv.t(), bqkv)
    q, k, v = qkv.reshape(G, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v)
    return F.linear(o.transpose(1, 2).reshape(G, N, C), wp.t(), bp)


def composed_branch_forward(args, name):
    """The fused branch's function composed of library calls on the same
    bf16 inputs (the LN scale and bias cast to bf16), partitioned first for
    #12 (:func:`_composed_branch`), as a no-argument callable. For scale
    beside the forward's A/B only: the port never calls it, and it is not
    the kernel's ``library_ms``."""
    import torch

    from outgridvit_tpu_torch.ops.attn_branch import _tokens

    x, ls, lb, wqkv, bqkv, wp, bp, heads = args[:8]
    if name == "attn_branch_nhwc":
        x = _tokens(x, args[8])[0]
    ls, lb = ls.to(x.dtype), lb.to(x.dtype)

    def run():
        with torch.no_grad():
            return _composed_branch(x, ls, lb, wqkv, bqkv, wp, bp, heads)
    return run


def composed_branch_backward(args, name):
    """The fused branch's function composed of library calls on the same
    bf16 inputs (the LN scale and bias cast to bf16), partitioned first for
    #12 (:func:`_composed_branch`); returns a no-argument callable of its
    autograd backward for the same output gradient. For scale beside the
    backward's A/B only: the port never calls it, and it is not the
    kernel's ``library_ms``."""
    import torch

    from outgridvit_tpu_torch.ops.attn_branch import _tokens

    x, ls, lb, wqkv, bqkv, wp, bp, dy, heads = args[:9]
    if name == "attn_branch_nhwc_bwd":
        x, dy = _tokens(x, args[9])[0], _tokens(dy, args[9])[0]
    leaves = [t.detach().to(x.dtype).requires_grad_(True)
              for t in (x, ls, lb, wqkv, bqkv, wp, bp)]
    y = _composed_branch(*leaves, heads)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


class Smoke:
    """The checks, counters and results of one run."""

    def __init__(self, dev, gpu: str):
        import torch

        from outgridvit_tpu_torch.ops import attn_branch as ab
        from outgridvit_tpu_torch.ops import dwconv as dw
        from outgridvit_tpu_torch.ops import grid_attention as ga
        from outgridvit_tpu_torch.ops import mlp_branch as mb
        from outgridvit_tpu_torch.ops import outlook_agg as oa
        from outgridvit_tpu_torch.ops import outlook_softmax as osm

        self.dev, self.gpu = dev, gpu
        self.gen = torch.Generator(device="cpu").manual_seed(SEED)
        self.kernels = {
            "grid_mhsa": (ga.grid_mhsa, ga.grid_mhsa_reference),
            "attn_branch": (ab.attn_branch, ab.attn_branch_reference),
            "mlp_branch": (mb.mlp_branch, mb.mlp_branch_reference),
            "grid_mhsa_bwd": (ga.grid_mhsa_backward,
                              ga.grid_mhsa_backward_reference),
            "attn_branch_bwd": (ab.attn_branch_backward,
                                ab.attn_branch_backward_reference),
            "mlp_branch_bwd": (mb.mlp_branch_backward,
                               mb.mlp_branch_backward_reference),
            "outlook_agg": (oa.outlook_agg_proj,
                            oa.outlook_agg_proj_reference),
            "outlook_branch": (oa.outlook_branch, oa.outlook_branch_reference),
            "outlook_agg_bwd": (oa.outlook_agg_proj_backward,
                                oa.outlook_agg_proj_backward_reference),
            "outlook_branch_bwd": (oa.outlook_branch_backward,
                                   oa.outlook_branch_backward_reference),
            "outlook_softmax": (osm.outlook_softmax_agg,
                                osm.outlook_softmax_agg_reference),
            "dwconv3x3": (dw.dwconv3x3, dw.dwconv3x3_reference),
            "dwconv3x3_bwd": (dw.dwconv3x3_backward,
                              dw.dwconv3x3_backward_reference),
            "grid_mhsa_packed": (ga.grid_mhsa_packed,
                                 ga.grid_mhsa_packed_reference),
            "grid_mhsa_packed_bwd": (ga.grid_mhsa_packed_backward,
                                     ga.grid_mhsa_packed_backward_reference),
            "grid_mhsa_long": (ga.grid_mhsa_packed,
                               ga.grid_mhsa_packed_reference),
            "grid_mhsa_long_bwd": (ga.grid_mhsa_packed_backward,
                                   ga.grid_mhsa_packed_backward_reference),
            "attn_branch_nhwc": (ab.attn_branch_nhwc,
                                 ab.attn_branch_nhwc_reference),
            "attn_branch_nhwc_bwd": (ab.attn_branch_nhwc_backward,
                                     ab.attn_branch_nhwc_backward_reference),
        }
        # the grid core's launches take the variant the models' dispatch
        # picks for the shape (models/blocks.py), which picks the kernel
        self.launch = {
            name: (lambda *a, fn=fn: fn(*a, ga.grid_mhsa_variant(
                a[0].shape[1], a[0].shape[2] // 3)))
            for name, fn in (("grid_mhsa", ga.grid_mhsa),
                             ("grid_mhsa_bwd", ga.grid_mhsa_backward))}
        self.max_err = {n: 0.0 for n in SOURCES}
        self.launches = {n: {} for n in SOURCES}   # name -> {path: count}
        self.variants = {n: {} for n in SOURCES}   # name -> {variant: count}
        self.ms = {}                               # name -> timings
        self.ab = {}                     # #12 vs #5 + copies, per pass
        self.ab_lib = {}                 # kernel vs library call, per shape
        self.ab_fma = {}                 # redesigns vs the kernels replaced
        self.share = {}                  # least share of y bitwise plain
        self.entries = {n: {} for n in SOURCES}  # name -> {C entry: count}

    # -- launch counters --------------------------------------------------
    def reset_counts(self):
        for fn, _ in self.kernels.values():
            fn.launches = 0
            if hasattr(fn, "by_variant"):
                fn.by_variant.clear()
            if hasattr(fn, "by_entry"):
                fn.by_entry.clear()

    def read_counts(self):
        counts = {n: fn.launches for n, (fn, _) in self.kernels.items()}
        for row, (owner, entry) in ENTRY_ROWS.items():
            counts[row] = self.kernels[row][0].by_entry[entry]
            counts[owner] -= counts[row]
        return (counts,
                {n: dict(fn.by_variant) for n, (fn, _) in self.kernels.items()
                 if hasattr(fn, "by_variant")})

    def read_entries(self):
        got = {n: dict(fn.by_entry) for n, (fn, _) in self.kernels.items()
               if hasattr(fn, "by_entry")}
        for row, (owner, entry) in ENTRY_ROWS.items():
            n = got[owner].pop(entry, 0)
            got[row] = {entry: n} if n else {}
        return got

    def record(self, path, counts, variants):
        for n, c in counts.items():
            if c:
                self.launches[n][path] = c
        for n, v in variants.items():
            for k, c in v.items():
                self.variants[n][k] = self.variants[n].get(k, 0) + c
        for n, v in self.read_entries().items():
            for k, c in v.items():
                self.entries[n][k] = self.entries[n].get(k, 0) + c

    def require_entries(self, what, plan, variants, times=1):
        """On a bf16 main path: every launch of the grid core, "t" (#1) and
        "th" (#3), went through csrc/grid_mhsa_th.cu's entry points;
        every #6 launch of N <= 63 through csrc/grid_mhsa_packed_mma.cu's,
        of N >= 64 through csrc/grid_mhsa_long.cu's; every MLP forward
        and backward through csrc/mlp_branch_mma.cu's and
        csrc/mlp_branch_bwd_mma.cu's; every forward and backward of the
        fused attention branch through csrc/attn_branch_mma.cu's and
        csrc/attn_branch_bwd_mma.cu's; every forward and backward of #7
        and #8 (Model B's front, C = 64) through csrc/outlook_agg_fwd_mma.cu's
        and csrc/outlook_agg_bwd_mma.cu's; every #9 forward (the same front)
        through csrc/outlook_softmax_rows.cu's. ``plan`` and ``variants``:
        launches per forward or step (:func:`launch_plan`) and ``times`` of
        them."""
        got = self.read_entries()
        for name, entry in (("grid_mhsa_packed", "ogvt_grid_mhsa_packed_mma"),
                            ("grid_mhsa_packed_bwd",
                             "ogvt_grid_mhsa_packed_mma_bwd"),
                            ("grid_mhsa_long", "ogvt_grid_mhsa_long"),
                            ("grid_mhsa_long_bwd",
                             "ogvt_grid_mhsa_long_bwd"),
                            *((name, mma) for name, (mma, _)
                              in (*MLP_ENTRIES.items(),
                                  *ATTN_FWD_ENTRIES.items(),
                                  *ATTN_BWD_ENTRIES.items(),
                                  *OUTLOOK_FWD_ENTRIES.items(),
                                  *OUTLOOK_BWD_ENTRIES.items(),
                                  *SOFTMAX_ENTRIES.items()))):
            want = {entry: plan[name] * times} if plan.get(name) else {}
            if name in plan:
                require(got[name] == want, f"{what}: {name} launches by "
                        f"entry point {got[name]}, expected {want}")
        for name, (mma, _) in GRID_ENTRIES.items():
            if name not in variants:
                continue
            n = sum(variants[name].values()) * times
            want = {mma: n} if n else {}
            require(got[name] == want, f"{what}: {name} launches by entry "
                    f"point {got[name]}, expected {want}")

    # -- inputs -----------------------------------------------------------
    def randn(self, *shape, scale=1.0, shift=0.0):
        import torch

        return (torch.randn(*shape, generator=self.gen) * scale
                + shift).to(self.dev)

    def outlook_args(self, name, B, H, C, heads, dtype, backward=False):
        """(v or x, a, [wv, bv,] wp, bp) of an H x H outlooker of C
        channels, a softmaxed over the 9 taps of each head; for the backward
        the output gradient in place of bp."""
        import torch

        r = self.randn
        a = torch.softmax(r(B, H, H, heads, 9), -1).reshape(B, H, H,
                                                            heads * 9)
        w = [r(C, C, scale=C ** -0.5), r(C, scale=0.02)]
        if name == "outlook_branch":
            w = [r(C, C, scale=C ** -0.5), r(C, scale=0.02)] + w
        if backward:
            w[-1] = r(B, H, H, C)
        return tuple(t.to(dtype) for t in (r(B, H, H, C), a, *w))

    def softmax_args(self, B, H, C, heads, k, dtype):
        """(v, logits, heads, k) of an H x H outlooker, raw logits."""
        return (self.randn(B, H, H, C).to(dtype),
                self.randn(B, H, H, heads * k * k, scale=2.0).to(dtype),
                heads, k)

    def dw_args(self, B, H, C, dtype, backward=False):
        """(x, w9[, dy]) of an H x H depthwise 3x3 of C channels."""
        r = self.randn
        args = (r(B, H, H, C), r(9, C, scale=1 / 3))
        if backward:
            args += (r(B, H, H, C),)
        return tuple(t.to(dtype) for t in args)

    def fwd_args(self, name, sh, dtype, H=None, act="gelu", apply_ln=True,
                 backward=False):
        G, N, C, heads = sh["G"], sh["N"], sh["C"], sh["heads"]
        r = self.randn
        if name == "outlook_softmax":
            return self.softmax_args(sh["batch"], sh["H_img"], C,
                                     sh["outlook_heads"], 3, dtype)
        if name.startswith("dwconv3x3"):
            return self.dw_args(sh["batch"], sh["H_img"], sh["mid"], dtype,
                                backward)
        if name in OUTLOOK:
            return self.outlook_args(name, sh["batch"], sh["H_img"], C,
                                     sh["outlook_heads"], dtype, backward)
        if name in GRID_CORES:
            return (r(G, N, 3 * C).to(dtype), heads)
        ln = (r(C, scale=0.1, shift=1.0), r(C, scale=0.1))
        if name in ("attn_branch", "attn_branch_nhwc"):
            hw = sh["H_img"]
            x = (r(G, N, C) if name == "attn_branch"
                 else r(sh["batch"], hw, hw, C))
            return (x.to(dtype), *ln,
                    r(C, 3 * C, scale=C ** -0.5).to(dtype),
                    r(3 * C, scale=0.02).to(dtype),
                    r(C, C, scale=C ** -0.5).to(dtype),
                    r(C, scale=0.02).to(dtype), heads) \
                + (() if name == "attn_branch" else (sh["g"],))
        M = sh["M"]
        return (r(M, C).to(dtype), *ln, r(C, H, scale=C ** -0.5).to(dtype),
                r(H, scale=0.02).to(dtype),
                r(H, C, scale=H ** -0.5).to(dtype), r(C, scale=0.02).to(dtype),
                act, 1e-5, apply_ln)

    def bwd_args(self, name, sh, dtype, H=None, act="gelu", apply_ln=True):
        base = name[:-len("_bwd")]
        args = self.fwd_args(base, sh, dtype, H, act, apply_ln,
                             base in OUTLOOK or base == "dwconv3x3")
        if base in OUTLOOK or base == "dwconv3x3":
            # (v, a, wp, g) / (x, a, wv, bv, wp, g) / (x, w9, dy)
            return args
        if base in GRID_CORES:
            dout = self.randn(sh["G"], sh["N"], sh["C"]).to(dtype)
            return (args[0], dout, args[1])
        # the branches: dy at unit scale, so that dx is large against the
        # tolerance's absolute term
        return (*args[:7], self.randn(*args[0].shape).to(dtype), *args[7:])

    def cases(self, shapes, backward, dtype, outlook=(), dw=False,
              core=True):
        """(name, args, label, shape, launches per forward) of every kernel
        at every stage shape that runs it: with ``core`` the attention and
        MLP kernels, the outlook kernels in ``outlook`` at the shapes of the
        stages' outlookers, with ``dw`` the depthwise kernels at the
        MBConvs'."""
        out = []
        sfx = "_bwd" if backward else ""
        for sh in shapes:
            tag = f"stage{sh['stage']}"
            names = [(ATTN_KERNEL[sh["attn"]], None, sh["blocks"]),
                     ("mlp_branch", sh["H_outlook"], sh["outlook"]),
                     ("mlp_branch", sh["H_block"], sh["blocks"])] \
                if core else []
            names += [(k, None, sh["outlook"]) for k in outlook
                      if k + sfx in self.kernels]
            if dw:
                names.append(("dwconv3x3", None, sh["blocks"]))
            for base, H, count in names:
                if not count:
                    continue
                name = base + ("_bwd" if backward else "")
                make = self.bwd_args if backward else self.fwd_args
                if base == "mlp_branch":
                    label = (f"{tag} M={sh['M']} C={sh['C']} H={H} "
                             f"variant={sh['mlp_variant']}")
                elif base == "dwconv3x3":
                    label = (f"{tag} B={sh['batch']} H=W={sh['H_img']} "
                             f"C={sh['mid']}")
                elif base in OUTLOOK or base == "outlook_softmax":
                    label = (f"{tag} B={sh['batch']} "
                             f"H=W={sh['H_img']} C={sh['C']} "
                             f"heads={sh['outlook_heads']}")
                else:
                    label = (f"{tag} G={sh['G']} N={sh['N']} C={sh['C']} "
                             f"heads={sh['heads']}")
                    if base == "grid_mhsa":
                        label += f" variant={sh['grid_variant']}"
                    if base == "attn_branch_nhwc":
                        label += (f" (B={sh['batch']} H=W={sh['H_img']} "
                                  f"g={sh['g']})")
                out.append((name, make(name, sh, dtype, H), label, sh, count))
        return out

    # -- kernel vs plain --------------------------------------------------
    def compare(self, name, args, dtype, label):
        import torch

        plain = self.kernels[name][1]
        kernel = self.launch.get(name, self.kernels[name][0])
        dt = str(dtype).split(".")[-1]
        backward = name.endswith("_bwd")
        routed = (ATTN_FWD_ENTRIES.get(name) or ATTN_BWD_ENTRIES.get(name)
                  or GRID_ENTRIES.get(name) or OUTLOOK_FWD_ENTRIES.get(name)
                  or OUTLOOK_BWD_ENTRIES.get(name)
                  or SOFTMAX_ENTRIES.get(name))
        twice = backward or routed is not None
        before = dict(self.kernels[name][0].by_entry) if routed else None
        got = kernel(*args)
        again = kernel(*args) if twice else got
        torch.cuda.synchronize()
        if routed:  # the entry its dtype (and, outlook, its shape) takes
            entry = (outlook_entry(name, args) if name in
                     (*OUTLOOK_FWD_ENTRIES, *OUTLOOK_BWD_ENTRIES)
                     else softmax_entry(args) if name in SOFTMAX_ENTRIES
                     else routed[0 if dt == "bfloat16" else 1])
            delta = {k: v - before.get(k, 0)
                     for k, v in self.kernels[name][0].by_entry.items()
                     if v - before.get(k, 0)}
            require(delta == {entry: 2}, f"{name} {label} {dt}: launches "
                    f"by entry point {delta}, expected {{{entry!r}: 2}}")
        want = plain(*args)
        got, again, want = ((t,) if torch.is_tensor(t) else t
                            for t in (got, again, want))
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{name} {label}: two calls differ")
        if name in BITWISE:
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{name} {label}: not bitwise equal to the plain version")
        share = None
        if (name in BITWISE_SHARE or name in SHARE_REPORTED) \
                and dt == "bfloat16":
            share = (got[0] == want[0]).float().mean().item()
            self.share[name] = min(self.share.get(name, 1.0), share)
        if name in SHARE_OUTPUTS and dt == "bfloat16":
            share = {k: (g == w).float().mean().item() for k, g, w in
                     zip(SHARE_OUTPUTS[name], got, want)}
            self.share[name] = {k: min(self.share.get(name, {}).get(k, 1.0),
                                       v) for k, v in share.items()}
            share = ", ".join(f"{k} {v:.4%}" for k, v in share.items())
        if name in BITWISE_SHARE and dt == "bfloat16":
            require(share >= BITWISE_SHARE[name],
                    f"{name} {label}: {share:.4%} of the outputs bitwise "
                    f"equal to the plain version's, below "
                    f"{BITWISE_SHARE[name]:.0%}")
        worst = []
        for i, (g, w) in enumerate(zip(got, want)):
            require(torch.isfinite(g.float()).all().item(),
                    f"{name} {label} output {i}: non-finite")
            diff = (g.float() - w.float()).abs()
            if i in PER_ELEMENT.get(name, (0,)):  # output, dx, dqkv, da
                tol = KERNEL_TOL[dt]
                ok = bool((diff <= tol + tol * w.float().abs()).all())
                self.max_err[name] = max(self.max_err[name],
                                         diff.max().item())
                worst.append(f"max_abs_err={diff.max().item():.3e}")
            else:  # parameter grads: sums over all tokens, rel to max
                scale = w.float().abs().max().item()
                rel = diff.max().item() / max(scale, 1e-30)
                ok = rel <= WGRAD_TOL[dt]
                worst.append(f"g{i}={rel:.1e}")
            require(ok, f"{name} {label} output {i}: kernel disagrees with "
                    "plain version")
        print(f"[compare] {name} {label} {dt} " + " ".join(worst)
              + f" (tol {KERNEL_TOL[dt]:g} abs+rel; param grads rel to max, "
              f"tol {WGRAD_TOL[dt]:g})"
              + (" deterministic ok" if twice else "")
              + (f" via {entry}" if routed else "")
              + (" bitwise ok" if name in BITWISE else "")
              + ("" if share is None else " bitwise equal "
                 + (share if isinstance(share, str) else f"{share:.4%}")
                 + (f" (at least {BITWISE_SHARE[name]:.0%})"
                    if name in BITWISE_SHARE else " (reported, not gated)")))

    def compare_all(self, case: ModelCase):
        import torch

        if case is MODEL_B_O:  # its attention and MLP kernels: MODEL_B's
            self.compare_outlook_softmax()
            self.compare_dwconv()
            return
        for backward, batch in ((False, BATCH), (True, TRAIN_BATCH)):
            shapes = stage_shapes(case, batch)
            for dtype in (torch.float32, torch.bfloat16):
                for name, args, label, *_ in self.cases(shapes, backward,
                                                        dtype):
                    self.compare(name, args, dtype, f"{case.tag} {label}")
                    del args
                if case is MODEL_B:
                    self.compare_outlook(backward, batch, dtype)
            if case is A_BASE:
                self.compare_nhwc_with_tokens(shapes[0], backward)
            if case is FLAGSHIP:  # every activation and the no-LN form
                sh = shapes[0]
                name = "mlp_branch" + ("_bwd" if backward else "")
                make = self.bwd_args if backward else self.fwd_args
                for dtype in (torch.float32, torch.bfloat16):
                    for act in ("silu", "relu"):
                        self.compare(name, make(name, sh, dtype,
                                                sh["H_block"], act, False),
                                     dtype, f"{case.tag} stage0 M={sh['M']} "
                                     f"C={sh['C']} act={act} ln=False")

    def compare_nhwc_with_tokens(self, sh, backward):
        """#12 against #5 on the same inputs, partitioned: the forward bit
        for bit; dx bit for bit and the parameter grads within WGRAD_TOL
        (the windows are walked in partition order, so they are expected
        bitwise too; the line says whether they are)."""
        import torch

        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            name = "attn_branch_nhwc" + ("_bwd" if backward else "")
            args = (self.bwd_args if backward else self.fwd_args)(
                name, sh, dtype)
            counts = [self.kernels[n][0].by_entry.copy()
                      for n in (name, name.replace("_nhwc", ""))]
            got = self.kernels[name][0](*args)
            want = nhwc_via_tokens(args, backward)
            which = 0 if dtype == torch.bfloat16 else 1
            for n, c in zip((name, name.replace("_nhwc", "")), counts):
                entry = (ATTN_BWD_ENTRIES if backward
                         else ATTN_FWD_ENTRIES)[n][which]
                delta = +(self.kernels[n][0].by_entry - c)
                require(delta == {entry: 1}, f"{name} a_base stage0 {dt}: "
                        f"{n} launched {dict(delta)}, expected {entry}")
            if not backward:
                require(torch.equal(got, want),
                        f"{name} a_base stage0 {dt}: not bitwise equal to "
                        "partition -> attn_branch -> unpartition")
                print(f"[compare] {name} a_base stage0 {dt} vs partition -> "
                      "attn_branch -> unpartition: bitwise equal (both "
                      f"{'tensor-core' if which == 0 else 'FMA'} kernels)")
                continue
            require(torch.equal(got[0], want[0]),
                    f"{name} {dt}: dx differs from attn_branch_backward's")
            rel = [((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30)).item()
                   for g, w in zip(got[1:], want[1:])]
            bitwise = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
            require(max(rel) <= WGRAD_TOL[dt],
                    f"{name} {dt}: param grads off attn_branch_backward's by "
                    f"{rel}")
            # the blocks take the same grids on both layouts
            require(bitwise, f"{name} {dt}: param grads not bitwise equal "
                    "to attn_branch_backward's")
            print(f"[compare] {name} a_base stage0 {dt} vs attn_branch_"
                  f"backward on the partitioned inputs: dx bitwise equal; "
                  f"param grads max rel {max(rel):.1e} (tol "
                  f"{WGRAD_TOL[dt]:g}), bitwise equal: {bitwise}")

    def ab_nhwc(self, iters=20):
        """The switch's A/B at ``a_base`` stage 0 in bf16: #12 against
        partition -> #5 -> unpartition (the two copies included), forward
        at the serving batch and backward at the train batch, timed in
        turns (#12, #5, #5, #12) in this process."""
        import torch

        for backward, batch in ((False, BATCH), (True, TRAIN_BATCH)):
            sh = stage_shapes(A_BASE, batch)[0]
            name = "attn_branch_nhwc" + ("_bwd" if backward else "")
            args = (self.bwd_args if backward else self.fwd_args)(
                name, sh, torch.bfloat16)
            fns = {"nhwc": lambda: self.kernels[name][0](*args),
                   "tokens": lambda: nhwc_via_tokens(args, backward)}
            runs = {"nhwc": [], "tokens": []}
            for which in ("nhwc", "tokens", "tokens", "nhwc"):
                runs[which].append(time_ms(fns[which], (), iters=iters,
                                           warmup=3))
            res = {k: sum(v) / len(v) for k, v in runs.items()}
            self.ab[name] = dict(
                res, per_launch=True, batch=batch,
                runs={k: [round(t, 6) for t in v] for k, v in runs.items()})
            print(f"[ab] a_base stage0 {name} B={batch} bf16, per launch: "
                  f"#12 {res['nhwc']:.4f} ms ({runs['nhwc'][0]:.4f}, "
                  f"{runs['nhwc'][1]:.4f}) vs partition + #5 + unpartition "
                  f"{res['tokens']:.4f} ms ({runs['tokens'][0]:.4f}, "
                  f"{runs['tokens'][1]:.4f}): #12/#5+copies "
                  f"{res['nhwc'] / res['tokens']:.3f} [{self.gpu}]")
            del args

    def ab_vs_library(self, iters=20):
        """Kernels against the one PyTorch call computing the same function
        (:func:`library_call`) on the same inputs, bf16, at the shapes of
        ``AB_LIBRARY``: the depthwise backward vs
        ``aten.convolution_backward`` (cuDNN) and the depthwise forward vs
        ``F.conv2d(groups=C)``; the grid cores vs SDPA (and its autograd
        backward): #1 ("t" launches) and #3 ("th" launches), both on
        ``csrc/grid_mhsa_th.cu`` in bf16, and #6
        (``csrc/grid_mhsa_packed_mma.cu``, ``csrc/grid_mhsa_long.cu``). Per
        shape in turns (kernel, library, library, kernel) in this process:
        device time (``iters`` calls in one CUDA graph, :func:`graph_ms`),
        then eager time (CUDA events around ``iters`` calls, host time
        included), each with its share of the bound; summed per forward or
        train step of the case."""
        import torch

        for name, case, batch, which in AB_LIBRARY:
            backward = name.endswith("_bwd")
            call = self.launch.get(name, self.kernels[name][0])
            lib = "cudnn" if name.startswith("dwconv") else "sdpa"
            shapes = [sh for sh in stage_shapes(case, batch)
                      if AB_SHAPES[which](sh)]
            res = self.ab_lib.setdefault(name, {})
            total = {"bound": 0.0}
            for sh in shapes:
                args = (self.bwd_args if backward else self.fwd_args)(
                    name, sh, torch.bfloat16)
                # the library call made on the stream its graph is captured
                # on: autograd runs a backward on its forward's stream
                stream = torch.cuda.Stream()
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    fns = {"kernel": lambda: call(*args),
                           lib: library_call(name, args)}
                torch.cuda.current_stream().wait_stream(stream)
                streams = {"kernel": None, lib: stream}
                bound = max(bound_ms(name, args, call(*args),
                                     torch.bfloat16))
                label = (f"{case.tag} stage{sh['stage']} B={batch} "
                         + (f"H=W={sh['H_img']} C={sh['mid']}"
                            if lib == "cudnn" else
                            f"G={sh['G']} N={sh['N']} C={sh['C']} "
                            f"heads={sh['heads']}"))
                res[label] = {"bound_ms": bound, "launches": sh["blocks"]}
                for how, timer in (
                        ("device", lambda f, w: graph_ms(f, iters,
                                                         streams[w])),
                        ("eager", lambda f, w: time_ms(f, (), iters,
                                                       warmup=3))):
                    runs = {"kernel": [], lib: []}
                    for w in ("kernel", lib, lib, "kernel"):
                        runs[w].append(timer(fns[w], w))
                    k, l = (sum(v) / len(v) for v in runs.values())
                    res[label][how] = {
                        "kernel_ms": k, f"{lib}_ms": l,
                        "kernel_bound_share": bound / k,
                        f"{lib}_bound_share": bound / l,
                        "runs": {w: [round(t, 6) for t in v]
                                 for w, v in runs.items()}}
                    print(f"[ab] {name} {label} bf16 {how}, per launch: "
                          f"kernel {k * 1e3:.1f} us ("
                          f"{runs['kernel'][0] * 1e3:.1f}, "
                          f"{runs['kernel'][1] * 1e3:.1f}) vs "
                          f"{LIBRARY[lib]} {l * 1e3:.1f} us "
                          f"({runs[lib][0] * 1e3:.1f}, "
                          f"{runs[lib][1] * 1e3:.1f}): kernel/"
                          f"{LIBRARY[lib]} {k / l:.3f}; bound "
                          f"{bound * 1e3:.2f} us, kernel at {bound / k:.1%} "
                          f"of it, {LIBRARY[lib]} at {bound / l:.1%} "
                          f"[{self.gpu}]")
                    for key, t in (("kernel", k), (lib, l)):
                        total[f"{how}_{key}"] = (total.get(f"{how}_{key}",
                                                           0.0)
                                                 + sh["blocks"] * t)
                total["bound"] += sh["blocks"] * bound
                del args, fns
            if which == "stage0":  # one stage: no total
                continue
            per = (f"{case.tag} {'train step' if backward else 'forward'} "
                   f"B={batch}")
            res[per] = total
            for how in ("device", "eager"):
                k, l = total[f"{how}_kernel"], total[f"{how}_{lib}"]
                print(f"[ab] {name} per {per} "
                      f"({sum(sh['blocks'] for sh in shapes)} launches, "
                      f"bf16) {how}: kernel {k:.4f} ms vs {LIBRARY[lib]} "
                      f"{l:.4f} ms: {k / l:.3f}; bound {total['bound']:.4f} "
                      f"ms, kernel at {total['bound'] / k:.1%}, "
                      f"{LIBRARY[lib]} at {total['bound'] / l:.1%} "
                      f"[{self.gpu}]")
            torch.cuda.empty_cache()

    def ab_fma_shape(self, name, label, args, fns, entries, n, count,
                     total, sides=("mma", "fma")):
        """One shape of a redesigned kernel's A/B in bf16 against the kernel
        it replaces (``sides``: the new and the old side's keys, by default
        a tensor-core kernel and the FMA one): ``fns`` (a callable for each
        side launching ``entries``' C entry points on ``args``) each
        launched once through its own entry point, then timed in turns
        (new, old, old, new), device time (``n[side]`` calls in one CUDA
        graph, :func:`graph_ms`) then eager time (host time included), each
        with its share of the bound. Printed, added ``count`` times to
        ``total`` (bound, launches, ``{device,eager}_{side}``) and
        returned."""
        import torch

        new, old = sides
        what = {"mma": "mma", "fma": "the FMA kernel it replaces",
                "old": "the kernel it replaces"}
        call = self.kernels[name][0]
        for w, e in entries.items():  # each side its kernel
            before = call.by_entry[e]
            outs = fns[w]()
            require(call.by_entry[e] == before + 1,
                    f"{name} A/B: {w} did not launch {e}")
        bound = max(bound_ms(name, args, outs, torch.bfloat16))
        del outs
        res = {"bound_ms": bound, "launches": count}
        for how, timer in (
                ("device", lambda f, w: graph_ms(f, n[w])),
                ("eager", lambda f, w: time_ms(f, (), n[w], warmup=1))):
            runs = {new: [], old: []}
            for w in (new, old, old, new):
                runs[w].append(timer(fns[w], w))
            k, f = (sum(v) / len(v) for v in runs.values())
            res[how] = {
                f"{new}_ms": k, f"{old}_ms": f,
                f"{new}_bound_share": bound / k,
                f"{old}_bound_share": bound / f,
                "runs": {w: [round(t, 6) for t in v]
                         for w, v in runs.items()}}
            print(f"[ab] {name} {label} bf16 {how}, per launch: "
                  f"{what.get(new, new)} {k * 1e3:.1f} us "
                  f"({runs[new][0] * 1e3:.1f}, {runs[new][1] * 1e3:.1f}) vs "
                  f"{what[old]} {f * 1e3:.1f} us: {new}/{old} {k / f:.4f}; "
                  f"bound {bound * 1e3:.2f} us, {new} at {bound / k:.1%} of "
                  f"it, {old} at {bound / f:.2%} [{self.gpu}]")
            for key, t in ((new, k), (old, f)):
                total[f"{how}_{key}"] = (total.get(f"{how}_{key}", 0.0)
                                         + count * t)
        total["bound"] += count * bound
        total["launches"] += count
        return res

    def ab_fma_total(self, name, per, total, sides=("mma", "fma")):
        """Print an A/B's ``total`` (:meth:`ab_fma_shape`) per ``per``."""
        new, old = sides
        for how in ("device", "eager"):
            k, f = total[f"{how}_{new}"], total[f"{how}_{old}"]
            print(f"[ab] {name} per {per} ({total['launches']} launches, "
                  f"bf16) {how}: {new} {k:.4f} ms vs the "
                  f"{'FMA ' if old == 'fma' else ''}kernel it replaces "
                  f"{f:.4f} ms: {k / f:.4f}; bound {total['bound']:.4f} ms, "
                  f"{new} at {total['bound'] / k:.1%}, {old} at "
                  f"{total['bound'] / f:.2%} [{self.gpu}]")

    def ab_mlp(self, iters=10, fma_iters=2):
        """The MLP kernels' A/B in bf16: ``csrc/mlp_branch_mma.cu`` and
        ``csrc/mlp_branch_bwd_mma.cu`` (the main paths' kernels) against
        ``csrc/mlp_branch.cu`` and ``csrc/mlp_branch_bwd.cu``, the FMA
        kernels they replace there, on the same inputs at every MLP shape of
        ``AB_MLP``'s paths (the outlooker MLPs, H = 2C, and the block MLPs,
        H = 4C): the forward at batch 64, the backward at the train batch
        128. Per shape in turns (:meth:`ab_fma_shape`; ``fma_iters`` of the
        slow kernel in a graph); summed per forward and per train step."""
        import torch

        from outgridvit_tpu_torch.ops.mlp_branch import (
            _launch_backward,
            _launch_forward,
        )

        for name, batch, per, launch, make in (
                ("mlp_branch", BATCH, f"forward B={BATCH}", _launch_forward,
                 self.fwd_args),
                ("mlp_branch_bwd", TRAIN_BATCH, f"train step B={TRAIN_BATCH}",
                 _launch_backward, self.bwd_args)):
            entries = dict(zip(("mma", "fma"), MLP_ENTRIES[name]))
            for case in AB_MLP:
                total = {"bound": 0.0, "launches": 0}
                res = self.ab_fma.setdefault(name, {}).setdefault(case.tag,
                                                                  {})
                for sh in stage_shapes(case, batch):
                    for H, count in ((sh["H_outlook"], sh["outlook"]),
                                     (sh["H_block"], sh["blocks"])):
                        if not count:
                            continue
                        args = make(name, sh, torch.bfloat16, H)
                        fns = {w: (lambda e=e: launch(e, *args,
                                                      sh["mlp_variant"]))
                               for w, e in entries.items()}
                        label = (f"{case.tag} stage{sh['stage']} "
                                 f"M={sh['M']} C={sh['C']} H={H} "
                                 f"variant={sh['mlp_variant']}")
                        res[label] = self.ab_fma_shape(
                            name, label, args, fns, entries,
                            {"mma": iters, "fma": fma_iters}, count, total)
                        del args, fns
                res[f"{case.tag} {per}"] = total
                self.ab_fma_total(name, f"{case.tag} {per}", total)
                torch.cuda.empty_cache()

    def ab_attn(self, iters=10, fma_iters=2):
        """The fused attention branch's A/B in bf16: the main paths'
        tensor-core kernels, ``csrc/attn_branch_mma.cu`` forward and
        ``csrc/attn_branch_bwd_mma.cu`` backward, against
        ``csrc/attn_branch.cu``'s FMA kernels they replace there, on the
        same inputs at the stage-0 shapes of ``AB_ATTN_FWD`` (the forward,
        at batch 64 per forward and at the train batch 128 per train step)
        and ``AB_ATTN`` (the backward, at 128 per train step). Per shape in
        turns (mma, FMA, FMA, mma) in this process: device time (calls in
        one CUDA graph, :func:`graph_ms`; ``fma_iters`` of the slow
        kernel), then eager time (host time included), each with its share
        of the bound, per launch and per forward or train step. Beside
        them, for scale only (no gate, not ``library_ms``): the same
        function composed of library calls, ``F.layer_norm`` ->
        ``F.linear`` -> SDPA -> ``F.linear`` (for the backward, its autograd
        backward), timed the same ways."""
        import torch

        from outgridvit_tpu_torch.ops.attn_branch import (
            _launch_backward,
            _launch_forward,
            _launch_nhwc_backward,
            _launch_nhwc_forward,
        )

        launchers = {"attn_branch": _launch_forward,
                     "attn_branch_nhwc": _launch_nhwc_forward,
                     "attn_branch_bwd": _launch_backward,
                     "attn_branch_nhwc_bwd": _launch_nhwc_backward}
        todo = ([(name, case, BATCH) for name, case in AB_ATTN_FWD]
                + [(name, case, TRAIN_BATCH) for name, case in AB_ATTN_FWD]
                + [(name, case, TRAIN_BATCH) for name, case in AB_ATTN])
        for name, case, batch in todo:
            backward = name.endswith("_bwd")
            sh = stage_shapes(case, batch)[0]
            launch = launchers[name]
            call = self.kernels[name][0]
            args = (self.bwd_args if backward else self.fwd_args)(
                name, sh, torch.bfloat16)
            entries = dict(zip(("mma", "fma"), (
                ATTN_BWD_ENTRIES if backward else ATTN_FWD_ENTRIES)[name]))
            fns = {w: (lambda e=e: launch(e, *args))
                   for w, e in entries.items()}
            for w, e in entries.items():  # each side its kernel
                before = call.by_entry[e]
                outs = fns[w]()
                require(call.by_entry[e] == before + 1,
                        f"{name} A/B: {w} did not launch {e}")
            bound = max(bound_ms(name, args, outs, torch.bfloat16))
            del outs
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                composed = (composed_branch_backward if backward
                            else composed_branch_forward)(args, name)
            torch.cuda.current_stream().wait_stream(stream)
            n, blocks = {"mma": iters, "fma": fma_iters}, sh["blocks"]
            unit = "step" if batch == TRAIN_BATCH else "forward"
            per = ("train step" if unit == "step" else "forward")
            label = (f"{case.tag} stage0 B={batch} G={sh['G']} "
                     f"N={sh['N']} C={sh['C']} heads={sh['heads']}")
            res = self.ab_fma.setdefault(name, {})[label] = {
                "bound_ms": bound, "launches": blocks,
                f"bound_per_{unit}_ms": blocks * bound}
            for how, timer, ctimer in (
                    ("device", lambda f, w: graph_ms(f, n[w]),
                     lambda f: graph_ms(f, iters, stream)),
                    ("eager", lambda f, w: time_ms(f, (), n[w], warmup=1),
                     lambda f: time_ms(f, (), iters, warmup=1))):
                runs = {"mma": [], "fma": []}
                for w in ("mma", "fma", "fma", "mma"):
                    runs[w].append(timer(fns[w], w))
                k, f = (sum(v) / len(v) for v in runs.values())
                c = ctimer(composed)
                res[how] = {
                    "mma_ms": k, "fma_ms": f, "mma_bound_share": bound / k,
                    "fma_bound_share": bound / f,
                    f"per_{unit}_mma_ms": blocks * k,
                    f"per_{unit}_fma_ms": blocks * f,
                    "composed_library_ms": c,
                    "runs": {w: [round(t, 6) for t in v]
                             for w, v in runs.items()}}
                print(f"[ab] {name} {label} bf16 {how}, per launch: mma "
                      f"{k * 1e3:.1f} us ({runs['mma'][0] * 1e3:.1f}, "
                      f"{runs['mma'][1] * 1e3:.1f}) vs the FMA kernel it "
                      f"replaces {f * 1e3:.1f} us: mma/FMA {k / f:.4f}; "
                      f"bound {bound * 1e3:.2f} us, mma at {bound / k:.2%} "
                      f"of it, FMA at {bound / f:.2%}; per {per} "
                      f"({blocks} launches) mma {blocks * k:.4f} ms, FMA "
                      f"{blocks * f:.4f} ms, bound {blocks * bound:.4f} ms; "
                      f"for scale, LN -> linear -> SDPA -> linear"
                      f"{' autograd backward' if backward else ''} "
                      f"{c * 1e3:.1f} us [{self.gpu}]")
            del args, fns, composed
            torch.cuda.empty_cache()

    def ab_grid(self, iters=10, fma_iters=3):
        """#1's A/B in bf16: ``csrc/grid_mhsa_th.cu`` (every bf16 launch
        of the main paths) against ``csrc/grid_mhsa.cu``, the FMA kernel it
        replaces for the "t" launches, on the same inputs at every "t"
        stage shape of ``AB_GRID``'s paths (the 7M model, Model B,
        ``a7m_48``): the forward at batch 64, per forward, the backward at
        the train batch 128, per train step. Per shape in turns
        (:meth:`ab_fma_shape`; ``fma_iters`` of the slow kernel in a
        graph), per launch and summed per forward and per train step. Both
        sides go through ``ops/grid_attention.py:_launch``."""
        import torch

        from outgridvit_tpu_torch.ops.grid_attention import _launch

        for name, batch, per in (
                ("grid_mhsa", BATCH, f"forward B={BATCH}"),
                ("grid_mhsa_bwd", TRAIN_BATCH, f"train step B={TRAIN_BATCH}")):
            backward = name.endswith("_bwd")
            entries = dict(zip(("mma", "fma"), GRID_ENTRIES[name]))
            for case in AB_GRID:
                total = {"bound": 0.0, "launches": 0}
                res = self.ab_fma.setdefault(name, {}).setdefault(case.tag,
                                                                  {})
                for sh in stage_shapes(case, batch):
                    if not AB_SHAPES["t"](sh):
                        continue
                    args = (self.bwd_args if backward else self.fwd_args)(
                        name, sh, torch.bfloat16)
                    qkv, heads = args[0], args[-1]
                    dout = args[1] if backward else None
                    fns = {w: (lambda e=e: _launch(e, qkv, heads, "t", dout))
                           for w, e in entries.items()}
                    label = (f"{case.tag} stage{sh['stage']} B={batch} "
                             f"G={sh['G']} N={sh['N']} C={sh['C']} "
                             f"heads={sh['heads']}")
                    res[label] = self.ab_fma_shape(
                        name, label, args, fns, entries,
                        {"mma": iters, "fma": fma_iters}, sh["blocks"],
                        total)
                    del args, fns, qkv, dout
                res[f"{case.tag} {per}"] = total
                self.ab_fma_total(name, f"{case.tag} {per}", total)
                torch.cuda.empty_cache()

    def ab_outlook(self, iters=10, fma_iters=2):
        """#9, #7 and #8 in bf16, each redesign in turns with the kernel it
        replaces (:meth:`ab_fma_shape`; ``fma_iters`` of the slow kernel in
        a graph), device time (calls in one CUDA graph, :func:`graph_ms`)
        and eager, each with its share of the bound. First #9's row kernel
        ``csrc/outlook_softmax_rows.cu`` against ``csrc/outlook_softmax.cu``
        at the serving batch 64, per launch and per forward (3 launches) at
        Model B's front (H = W = 32, C = 64, 2 heads) and per launch at
        every other ``OUTLOOK_SHAPES`` entry its plan takes. Then #7 and
        #8: the forward's tensor-core kernel ``csrc/outlook_agg_fwd_mma.cu``
        against the FMA kernel ``csrc/outlook_agg.cu`` it replaces at batch
        64, per launch and per forward at Model B's front and per launch at
        every other ``OUTLOOK_SHAPES`` entry its plan takes; then the
        backward's, ``csrc/outlook_agg_bwd_mma.cu`` against
        ``csrc/outlook_agg.cu``, the same way at the train batch 128, per
        train step at the front."""
        import torch

        from outgridvit_tpu_torch.ops.outlook_agg import (
            _launch_backward,
            _launch_forward,
        )
        from outgridvit_tpu_torch.ops.outlook_softmax import _launch

        bf = torch.bfloat16
        n = MODEL_B.front
        name = "outlook_softmax"
        entries = dict(zip(("rows", "old"), SOFTMAX_ENTRIES[name]))
        res = self.ab_fma.setdefault(name, {})
        for cfg, (h, c, hh) in ((cfg, sh) for cfg, shs in
                                OUTLOOK_SHAPES.items() for sh in shs):
            args = self.softmax_args(BATCH, h, c, hh, 3, bf)
            if softmax_entry(args) != entries["rows"]:
                continue
            fns = {w: (lambda e=e: _launch(e, *args))
                   for w, e in entries.items()}
            front = cfg == "model_b front"
            label = f"{cfg} B={BATCH} H=W={h} C={c} heads={hh}"
            total = {"bound": 0.0, "launches": 0}
            res[label] = self.ab_fma_shape(
                name, label, args, fns, entries,
                {"rows": iters, "old": fma_iters}, n if front else 1, total,
                sides=("rows", "old"))
            if front:
                per = f"model_b_o forward B={BATCH}"
                res[per] = total
                self.ab_fma_total(name, per, total, sides=("rows", "old"))
            del args, fns
        shapes = [(cfg, sh) for cfg, shs in OUTLOOK_SHAPES.items()
                  for sh in shs]
        for base, wrapper, backward in (
                ("outlook_agg", "outlook_agg_proj", False),
                ("outlook_branch", "outlook_branch", False),
                ("outlook_agg", "outlook_agg_proj_backward", True),
                ("outlook_branch", "outlook_branch_backward", True)):
            name = base + ("_bwd" if backward else "")
            batch = TRAIN_BATCH if backward else BATCH
            launch = _launch_backward if backward else _launch_forward
            entries = dict(zip(("mma", "fma"), (
                OUTLOOK_BWD_ENTRIES if backward else OUTLOOK_FWD_ENTRIES)[
                    name]))
            res = self.ab_fma.setdefault(name, {})
            for cfg, (h, c, hh) in shapes:
                args = self.outlook_args(base, batch, h, c, hh, bf,
                                         backward=backward)
                if outlook_entry(name, args) != entries["mma"]:
                    continue
                # (v, a, wp, bp or g) / (x, a, wv, bv, wp, bp or g)
                full = args if base == "outlook_branch" else (
                    args[0], args[1], None, None, *args[2:])
                fns = {w: (lambda e=e: launch(e, wrapper, *full))
                       for w, e in entries.items()}
                front = cfg == "model_b front"
                label = f"{cfg} B={batch} H=W={h} C={c} heads={hh}"
                total = {"bound": 0.0, "launches": 0}
                res[label] = self.ab_fma_shape(
                    name, label, args, fns, entries,
                    {"mma": iters, "fma": fma_iters}, n if front else 1,
                    total)
                if front:
                    per = (f"model_b train step B={batch}" if backward
                           else f"model_b forward B={batch}")
                    res[per] = total
                    self.ab_fma_total(name, per, total)
                del args, full, fns
                torch.cuda.empty_cache()

    def compare_outlook(self, backward, batch, dtype):
        """Both outlook kernels against their plain versions at every
        outlooker shape of the three configurations."""
        sfx = "_bwd" if backward else ""
        for cfg, shapes in OUTLOOK_SHAPES.items():
            for H, C, heads in shapes:
                for base in OUTLOOK:
                    args = self.outlook_args(base, batch, H, C, heads, dtype,
                                             backward)
                    self.compare(base + sfx, args, dtype,
                                 f"{cfg} B={batch} H=W={H} C={C} "
                                 f"heads={heads}")
                    del args

    def compare_outlook_softmax(self):
        """#9 against its plain version at every outlooker shape of the
        three configurations (K = 3), and at Model B's front with K = 5."""
        import torch

        shapes = [(cfg, H, C, heads, 3)
                  for cfg, sh in OUTLOOK_SHAPES.items() for H, C, heads in sh]
        shapes.append(("model_b front", 32, 64, 2, 5))
        for dtype in (torch.float32, torch.bfloat16):
            for cfg, H, C, heads, k in shapes:
                self.compare("outlook_softmax", self.softmax_args(
                    BATCH, H, C, heads, k, dtype), dtype,
                    f"{cfg} B={BATCH} H=W={H} C={C} heads={heads} K={k}")

    def compare_dwconv(self):
        """The depthwise kernels against their plain versions at every
        MBConv depthwise shape of the five configurations and the 7M model
        at 96 px (W = 96, the widest rows either plan tiles): forward at the
        serving batch, bit for bit; backward at the train batch."""
        import torch

        for backward, batch in ((False, BATCH), (True, TRAIN_BATCH)):
            name = "dwconv3x3" + ("_bwd" if backward else "")
            for dtype in (torch.float32, torch.bfloat16):
                for case in (FLAGSHIP, TIN, MODEL_B, A7M_48, A_BASE, A7M_96):
                    for sh in stage_shapes(case, batch):
                        args = self.dw_args(batch, sh["H_img"], sh["mid"],
                                            dtype, backward)
                        self.compare(name, args, dtype,
                                     f"{case.tag} stage{sh['stage']} "
                                     f"B={batch} H=W={sh['H_img']} "
                                     f"C={sh['mid']}")
                        del args
                torch.cuda.empty_cache()

    def time_kernels(self, case: ModelCase, backward: bool, iters: int):
        """µs per launch at every stage shape in bf16: the kernel, its plain
        version, the one PyTorch call computing the same function where
        there is one (:func:`library_call`), and the bound
        (:func:`bound_ms`); summed per forward or per train step into
        ``self.ms`` for the kernels timed on this case (``TIMED_ON``).
        Model B times the outlook kernels at its front; the fused_outlook
        case only #9 and the depthwise kernels, the 7M "bwd" case only the
        depthwise backward."""
        import torch

        new = case in (MODEL_B_O, A7M_DWB)  # this slice's kernels only
        outlook = (("outlook_softmax",) if case is MODEL_B_O
                   else () if new else OUTLOOK if case.front else ())
        shapes = stage_shapes(case, TRAIN_BATCH if backward else BATCH)
        totals = {}
        for name, args, label, sh, count in self.cases(
                shapes, backward, torch.bfloat16, outlook, dw=new,
                core=not new):
            if (case in (A7M_48, A_BASE, A7M_96) and TIMED_ON.get(
                    name.removesuffix("_bwd")) != case.tag):
                continue  # the kernels of the path timed on another case
            plain = self.kernels[name][1]
            kern = self.launch.get(name, self.kernels[name][0])
            k_ms = time_ms(kern, args, iters=iters, warmup=2)
            p_ms = time_ms(plain, args, iters=iters, warmup=2)
            lib = library_call(name, args)
            l_ms = None if lib is None else time_ms(lib, (), iters=iters,
                                                    warmup=2)
            by_bytes, by_ops = bound_ms(name, args, kern(*args),
                                        torch.bfloat16)
            t = totals.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                         "library_ms": None, "bytes": 0.0,
                                         "ops": 0.0, "bound_ms": 0.0})
            t["ms"] += count * k_ms
            t["plain_ms"] += count * p_ms
            if l_ms is not None:
                t["library_ms"] = (t["library_ms"] or 0.0) + count * l_ms
            # each launch is bound by the larger of its two times
            t["bytes" if by_bytes >= by_ops else "ops"] += \
                count * max(by_bytes, by_ops)
            t["bound_ms"] += count * max(by_bytes, by_ops)
            print(f"[time] {case.tag} {name} {label} bf16: kernel "
                  f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"({k_ms and p_ms / k_ms:.2f}x), library "
                  + ("none" if l_ms is None else f"{l_ms * 1e3:.1f} us")
                  + f"; bound {max(by_bytes, by_ops) * 1e3:.2f} us (bytes "
                  f"{by_bytes * 1e3:.2f}, operations {by_ops * 1e3:.2f}) "
                  f"[{self.gpu}]")
            del args, lib
        per = (f"batch-{TRAIN_BATCH} train step" if backward
               else f"batch-{BATCH} forward")
        for name, t in totals.items():
            lib = t["library_ms"]
            by = "bytes" if t["bytes"] >= t["ops"] else "operations"
            print(f"[time] {case.tag} {name} per {per}: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                  + ("none" if lib is None else f"{lib:.4f} ms")
                  + f", bound {t['bound_ms']:.4f} ms ({by}) [{self.gpu}]")
            if TIMED_ON.get(name.removesuffix("_bwd"), TIN.tag) == case.tag:
                self.ms[name] = dict(t, per=f"{case.tag} {per}", bound_by=by)

    # -- serving ----------------------------------------------------------
    def serve(self, case: ModelCase):
        import numpy as np
        import torch

        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.ops.augment import normalize_batch
        from outgridvit_tpu_torch.serving import build_predictor

        img, classes = case.img, case.model["num_classes"]
        pred = build_predictor(case.model, batch_size=BATCH, img_size=img,
                               mean=case.mean, std=case.std, device=self.dev,
                               seed=SEED, dwconv=case.dwconv,
                               attn_nhwc=case.attn_nhwc)
        n_params = sum(p.numel() for p in pred.model.parameters())
        print(f"[predictor] {case.tag} ({case.config}) params={n_params} "
              f"batch={BATCH} img={img} dtype={pred.model.dtype}")
        require(n_params == case.params, f"param count {n_params}")

        rng = np.random.default_rng(SEED)
        images = rng.integers(0, 256, (200, img, img, 3), dtype=np.uint8)
        requests = [("full batch", images[:BATCH]), ("ragged 3", images[:3]),
                    ("200 images", images)]
        plan, variants = launch_plan(case, stage_shapes(case))
        print(f"[serve] {case.tag} launch plan per forward {plan}, by "
              f"variant {variants}")
        results = {}
        self.reset_counts()
        for label, req in requests:
            before = self.read_counts()[0]
            labels, probs = pred.predict_many(req)
            forwards = -(-len(req) // BATCH)
            counts = self.read_counts()[0]
            delta = {k: counts[k] - before[k] for k in plan}
            print(f"[serve] {case.tag} {label}: labels {labels.shape} probs "
                  f"{probs.shape} forwards={forwards} launches={delta}")
            require(labels.shape == (len(req),) and labels.dtype == np.int32,
                    f"{label}: labels {labels.shape} {labels.dtype}")
            require(probs.shape == (len(req), classes),
                    f"{label}: probs shape")
            require(np.isfinite(probs).all(), f"{label}: non-finite probs")
            require(np.allclose(probs.sum(-1), 1.0, atol=1e-4),
                    f"{label}: probs do not sum to 1")
            require((labels == probs.argmax(-1)).all(), f"{label}: argmax")
            require(delta == {k: v * forwards for k, v in plan.items()},
                    f"{label}: launches {delta}, expected {plan} x "
                    f"{forwards}")
            results[label] = (labels, probs)
        counts, by_variant = self.read_counts()
        total = sum(-(-len(r) // BATCH) for _, r in requests)
        require({k: by_variant[k] for k in variants}
                == {k: {v: c * total for v, c in vs.items()}
                    for k, vs in variants.items()},
                f"launches by variant {by_variant}, expected {variants} x "
                f"{total}")
        self.require_entries(f"{case.tag} serve", plan, variants, total)
        self.record(f"{case.tag} serve", counts, by_variant)
        full_l, full_p = results["full batch"]
        rag_l, rag_p = results["ragged 3"]
        require((rag_l == full_l[:3]).all()
                and np.allclose(rag_p, full_p[:3], atol=1e-3),
                "ragged request disagrees with the same rows of a full batch")
        require((results["200 images"][0][:BATCH] == full_l).all(),
                "predict_many disagrees with predict")

        # kernel path vs plain path, same weights and inputs
        state = pred.model.state_dict()

        def model(dtype, use_kernels):
            m = build_model(case.model, dtype=dtype, use_kernels=use_kernels,
                            device=self.dev, dwconv=case.dwconv,
                            attn_nhwc=case.attn_nhwc)
            m.load_state_dict(state)
            return m

        plainbf = model(torch.bfloat16, False)
        x = normalize_batch(torch.from_numpy(images[:BATCH]).to(self.dev),
                            pred.mean, pred.std)
        with torch.inference_mode():
            ref = model(torch.float32, False)(x)
            outs = {"fp32 kernel path": (model(torch.float32, True)(x),
                                         "float32"),
                    "bf16 kernel path (served)": (pred.model(x), "bfloat16"),
                    "bf16 plain path": (plainbf(x), "bfloat16")}
        scale = max(1.0, ref.abs().max().item())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        for label, (logits, dt) in outs.items():
            require(torch.isfinite(logits).all().item(),
                    f"{label}: non-finite")
            err = (logits.float() - ref).abs().max().item()
            tol = LOGIT_TOL[dt] * scale
            decided = margin > 2 * tol
            agree = logits.argmax(-1) == ref.argmax(-1)
            print(f"[logits] {case.tag} {label} vs fp32 plain path: "
                  f"max_abs_err={err:.4e} tol={tol:.4e} (max|logit|="
                  f"{scale:.3f}); labels agree {int(agree.sum())}/{BATCH}; "
                  f"on the {int(decided.sum())} rows with top-2 margin > "
                  f"2*tol: {int((agree & decided).sum())}")
            require(err <= tol, f"{label}: logits off by {err}")
            require(bool(agree[decided].all()), f"{label}: labels disagree")
        del outs, ref

        with torch.inference_mode():
            fwd_k = time_ms(pred.model, (x,), iters=20, warmup=3)
            fwd_p = time_ms(plainbf, (x,), iters=20, warmup=3)
        print(f"[time] {case.tag} forward bs{BATCH} bf16: kernel path "
              f"{fwd_k:.3f} ms, plain path {fwd_p:.3f} ms [{self.gpu}]")
        full = images[:BATCH]
        for _ in range(3):
            pred.predict(full)
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict(full)
        secs = time.perf_counter() - t0
        print(f"[time] {case.tag} predictor bs{BATCH} bf16 (uint8 in, "
              f"labels+probs out): {reps * BATCH / secs:.1f} imgs/s, "
              f"{secs / reps * 1e3:.3f} ms/request [{self.gpu}]")

    # -- training ---------------------------------------------------------
    def train(self, case: ModelCase):
        import torch

        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.models.layers import DropPath
        from outgridvit_tpu_torch.ops.augment import AugmentConfig
        from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
        from outgridvit_tpu_torch.training.optim import (
            AdamW,
            warmup_cosine_lr,
        )
        from outgridvit_tpu_torch.training.steps import (
            StepConfig,
            make_train_step,
            sample_step_draws,
        )
        from outgridvit_tpu_torch.training.train_state import TrainState

        T, dev, gen = case.train, self.dev, self.gen
        classes = case.model["num_classes"]
        step_cfg = StepConfig(
            num_classes=classes, label_smoothing=T["label_smoothing"],
            mixup_alpha=T["mixup_alpha"], cutmix_alpha=T["cutmix_alpha"],
            mix_prob=T["mix_prob"], grad_clip_norm=T["grad_clip_norm"],
            augment=AugmentConfig(mean=case.mean, std=case.std,
                                  crop_pad=case.crop_pad))
        bench_lr = warmup_cosine_lr(T["lr"], 10_000, 500, T["min_lr"])
        step = make_train_step(step_cfg, bench_lr)
        images = torch.randint(0, 256, (TRAIN_BATCH, case.img, case.img, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
        labels = torch.randint(0, classes, (TRAIN_BATCH,),
                               generator=gen).to(dev)

        def new_state(dtype, use_kernels, lr=bench_lr):
            model = build_model(case.model, dtype=dtype,
                                use_kernels=use_kernels, device=dev,
                                seed=SEED, dwconv=case.dwconv,
                                attn_nhwc=case.attn_nhwc)
            return TrainState.create(model, AdamW(
                lr, T["weight_decay"], T["grad_clip_norm"]))

        def fixed_draws(model):
            draws = sample_step_draws(gen, step_cfg, tuple(images.shape), dev)
            return draws._replace(drop_masks=DropPathMasks({
                m.path: torch.rand(TRAIN_BATCH, generator=gen) < 1.0 - m.rate
                for m in model.modules() if isinstance(m, DropPath)
                and m.rate > 0}))

        # one train step, kernel path vs plain path
        runs = {}
        draws = None
        mlp_steps = launch_plan(case, stage_shapes(case, TRAIN_BATCH))[0][
            "mlp_branch"]  # as many forwards as backwards a step
        attn_steps = {**launch_plan(case, stage_shapes(case, TRAIN_BATCH))[0],
                      **launch_plan(case, stage_shapes(case, TRAIN_BATCH),
                                    backward=True)[0]}
        for label, dtype, kern in (("fp32 kernel", torch.float32, True),
                                   ("fp32 plain", torch.float32, False),
                                   ("bf16 kernel", torch.bfloat16, True)):
            state = new_state(dtype, kern)
            draws = draws or fixed_draws(state.model)
            self.reset_counts()
            state, m = step(state, (images, labels), draws)
            torch.cuda.synchronize()
            if label == "fp32 kernel":  # the fp32 kernels: the FMA ones
                got = self.read_entries()
                for name, (_, fma) in MLP_ENTRIES.items():
                    require(got[name] == {fma: mlp_steps},
                            f"{case.tag} fp32 step: {name} launches by "
                            f"entry point {got[name]}, expected {mlp_steps} "
                            f"of {fma}")
                for name, (_, fma) in (*ATTN_FWD_ENTRIES.items(),
                                       *ATTN_BWD_ENTRIES.items(),
                                       *GRID_ENTRIES.items(),
                                       *OUTLOOK_FWD_ENTRIES.items(),
                                       *OUTLOOK_BWD_ENTRIES.items(),
                                       *SOFTMAX_ENTRIES.items()):
                    want = ({fma: attn_steps[name]} if attn_steps[name]
                            else {})
                    require(got[name] == want,
                            f"{case.tag} fp32 step: {name} launches by "
                            f"entry point {got[name]}, expected {want}")
            runs[label] = (state, {k: v.item() for k, v in m.items()})
            print(f"[train-step] {case.tag} {label}: " + " ".join(
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
                       for kb, pb in zip(ks.model.buffers(),
                                         ps.model.buffers()))
        print(f"[train-step] {case.tag} fp32 kernel vs plain: loss rel err "
              f"{loss_err:.2e} (tol {STEP_LOSS_TOL:g}); max grad err / grad "
              f"norm {grad_err:.2e} (tol {STEP_GRAD_TOL:g}, grad norm "
              f"{gnorm:.4f}); params after the step max abs err "
              f"{param_err:.2e} (tol {STEP_PARAM_TOL:g} x lr {lr0:.3g}); BN "
              f"stats rel err {stat_err:.2e} (tol {STEP_STAT_TOL:g})")
        require(loss_err <= STEP_LOSS_TOL, "train step: loss disagrees")
        require(grad_err <= STEP_GRAD_TOL, "train step: grads disagree")
        require(param_err <= STEP_PARAM_TOL * lr0,
                "train step: params disagree")
        require(stat_err <= STEP_STAT_TOL, "train step: BN stats disagree")
        bf_err = abs(runs["bf16 kernel"][1]["loss"] - pm["loss"]) / pm["loss"]
        print(f"[train-step] {case.tag} bf16 kernel vs fp32 plain: loss rel "
              f"err {bf_err:.2e} (tol {BF16_LOSS_TOL:g})")
        require(bf_err <= BF16_LOSS_TOL, "bf16 train step: loss disagrees")
        del runs, ks, ps

        # the main path: bf16 steps on one batch, launch counts per step
        shapes = stage_shapes(case, TRAIN_BATCH)
        fplan, fvar = launch_plan(case, shapes)
        bplan, bvar = launch_plan(case, shapes, backward=True)
        plan, pvar = {**fplan, **bplan}, {**fvar, **bvar}
        state = new_state(torch.bfloat16, True, warmup_cosine_lr(
            T["lr"], case.loss_steps, 3, T["min_lr"]))
        loss_step = make_train_step(step_cfg, state.tx.learning_rate)
        sampler = torch.Generator(device="cpu").manual_seed(SEED + 2)
        same = fixed_draws(state.model) if case.fixed_draws_loss else None
        losses = []
        for i in range(case.loss_steps):
            self.reset_counts()
            state, m = loss_step(state, (images, labels), same,
                                 generator=sampler)
            counts, by_variant = self.read_counts()
            require({k: counts[k] for k in plan} == plan,
                    f"step {i}: launches {counts}, expected {plan}")
            require({k: by_variant[k] for k in pvar} == pvar,
                    f"step {i}: launches by variant {by_variant}, expected "
                    f"{pvar}")
            self.require_entries(f"{case.tag} step {i}", plan, pvar)
            losses.append(m["loss"].item())
            require(m["nonfinite"].item() == 0.0
                    and math.isfinite(losses[-1]),
                    f"step {i}: non-finite loss")
        self.record(f"{case.tag} train step", counts, by_variant)
        k = min(5, case.loss_steps // 2)
        first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
        print(f"[train] {case.tag} launches per step {counts}, by variant "
              f"{by_variant} (every one of {case.loss_steps} steps)")
        print(f"[train] {case.tag} {case.loss_steps} bf16 kernel-path steps "
              f"on one batch of {TRAIN_BATCH}"
              + (" with one step's draws" if same else "") + ": losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; mean of first {k} {first:.4f}, of last {k} {last:.4f}")
        require(last < first, f"the loss did not fall over "
                f"{case.loss_steps} steps")

        if case is FLAGSHIP:
            self.nonfinite_guard(step_cfg, state, images, labels, sampler)

        # timings
        draws = fixed_draws(state.model)
        for label, st in (("kernel path", state),
                          ("plain path", new_state(torch.bfloat16, False))):
            def one(st=st):
                step(st, (images, labels), draws)
            ms = time_ms(one, (), iters=6, warmup=2)
            print(f"[time] {case.tag} train step bs{TRAIN_BATCH} bf16 "
                  f"{label} (uint8 in, augment + mix + fwd + bwd + AdamW; "
                  f"draws sampled beforehand): {ms:.3f} ms/step, "
                  f"{TRAIN_BATCH / ms * 1e3:.1f} imgs/s [{self.gpu}]")

    def nonfinite_guard(self, step_cfg, state, images, labels, sampler):
        import torch

        from outgridvit_tpu_torch.training.steps import make_train_step

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
        same = all(all(torch.equal(a, b) for a, b in zip(x, y))
                   for x, y in zip(before[:3], after[:3])) and \
            torch.equal(before[3], after[3])
        print(f"[guard] NaN batch: nonfinite={m['nonfinite'].item():g} "
              f"loss={m['loss'].item():g} grad_norm="
              f"{m['grad_norm'].item():g}; params, BN stats, AdamW mu/nu/"
              f"count bitwise unchanged: {same}; state.step {state.step}")
        require(m["nonfinite"].item() == 1.0 and m["loss"].item() == 0.0,
                "guard: NaN loss not reported")
        require(same, "guard: the state changed on a non-finite step")

    # -- phase loop: the training entry point ----------------------------
    def loop(self):
        """The port's CLI (``outgridvit_tpu_torch/train.py:main``) on the
        7M config at full width, bf16, batch 128, on a CIFAR-100 pickle
        fixture of random images (``LOOP_TRAIN`` / ``LOOP_TEST``, 100
        classes): 2 epochs at K = ``LOOP_K``, then a resume for a third.
        With the config's val_split 0.1 an epoch has 70 full train batches
        and a ragged tail and 7 full val batches and a ragged tail, so full
        K-groups, single batches and ragged tails all occur in train and in
        eval; each full K-group trains through the train superstep's CUDA
        graph (it must replay). Then the K = ``LOOP_K`` eval superstep's
        graph is held bitwise to ``LOOP_K`` eager eval steps before and
        after one train step, and the two are timed in turns; then the
        train graph against eager train steps (:meth:`train_graph`)."""
        import contextlib
        import re
        import tempfile
        from pathlib import Path

        import torch

        from outgridvit_tpu_torch import train as cli
        from outgridvit_tpu_torch.training.steps import (
            EvalSuperstep,
            TrainSuperstep,
        )

        t_phase = time.perf_counter()
        # the fixture and checkpoints stay for phases evaluate and analyze,
        # which removes them
        self.loop_dir = tempfile.TemporaryDirectory()
        tmp = Path(self.loop_dir.name)
        write_cifar_fixture(tmp / "data", LOOP_TRAIN, LOOP_TEST,
                            FLAGSHIP_MODEL_CFG["num_classes"], SEED)
        out = tmp / "out"
        common = ["--config", FLAGSHIP.config, "--data-dir",
                  str(tmp / "data"), "--batch-size", str(TRAIN_BATCH),
                  "--steps-per-dispatch", str(LOOP_K),
                  "--output-dir", str(out)]
        self.reset_counts()
        EvalSuperstep.replays = TrainSuperstep.replays = 0
        runs = []
        for args in (["--epochs", "2"],
                     ["--epochs", "3", "--resume",
                      str(out / "last_cifar100_model_a_7m.pt")]):
            tee = StampedLines(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = cli.main(common + args)
            require(rc == 0, f"loop: train CLI {args} returned {rc}")
            runs.append(tee.lines)
        counts, variants = self.read_counts()
        replays = EvalSuperstep.replays
        train_replays = TrainSuperstep.replays
        ckpts = [out / "last_cifar100_model_a_7m.pt",
                 out / "best_cifar100_model_a_7m.pt"]
        require(all(p.exists() for p in ckpts),
                f"loop: checkpoints missing in {sorted(out.iterdir())}")
        self.loop_ckpt = ckpts[1]
        self.record("loop", counts, variants)
        bad = {n: e for n, e in self.read_entries().items()
               if n in ("grid_mhsa", "grid_mhsa_bwd", "mlp_branch",
                        "mlp_branch_bwd")
               and set(e) - {"ogvt_grid_mhsa_th", "ogvt_grid_mhsa_th_bwd",
                             "ogvt_mlp_branch_mma",
                             "ogvt_mlp_branch_bwd_mma"}}
        require(not bad, f"loop: bf16 launches off the tensor-core entry "
                f"points: {bad}")
        for name in ("grid_mhsa", "grid_mhsa_bwd", "mlp_branch",
                     "mlp_branch_bwd"):
            require(counts[name] > 0, f"loop: {name} never launched")
        require(replays > 0, "loop: the eval graph never replayed")
        require(train_replays > 0, "loop: the train graph never replayed")

        text = ["\n".join(line for _, line in r) for r in runs]
        for i, t in enumerate(text):
            for tag in ("Train", "Val"):
                losses = re.findall(rf"\[{tag}\]\s+loss (\S+) \|", t)
                require(losses and all(math.isfinite(float(v))
                                       for v in losses),
                        f"loop: run {i + 1}: [{tag}] losses {losses}")
        require(re.search(r"Resumed from .*last_cifar100_model_a_7m\.pt at "
                          r"epoch 2\b", text[1]) is not None,
                "loop: the resume did not start at epoch 2")
        require("=== Epoch 1/3 ===" not in text[1]
                and "=== Epoch 3/3 ===" in text[1],
                "loop: the resumed run did not run epoch 3 alone")
        # per epoch: img/s of its last [train step] line, seconds between
        # its "=== Epoch" line and its "Epoch time" line
        epochs = []
        for r in runs:
            start = None
            for t, line in r:
                if line.startswith("=== Epoch "):
                    start, ips = t, None
                m = re.match(r"\[train step \d+/\d+\] .* ([\d.]+) img/s",
                             line)
                if m:
                    ips = float(m.group(1))
                if line.startswith("Epoch time:"):
                    epochs.append((ips, t - start))
        require(len(epochs) == 3, f"loop: {len(epochs)} epochs timed")
        for e, (ips, sec) in enumerate(epochs, 1):
            print(f"[loop] epoch {e}: {ips:.1f} img/s ([train step] line), "
                  f"{sec:.3f} s (train + val + checkpoint); {self.gpu}")
        print(f"[loop] launches in the 3 epochs (a graph's counted once, at "
              f"its capture): "
              f"{ {n: counts[n] for n in ('grid_mhsa', 'grid_mhsa_bwd', 'mlp_branch', 'mlp_branch_bwd')} }; "
              f"train graph replays {train_replays}, eval graph replays "
              f"{replays}")
        self.loop_epochs = epochs
        self.eval_graph()
        self.train_graph()
        # a graph's launches are counted at its capture; each replay runs
        # them again: K steps' (train) or K forwards' (eval) launches
        per_step, captured = self.train_graph_launches
        ran = {n: counts[n] + train_replays * c
               + (0 if n.endswith("_bwd") else replays * LOOP_K * per_step[n])
               for n, c in captured.items()}
        print(f"[loop] launches run in the 3 epochs: counted + train graph "
              f"replays {train_replays} x captured {captured} + eval graph "
              f"replays {replays} x {LOOP_K} forwards = {ran}")
        print(f"[loop] phase done in {time.perf_counter() - t_phase:.1f} s")

    def train_graph(self):
        """The 7M train superstep at K = ``LOOP_K`` (full width, bf16, batch
        128, uint8 in, the yaml's recipe: device augmentation, mixup /
        cutmix, drop-path) against ``LOOP_K`` eager train steps from the
        same state on the same batches and seed: parameters, BN
        statistics, AdamW mu, nu and count, the device step and every
        metric bitwise. The eager steps run twice first: if they differ
        from each other, the graph may differ from the first by no more
        than they do. Then both timed in turns, training on (CUDA events
        around each K-group, the host's draws and launches included)."""
        import dataclasses

        import numpy as np
        import torch

        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.ops.augment import AugmentConfig
        from outgridvit_tpu_torch.training.optim import (
            AdamW,
            warmup_cosine_lr,
        )
        from outgridvit_tpu_torch.training.steps import (
            StepConfig,
            TrainSuperstep,
            make_train_step,
            make_train_superstep,
        )
        from outgridvit_tpu_torch.training.train_state import TrainState

        T, dev, gen = FLAGSHIP.train, self.dev, self.gen
        model = build_model(FLAGSHIP_MODEL_CFG, dtype=torch.bfloat16,
                            device=dev, seed=SEED)
        sched = warmup_cosine_lr(T["lr"], 10_000, 500, T["min_lr"])
        state = TrainState.create(model, AdamW(sched, T["weight_decay"],
                                               T["grad_clip_norm"]))
        cfg = StepConfig(
            num_classes=FLAGSHIP_MODEL_CFG["num_classes"],
            label_smoothing=T["label_smoothing"],
            mixup_alpha=T["mixup_alpha"], cutmix_alpha=T["cutmix_alpha"],
            mix_prob=T["mix_prob"], grad_clip_norm=T["grad_clip_norm"],
            augment=AugmentConfig(mean=FLAGSHIP.mean, std=FLAGSHIP.std,
                                  crop_pad=FLAGSHIP.crop_pad))
        step = make_train_step(cfg, sched)
        superstep = make_train_superstep(cfg, sched, k=LOOP_K)
        x = torch.randint(0, 256, (LOOP_K, TRAIN_BATCH, 32, 32, 3),
                          dtype=torch.uint8, generator=gen).to(dev)
        y = torch.randint(0, FLAGSHIP_MODEL_CFG["num_classes"],
                          (LOOP_K, TRAIN_BATCH), generator=gen).to(
                              dev, torch.int32)

        def tensors(st):
            named = {f"model.{k}": v for k, v in
                     st.model.state_dict().items()}
            for part in ("mu", "nu"):
                named.update((f"{part}.{k}", v) for k, v in
                             getattr(st.opt_state, part).items())
            named["count"] = st.opt_state.count
            named["device_step"] = st.device_step
            return named

        start = {k: v.detach().clone() for k, v in tensors(state).items()}

        def from_start():
            with torch.no_grad():
                for k, v in tensors(state).items():
                    v.copy_(start[k])
            return dataclasses.replace(state, step=0)

        def eager_k(st):
            ms = []
            for i in range(LOOP_K):
                st, m = step(st, (x[i], y[i]), seed=SEED)
                ms.append(m)
            return st, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

        def result(st, metrics):
            out = {k: v.detach().clone() for k, v in tensors(st).items()}
            out.update((f"metric.{k}", v.clone()) for k, v in metrics.items())
            out["host_step"] = torch.tensor(st.step)
            return out

        names = ("grid_mhsa", "grid_mhsa_bwd", "mlp_branch",
                 "mlp_branch_bwd")
        self.reset_counts()
        runs = [result(*eager_k(from_start()))]
        per_step = {n: c // LOOP_K for n, c in self.read_counts()[0].items()
                    if n in names}
        runs.append(result(*eager_k(from_start())))
        self.reset_counts()
        replays = TrainSuperstep.replays
        runs.append(result(*superstep(from_start(), (x, y), seed=SEED)))
        require(TrainSuperstep.replays == replays + 1,
                "train graph: no replay")
        # the first call: one warm-up step, then the K steps captured
        captured = {n: c - per_step[n] for n, c in
                    self.read_counts()[0].items() if n in names}
        require(all(captured[n] == LOOP_K * per_step[n] > 0 for n in names),
                f"train graph: captured {captured}, a step {per_step}")
        self.train_graph_launches = (per_step, captured)
        print(f"[train_graph] launches a step {per_step}; captured in the "
              f"K={LOOP_K} graph {captured}, run again at each replay")
        e1, e2, g = runs

        def differ(a, b):
            return {k: float((a[k].double() - b[k].double()).abs().max())
                    for k in a if not torch.equal(a[k], b[k])}

        eager_diff, graph_diff = differ(e2, e1), differ(g, e1)
        print(f"[train_graph] K={LOOP_K} 7M steps from one state: loss "
              f"{g['metric.loss'].tolist()} lr {g['metric.lr'].tolist()}; "
              f"{len(g)} tensors compared; eager vs eager: "
              f"{len(eager_diff)} differ; graph vs eager: "
              f"{len(graph_diff)} differ")
        if eager_diff:
            print(f"[train_graph] the eager steps differ from each other "
                  f"in: {sorted(eager_diff.items())[:20]}")
            require(all(v <= eager_diff.get(k, 0.0)
                        for k, v in graph_diff.items()),
                    f"train graph: beyond the eager-vs-eager difference: "
                    f"{sorted(graph_diff.items())[:20]}")
        else:
            require(not graph_diff, f"train graph: not bitwise the eager "
                    f"steps: {sorted(graph_diff.items())[:20]}")

        def timed(fn):
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start_ev.record()
            fn()
            end_ev.record()
            torch.cuda.synchronize()
            return start_ev.elapsed_time(end_ev)

        st = from_start()

        def run_graph():
            nonlocal st
            st, _ = superstep(st, (x, y), seed=SEED)

        def run_eager():
            nonlocal st
            st, _ = eager_k(st)

        graph_ms, eager_ms = [], []
        for _ in range(LOOP_TIMED):
            graph_ms.append(timed(run_graph) / LOOP_K)
            eager_ms.append(timed(run_eager) / LOOP_K)
        self.train_graph_ms = (float(np.median(graph_ms)),
                               float(np.median(eager_ms)))
        ips = [TRAIN_BATCH * 1e3 / t for t in self.train_graph_ms]
        print(f"[train_graph] a batch-{TRAIN_BATCH} train step, K={LOOP_K} "
              f"groups, median of {LOOP_TIMED} in turns: graph "
              f"{self.train_graph_ms[0]:.4f} ms ({ips[0]:.1f} img/s) vs "
              f"eager {self.train_graph_ms[1]:.4f} ms ({ips[1]:.1f} img/s); "
              f"{self.gpu}")

    def eval_graph(self):
        """The 7M eval superstep at K = ``LOOP_K`` (bf16, batch 128, uint8
        in) against ``LOOP_K`` eager eval steps on the same batches,
        bitwise, before and after one train step (the graph reads the
        parameters the step updates in place); then both timed in turns
        (CUDA events around each K-group, the host's launch time
        included)."""
        import numpy as np
        import torch

        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.ops.augment import AugmentConfig
        from outgridvit_tpu_torch.training.optim import (
            AdamW,
            warmup_cosine_lr,
        )
        from outgridvit_tpu_torch.training.steps import (
            EvalSuperstep,
            StepConfig,
            make_eval_step,
            make_eval_superstep,
            make_train_step,
        )
        from outgridvit_tpu_torch.training.train_state import TrainState

        T, dev, gen = FLAGSHIP.train, self.dev, self.gen
        norm = (FLAGSHIP.mean, FLAGSHIP.std)
        model = build_model(FLAGSHIP_MODEL_CFG, dtype=torch.bfloat16,
                            device=dev, seed=SEED)
        sched = warmup_cosine_lr(T["lr"], 10_000, 500, T["min_lr"])
        state = TrainState.create(model, AdamW(sched, T["weight_decay"],
                                               T["grad_clip_norm"]))
        superstep = make_eval_superstep(model, normalize=norm, k=LOOP_K)
        eager = make_eval_step(model, normalize=norm)
        x = torch.randint(0, 256, (LOOP_K, TRAIN_BATCH, 32, 32, 3),
                          dtype=torch.uint8, generator=gen).to(dev)
        y = torch.randint(0, FLAGSHIP_MODEL_CFG["num_classes"],
                          (LOOP_K, TRAIN_BATCH), generator=gen).to(
                              dev, torch.int32)

        def eager_k():
            ms = [eager((x[i], y[i])) for i in range(LOOP_K)]
            return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

        def compare(when):
            replays = EvalSuperstep.replays
            got, want = superstep((x, y)), eager_k()
            require(EvalSuperstep.replays == replays + 1,
                    "eval graph: no replay")
            same = all(torch.equal(got[k], want[k]) for k in want)
            print(f"[eval_graph] K={LOOP_K} {when}: loss "
                  f"{got['loss'].tolist()} top1 {got['top1'].tolist()}; "
                  f"bitwise the eager steps: {same}")
            require(same, f"eval graph {when}: {got} vs eager {want}")
            return got

        before = compare("before a train step")
        step = make_train_step(StepConfig(
            num_classes=FLAGSHIP_MODEL_CFG["num_classes"],
            label_smoothing=T["label_smoothing"],
            mixup_alpha=T["mixup_alpha"], cutmix_alpha=T["cutmix_alpha"],
            mix_prob=T["mix_prob"], grad_clip_norm=T["grad_clip_norm"],
            augment=AugmentConfig(mean=FLAGSHIP.mean, std=FLAGSHIP.std,
                                  crop_pad=FLAGSHIP.crop_pad)), sched)
        state, _ = step(state, (x[0], y[0]), seed=SEED)
        after = compare("after one train step")
        require(not torch.equal(before["loss"], after["loss"]),
                "eval graph: the metrics did not follow the train step")

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        graph_ms, eager_ms = [], []
        for _ in range(LOOP_TIMED):
            graph_ms.append(timed(lambda: superstep((x, y))))
            eager_ms.append(timed(eager_k))
        self.eval_graph_ms = (float(np.median(graph_ms)),
                              float(np.median(eager_ms)))
        print(f"[eval_graph] per K={LOOP_K} group of batch-{TRAIN_BATCH} "
              f"eval steps, median of {LOOP_TIMED} in turns: graph "
              f"{self.eval_graph_ms[0]:.4f} ms vs eager "
              f"{self.eval_graph_ms[1]:.4f} ms")

    # -- phase evaluate: the eval and export entry points -----------------
    def evaluate(self):
        """The port's eval benchmark, robustness sweep and export CLIs on
        the 7M checkpoint that phase ``loop`` wrote (its best), at full
        width, bf16:

        (a) ``benchmark_eval.main`` on the fixture's test split (10,000
            images), batch 128, K = ``EVAL_K``: the metric dict's keys,
            finite metrics, the parameter count, eval graph replays, and
            #1 / #2's launches on their tensor-core entry points;
        (b) ``eval_robustness.main`` on a CIFAR-100-C fixture of random
            images it writes (``SWEEP``, severities 1-5): 10 rows, a finite
            summary, one eval graph capture for the sweep, seconds per
            setting;
        (c) ``export_model.main --selfcheck`` at batch 64, then
            ``load_predictor`` here: labels equal to the live predictor's,
            probabilities within 1e-6, one loaded forward's launches those
            of one live forward (7 and 14 of #1 and #2), export seconds and
            MB, live vs loaded imgs/s in turns;
        (d) ``MODEL_B_O`` (random weights) exported whole and held to its
            live predictor the same way;
        (e) each ``ogvt::`` op exported alone at one stage shape of a case
            that reaches it, loaded, and held bitwise to a direct launch
            (:meth:`export_ops`)."""
        import contextlib
        import re
        from pathlib import Path

        import numpy as np
        import torch

        from outgridvit_tpu_torch import benchmark_eval, eval_robustness
        from outgridvit_tpu_torch import export_model
        from outgridvit_tpu_torch.serving import (
            build_predictor,
            load_predictor,
        )
        from outgridvit_tpu_torch.training.steps import EvalSuperstep

        t_phase = time.perf_counter()
        tmp = Path(self.loop_dir.name)
        ckpt = str(self.loop_ckpt)
        # the 7M config with the fixture's data directory
        cfg = tmp / "cifar100_model_a_7m.yaml"
        text = Path(FLAGSHIP.config).read_text()
        require("  data_dir: ./data/cifar100\n" in text,
                f"evaluate: {FLAGSHIP.config} has no data_dir line to point "
                "at the fixture")
        cfg.write_text(text.replace("  data_dir: ./data/cifar100\n",
                                    f"  data_dir: {tmp / 'data'}\n"))

        # (a) the eval benchmark
        out = tmp / "bench.json"
        self.reset_counts()
        replays = EvalSuperstep.replays
        torch.cuda.reset_peak_memory_stats(self.dev)
        rc = benchmark_eval.main([
            "--config", str(cfg), "--checkpoint", ckpt, "--split", "test",
            "--batch-size", str(TRAIN_BATCH), "--eval-k", str(EVAL_K),
            "--json-out", str(out)])
        require(rc == 0, f"evaluate: benchmark_eval returned {rc}")
        m = json.loads(out.read_text())
        counts, variants = self.read_counts()
        entries = self.read_entries()
        self.record("evaluate benchmark", counts, variants)
        require(tuple(m) == BENCH_KEYS, f"evaluate: metric keys {list(m)}")
        require(all(math.isfinite(m[k]) for k in ("loss", "top1", "top3",
                                                  "top5")),
                f"evaluate: metrics {m}")
        require(m["params"] == FLAGSHIP_PARAMS, f"params {m['params']}")
        require(m["num_images"] == LOOP_TEST, f"images {m['num_images']}")
        require(EvalSuperstep.replays > replays,
                "evaluate: the eval graph never replayed")
        self.require_forward_entries("evaluate benchmark", counts, entries)
        print(f"[evaluate] benchmark_eval a7m best checkpoint, test split "
              f"{m['num_images']} images, batch {TRAIN_BATCH}, K={EVAL_K}: "
              f"loss {m['loss']:.4f} top1 {m['top1']:.2f}% | "
              f"{m['imgs_per_sec']:.1f} imgs/s | {m['ms_per_batch']:.3f} "
              f"ms/batch | epoch {m['epoch_seconds']:.3f} s | peak "
              f"{m['mem_peak_gib']:.3f} GiB | eval graph replays "
              f"{EvalSuperstep.replays - replays} | flops/fwd "
              f"{m['flops_fwd']}; {self.gpu}")
        self.eval_bench = m

        # (b) the CIFAR-100-C sweep
        cdir = tmp / "CIFAR-100-C"
        cdir.mkdir()
        rng = np.random.default_rng(SEED)
        np.save(cdir / "labels.npy",
                np.arange(SWEEP_ROWS, dtype=np.int64)
                % FLAGSHIP_MODEL_CFG["num_classes"])
        for name in SWEEP:
            np.save(cdir / f"{name}.npy",
                    rng.integers(0, 256, (SWEEP_ROWS, 32, 32, 3),
                                 dtype=np.uint8))
        out = tmp / "robustness.json"
        self.reset_counts()
        captures = EvalSuperstep.captures
        tee = StampedLines(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = eval_robustness.main([
                "--config", str(cfg), "--checkpoint", ckpt,
                "--suite", "cifar100c", "--data-dir", str(tmp),
                "--corruptions", *SWEEP, "--json-out", str(out)])
        require(rc == 0, f"evaluate: eval_robustness returned {rc}")
        counts, variants = self.read_counts()
        self.record("evaluate robustness", counts, variants)
        res = json.loads(out.read_text())
        rows, summary = res["rows"], res["summary"]
        require(len(rows) == 2 * 5 and summary["n_settings"] == 10,
                f"evaluate: {len(rows)} rows")
        require(all(math.isfinite(r[k]) for r in rows
                    for k in ("loss", "top1", "top3", "top5")),
                f"evaluate: rows {rows}")
        require(math.isfinite(summary["overall_top1"])
                and math.isfinite(summary["overall_top5"])
                and all(math.isfinite(v)
                        for v in summary["by_severity"].values()),
                f"evaluate: summary {summary}")
        require(EvalSuperstep.captures == captures + 1,
                f"evaluate: {EvalSuperstep.captures - captures} eval graph "
                "captures in the sweep, expected 1")
        ends = [t for t, line in tee.lines if line.startswith("[C100-C] ")]
        require(len(ends) == 10, f"evaluate: {len(ends)} settings printed")
        secs = np.diff([t0] + ends)
        print(f"[evaluate] eval_robustness a7m CIFAR-100-C {list(SWEEP)} x "
              f"severities 1-5 ({10 * 10_000} images, batch 256, K=8): "
              f"overall top1 {summary['overall_top1']:.2f}%; seconds per "
              f"setting {[round(float(s), 3) for s in secs]} (first incl. "
              f"the capture), median {float(np.median(secs)):.3f} s; "
              f"{self.gpu}")
        self.eval_sweep_s = [float(s) for s in secs]

        # (c) the 7M export
        art = tmp / "a7m.ogvt"
        tee = StampedLines(sys.stdout)
        with contextlib.redirect_stdout(tee):
            rc = export_model.main([
                "--config", str(cfg), "--checkpoint", ckpt, "--batch-size",
                str(BATCH), "--out", str(art), "--selfcheck"])
        require(rc == 0, f"evaluate: export_model returned {rc}")
        text = "\n".join(line for _, line in tee.lines)
        found = re.search(r"Exported .* \(([\d.]+) MB, .*kernels (on|off)\) "
                          r"in ([\d.]+) s", text)
        require(found is not None and "selfcheck OK" in text,
                f"evaluate: export_model printed {text!r}")
        require(found.group(2) == "on", "evaluate: the 7M artifact was "
                "exported without the kernels")
        live = build_predictor(FLAGSHIP.model, checkpoint=ckpt,
                               batch_size=BATCH, img_size=FLAGSHIP.img,
                               mean=FLAGSHIP.mean, std=FLAGSHIP.std,
                               device=self.dev)
        self.hold_export(FLAGSHIP, live, load_predictor(str(art)),
                         f"{found.group(1)} MB, exported in "
                         f"{found.group(3)} s")

        # (d) Model B with the fused outlook softmax and depthwise kernels
        from outgridvit_tpu_torch.serving import export_predictor

        live = build_predictor(MODEL_B_O.model, batch_size=BATCH,
                               img_size=MODEL_B_O.img, mean=MODEL_B_O.mean,
                               std=MODEL_B_O.std, device=self.dev, seed=SEED,
                               dwconv=MODEL_B_O.dwconv)
        art = tmp / "model_b_o.ogvt"
        t0 = time.perf_counter()
        export_predictor(live, str(art))
        sec = time.perf_counter() - t0
        self.hold_export(MODEL_B_O, live, load_predictor(str(art)),
                         f"{art.stat().st_size / 1e6:.1f} MB, exported in "
                         f"{sec:.2f} s")

        # (e) every op alone
        self.export_ops()
        print(f"[evaluate] phase done in {time.perf_counter() - t_phase:.1f}"
              " s")

    def analyze(self):
        """The attention-analysis and ablation entry points and per-block
        rematerialization (phase ``analyze``, after ``evaluate``):

        (a) ``run_attention_analysis.main`` on the 7M config with the
            loop's best checkpoint over the fixture's test split,
            ``--skip-plots --entropy --block all`` (fp32 on the XLA-only
            path, as the JAX script builds it: no kernel launches): one
            row per stage, finite MAD and entropy, grid MAD at most
            ``(Hf-1)+(Wf-1)``, outlook MAD at most 2, normalized entropy in
            [0, 1], the JSON and CSV written;
        (b) ``capture_attention`` on the 7M kernel-path model and on
            ``MODEL_B`` (``fused_agg``), bf16, batch 64: #2 (and #7 for
            Model B) launched during the capture, no grid core, fused
            branch or fused softmax (#1 / #3 / #6 / #5 / #12 / #9); against
            the same weights' plain-path capture on the card: the first
            outlooker's logits bitwise, every block's logits within
            ``CAPTURE_TOL`` x max(1, max|plain|) and its probabilities
            within ``CAPTURE_TOL`` (bf16 roundings compound block by
            block), every grid_attn row summing to 1 within 1e-5, and the
            MAD / entropy rows of both (8 of the images) within
            ``ROWS_TOL``;
        (c) ``run_ablations.main`` on the 7M config (batch 128), 1 epoch of
            a fixture of ``ABL_TRAIN`` / ``ABL_TEST`` images, one call an
            ablation: a finite history, a train graph replay, the grid
            attention's kernels (the grid cores, the fused branch) launched
            unless ``num_heads`` is 0, the MLP branch always (the
            outlooker's half of it gone without the outlooker);
        (d) per-block remat (:meth:`remat`)."""
        import csv
        from pathlib import Path

        import numpy as np
        import torch

        from outgridvit_tpu_torch import run_ablations, run_attention_analysis
        from outgridvit_tpu_torch.experiments import (
            capture_attention,
            compute_grid_and_outlooker_mad_entropy_by_stage,
        )
        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.training.steps import TrainSuperstep
        from outgridvit_tpu_torch.utils.history import load_history

        t_phase = time.perf_counter()
        tmp = Path(self.loop_dir.name)
        cfg = tmp / "cifar100_model_a_7m.yaml"  # phase evaluate's
        require(cfg.exists(), f"analyze: {cfg} missing")

        # (a) the analysis CLI
        out = tmp / "analysis"
        self.reset_counts()
        t0 = time.perf_counter()
        rc = run_attention_analysis.main([
            "--config", str(cfg), "--checkpoint", str(self.loop_ckpt),
            "--split", "test", "--out-dir", str(out), "--skip-plots",
            "--entropy", "--block", "all"])
        sec = time.perf_counter() - t0
        require(rc == 0, f"analyze: run_attention_analysis returned {rc}")
        counts, _ = self.read_counts()
        require(not any(counts.values()),
                f"analyze: the XLA-only analysis model launched {counts}")
        rows = json.loads((out / "mad_metrics.json").read_text())
        with open(out / "mad_metrics.csv", newline="") as f:
            csv_rows = list(csv.DictReader(f))
        stages = FLAGSHIP_MODEL_CFG["stages"]
        require([r["stage"] for r in rows] == list(range(len(stages)))
                and len(csv_rows) == len(rows)
                and list(csv_rows[0]) == list(rows[0]),
                f"analyze: rows {[r['stage'] for r in rows]}, csv "
                f"{len(csv_rows)}")
        for r in rows:
            vals = [r[k] for k in ("MAD_grid_abs_mean", "MAD_outlook_abs_mean",
                                   "H_grid_mean", "Hn_grid_mean",
                                   "H_outlook_mean", "Hn_outlook_mean")]
            require(all(v is not None and math.isfinite(v) for v in vals),
                    f"analyze: stage {r['stage']} row {r}")
            grid_max = (r["grid_Hf"] - 1) + (r["grid_Wf"] - 1)
            require(0.0 <= r["MAD_grid_abs_mean"] <= grid_max
                    and 0.0 <= r["MAD_outlook_abs_mean"] <= 2.0
                    and all(0.0 <= r[k] <= 1.0 + 1e-6
                            for k in ("Hn_grid_mean", "Hn_outlook_mean")),
                    f"analyze: stage {r['stage']} out of bounds: {r}")
            print(f"[analyze] stage {r['stage']}: grid MAD "
                  f"{r['MAD_grid_abs_mean']:.4f} of {grid_max} px, outlook "
                  f"MAD {r['MAD_outlook_abs_mean']:.4f} of 2, Hn grid "
                  f"{r['Hn_grid_mean']:.4f} outlook "
                  f"{r['Hn_outlook_mean']:.4f}")
        print(f"[analyze] run_attention_analysis 7M best checkpoint, test "
              f"split, 8 images, --entropy --block all: {len(rows)} rows, "
              f"JSON + CSV, {sec:.2f} s; {self.gpu}")

        # (b) capture on the kernel path against the plain path
        x = torch.randn((BATCH, 32, 32, 3), generator=self.gen).to(self.dev)
        for case in (FLAGSHIP, MODEL_B):
            want_launched = ("mlp_branch",) + ((case.outlook_kernel,)
                                               if case.outlook_kernel else ())
            caps, models = {}, []
            for label, kern in (("kernel", None), ("plain", False)):
                model = build_model(case.model, dtype=torch.bfloat16,
                                    use_kernels=kern, device=self.dev,
                                    seed=SEED)
                models.append(model)
                self.reset_counts()
                t0 = time.perf_counter()
                caps[label] = capture_attention(model, x)
                sec = time.perf_counter() - t0
                counts, _ = self.read_counts()
                launched = {n: c for n, c in counts.items() if c}
                if label == "plain":
                    require(not launched, f"analyze: {case.tag} plain "
                            f"capture launched {launched}")
                    continue
                require(set(launched) == set(want_launched),
                        f"analyze: {case.tag} capture launched {launched}, "
                        f"expected {want_launched} only")
                print(f"[analyze] {case.tag} capture (bf16, batch {BATCH}) "
                      f"on the kernel path: launches {launched}, "
                      f"{sec:.3f} s")
            got, want = caps["kernel"], caps["plain"]
            require(set(got) == set(want) and len(got) == sum(
                s["depth"] for s in case.model["stages"]) + case.front,
                    f"analyze: {case.tag} capture keys {sorted(got, key=str)}")
            first = ("front", 0) if case.front else (0, 0)
            require(np.array_equal(got[first]["outlook_logits"],
                                   want[first]["outlook_logits"]),
                    f"analyze: {case.tag} {first} logits not bitwise")
            errs, rows_off = {}, 0.0
            for key, slot in want.items():
                for f in ("outlook_logits", "grid_attn"):
                    if slot[f] is None:
                        require(got[key][f] is None,
                                f"analyze: {case.tag} {key} {f}")
                        continue
                    a, b = got[key][f], slot[f]
                    require(a.shape == b.shape and a.dtype == np.float32,
                            f"analyze: {case.tag} {key} {f} {a.shape}")
                    # logits against their block's scale, probabilities
                    # absolutely: bf16 roundings compound block by block
                    d = float(np.abs(a - b).max())
                    bar = CAPTURE_TOL * (max(1.0, float(np.abs(b).max()))
                                         if f == "outlook_logits" else 1.0)
                    errs[f] = max(errs.get(f, 0.0), d / bar)
                    require(d <= bar, f"analyze: {case.tag} {key} {f} off "
                            f"the plain capture by {d} (bar {bar})")
                    if f == "grid_attn":
                        rows_off = max(rows_off, float(np.abs(
                            a.sum(-1, dtype=np.float64) - 1.0).max()))
                for k in ("grid_hw", "g", "meta"):
                    require(got[key][k] == slot[k],
                            f"analyze: {case.tag} {key} {k}")
            require(rows_off <= 1e-5, f"analyze: {case.tag} grid_attn rows "
                    f"sum to 1 within {rows_off}")
            # what the analysis reads from them: MAD / entropy by stage
            stages = ((("front",) if case.front else ())
                      + tuple(range(len(case.model["stages"]))))
            rows = [compute_grid_and_outlooker_mad_entropy_by_stage(
                m, [(x.cpu().numpy(), np.zeros(BATCH))], stages=stages,
                n_images=8) for m in models]
            rows_err = max(abs(a[k] - b[k]) / (1.0 + abs(b[k]))
                           for a, b in zip(*rows) for k in a
                           if isinstance(b[k], float))
            require(len(rows[0]) == len(stages) and rows_err <= ROWS_TOL,
                    f"analyze: {case.tag} MAD / entropy rows of the two "
                    f"captures differ by {rows_err} (bar {ROWS_TOL})")
            print(f"[analyze] {case.tag} capture, kernel vs plain path: "
                  f"{len(got)} blocks, {first} logits bitwise; largest "
                  f"|diff| over its bar (logits {CAPTURE_TOL} x max(1, "
                  f"max|plain|) a block, probabilities {CAPTURE_TOL}) "
                  f"{ {f: round(v, 4) for f, v in errs.items()} }; "
                  f"grid_attn rows sum to 1 within {rows_off:.2e}; "
                  f"{len(rows[0])} MAD / entropy rows within "
                  f"{rows_err:.2e} x (1 + |plain|) (bar {ROWS_TOL})")

        # (c) the ablation CLI, one ablation a call
        abl = tmp / "ablate"
        write_cifar_fixture(abl / "data", ABL_TRAIN, ABL_TEST,
                            FLAGSHIP_MODEL_CFG["num_classes"], SEED)
        text = Path(FLAGSHIP.config).read_text()
        for old in ("  data_dir: ./data/cifar100\n", "  batch_size: 64\n"):
            require(old in text, f"analyze: {FLAGSHIP.config} has no "
                    f"{old.strip()!r} line")
        acfg = abl / "cifar100_model_a_7m.yaml"
        acfg.write_text(text.replace(
            "  data_dir: ./data/cifar100\n",
            f"  data_dir: {abl / 'data'}\n").replace(
            "  batch_size: 64\n", f"  batch_size: {TRAIN_BATCH}\n"))
        fams = {}
        for name, change in run_ablations.ABLATIONS.items():
            self.reset_counts()
            replays = TrainSuperstep.replays
            t0 = time.perf_counter()
            rc = run_ablations.main([
                "--config", str(acfg), "--epochs", "1", "--ablations", name,
                "--output-dir", str(abl / "out"), "--json-out",
                str(abl / f"{name}.json")])
            sec = time.perf_counter() - t0
            require(rc == 0, f"analyze: run_ablations {name} returned {rc}")
            counts, _ = self.read_counts()
            hist = load_history(str(abl / "out" / f"history_{name}.pkl"))
            summary = json.loads((abl / f"{name}.json").read_text())[name]
            losses = hist["train_loss"] + hist["val_loss"]
            require(len(hist["train_loss"]) == 1 and losses
                    and all(math.isfinite(v) for v in losses)
                    and math.isfinite(summary["final_train_top1"]),
                    f"analyze: ablation {name} history {hist}")
            require(TrainSuperstep.replays > replays,
                    f"analyze: ablation {name}: the train graph never "
                    "replayed")
            grid = sum(counts[n] + counts[n + "_bwd"] for n in (
                *GRID_CORES, "attn_branch", "attn_branch_nhwc"))
            mlp = counts["mlp_branch"] + counts["mlp_branch_bwd"]
            require((grid > 0) == (change.get("num_heads") != 0) and mlp > 0,
                    f"analyze: ablation {name} launched grid {grid}, mlp "
                    f"{mlp}: {counts}")
            fams[name] = (grid, mlp)
            print(f"[analyze] run_ablations {name} (1 epoch, "
                  f"{ABL_TRAIN} / {ABL_TEST} images, batch {TRAIN_BATCH}): "
                  f"train loss {hist['train_loss'][0]:.4f} val loss "
                  f"{hist['val_loss'][0]:.4f}, launches grid {grid} mlp "
                  f"{mlp}, train graph replays "
                  f"{TrainSuperstep.replays - replays}, {sec:.2f} s; "
                  f"{self.gpu}")
        # the same steps, graphs and eval batches in every run: without the
        # outlooker a block keeps one of its two MLP branches
        require(fams["no_outlooker"][1] * 2 == fams["full"][1]
                and fams["plain_mbconv"][1] == fams["no_outlooker"][1]
                and fams["no_mbconv"] == fams["full"]
                and fams["no_outlooker"][0] == fams["full"][0],
                f"analyze: ablation launches {fams}")

        # (d) remat
        self.remat()
        self.loop_dir.cleanup()
        print(f"[analyze] phase done in {time.perf_counter() - t_phase:.1f}"
              " s")

    def remat(self):
        """Per-block rematerialization (``model.remat``) at full width,
        bf16, batch 128, the yaml's recipe, for the 7M model and
        Tiny-ImageNet-200: with each policy (``REMAT_POLICIES``), one eager
        train step and two through the K = 2 train superstep's CUDA graph
        against the same steps without remat from the same state, batches
        and seed: parameters, BN statistics, AdamW mu, nu and count, the
        device step and every metric bitwise (if two runs without remat
        differ, no more than they do). Then a step's peak memory above the
        state (``torch.cuda.max_memory_allocated``, eager) and its time,
        eager and in the graph, per policy; ``nothing``'s peak must be
        below the peak without remat."""
        import dataclasses

        import torch

        from outgridvit_tpu_torch.models import build_model
        from outgridvit_tpu_torch.ops.augment import AugmentConfig
        from outgridvit_tpu_torch.training.optim import (
            AdamW,
            warmup_cosine_lr,
        )
        from outgridvit_tpu_torch.training.steps import (
            StepConfig,
            TrainSuperstep,
            make_train_step,
        )
        from outgridvit_tpu_torch.training.train_state import TrainState

        dev, gen = self.dev, self.gen
        self.remat_results = {}
        for case in (FLAGSHIP, TIN):
            T, classes = case.train, case.model["num_classes"]
            cfg = StepConfig(
                num_classes=classes, label_smoothing=T["label_smoothing"],
                mixup_alpha=T["mixup_alpha"], cutmix_alpha=T["cutmix_alpha"],
                mix_prob=T["mix_prob"], grad_clip_norm=T["grad_clip_norm"],
                augment=AugmentConfig(mean=case.mean, std=case.std,
                                      crop_pad=case.crop_pad))
            sched = warmup_cosine_lr(T["lr"], 10_000, 500, T["min_lr"])
            step = make_train_step(cfg, sched)
            x = torch.randint(0, 256, (2, TRAIN_BATCH, case.img, case.img, 3),
                              dtype=torch.uint8, generator=gen).to(dev)
            y = torch.randint(0, classes, (2, TRAIN_BATCH),
                              generator=gen).to(dev, torch.int32)

            def new_state(remat):
                mcfg = dict(case.model) if remat is None else dict(
                    case.model, remat=remat)
                model = build_model(mcfg, dtype=torch.bfloat16, device=dev,
                                    seed=SEED, dwconv=case.dwconv,
                                    attn_nhwc=case.attn_nhwc)
                return TrainState.create(model, AdamW(
                    sched, T["weight_decay"], T["grad_clip_norm"]))

            def result(st, metrics):
                out = {f"model.{k}": v.detach().clone()
                       for k, v in st.model.state_dict().items()}
                for part in ("mu", "nu"):
                    out.update((f"{part}.{k}", v.clone()) for k, v in
                               getattr(st.opt_state, part).items())
                out["count"] = st.opt_state.count.clone()
                out["device_step"] = st.device_step.clone()
                out.update((f"metric.{k}", v.clone())
                           for k, v in metrics.items())
                return out

            def eager(st, n, start=0):
                ms = []
                for i in range(start, start + n):
                    st, m = step(st, (x[i], y[i]), seed=SEED)
                    ms.append(m)
                return st, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

            def differ(a, b):
                return {k: float((a[k].double() - b[k].double()).abs().max())
                        for k in a if not torch.equal(a[k], b[k])}

            def timed_eager(st, reps=2):
                """ms a step and the peak above the state (eager)."""
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                for i in range(reps):
                    st, _ = step(st, (x[i % 2], y[i % 2]), seed=SEED)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / reps
                return ms, torch.cuda.max_memory_allocated(dev) - base

            def timed_graph(st, sup, reps=2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    st, _ = sup(st, (x, y), seed=SEED)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / (2 * reps)

            # the reference: one and two eager steps without remat, twice
            refs = []
            for _ in range(2):
                st, m1 = eager(new_state(None), 1)
                one = result(st, m1)
                st, m2 = eager(st, 1, start=1)
                m12 = {k: torch.cat([m1[k], m2[k]]) for k in m1}
                refs.append((one, result(st, m12)))
                del st
            noise = [differ(refs[1][i], refs[0][i]) for i in range(2)]
            if any(noise):
                print(f"[remat] {case.tag}: two runs without remat differ "
                      f"in {sorted(noise[1].items())[:10]}")

            def check(what, got, i):
                diff = differ(got, refs[0][i])
                require(all(v <= noise[i].get(k, 0.0)
                            for k, v in diff.items()),
                        f"remat {case.tag} {what}: not bitwise the step "
                        f"without remat: {sorted(diff.items())[:20]}")
                return len(got)

            rows = {}
            for policy in (None,) + REMAT_POLICIES:
                tag = policy or "off"
                st = new_state(policy)
                require(st.model.remat == policy,
                        f"remat {case.tag}: model.remat {st.model.remat}")
                n = check(f"{tag} eager", result(*eager(st, 1)), 0)
                e_ms, peak = timed_eager(st)
                del st
                gst = new_state(policy)
                sup = TrainSuperstep(cfg, sched, k=2)
                replays = TrainSuperstep.replays
                gst2, gm = sup(gst, (x, y), seed=SEED)
                require(TrainSuperstep.replays == replays + 1,
                        f"remat {case.tag} {tag}: the graph never replayed")
                check(f"{tag} K=2 graph", result(gst2, gm), 1)
                g_ms = timed_graph(gst2, sup)
                del gst, gst2, sup
                torch.cuda.empty_cache()
                rows[tag] = {"eager_ms": e_ms, "graph_ms": g_ms,
                             "peak_gib": peak / 2**30}
                print(f"[remat] {case.tag} remat={tag}: 1 eager + 2 graph "
                      f"steps bitwise the steps without remat ({n} tensors "
                      f"and metrics); a batch-{TRAIN_BATCH} step {e_ms:.2f} "
                      f"ms eager, {g_ms:.3f} ms in the K=2 graph; eager "
                      f"peak {peak / 2**30:.3f} GiB above the state; "
                      f"{self.gpu}")
            require(rows["nothing"]["peak_gib"] < rows["off"]["peak_gib"],
                    f"remat {case.tag}: 'nothing' peaks at "
                    f"{rows['nothing']['peak_gib']:.3f} GiB, no remat at "
                    f"{rows['off']['peak_gib']:.3f}")
            self.remat_results[case.tag] = rows
        print(f"[remat] results {json.dumps(self.remat_results)}")

    def require_forward_entries(self, what, counts, entries):
        """#1 and #2 launched, each only through its tensor-core entry."""
        for name, entry in (("grid_mhsa", "ogvt_grid_mhsa_th"),
                            ("mlp_branch", "ogvt_mlp_branch_mma")):
            require(counts[name] > 0 and entries[name] == {
                entry: counts[name]}, f"{what}: {name} launches "
                f"{entries[name]}, expected all on {entry}")

    def hold_export(self, case, live, loaded, made):
        """A loaded artifact against its live predictor on the same images:
        labels equal, probabilities within 1e-6 (bitwise reported); one
        loaded forward's launches equal to one live forward's, which are
        the case's launch plan; then imgs/s of both at batch ``BATCH``,
        in turns (live, loaded, loaded, live) ``SERVE_ROUNDS`` times."""
        import numpy as np

        plan, _ = launch_plan(case, stage_shapes(case))
        images = np.random.default_rng(SEED).integers(
            0, 256, (BATCH, case.img, case.img, 3), dtype=np.uint8)
        deltas, outs = {}, {}
        for label, pred in (("live", live), ("loaded", loaded)):
            self.reset_counts()
            outs[label] = pred.predict(images)
            counts, variants = self.read_counts()
            deltas[label] = {k: counts[k] for k in plan}
            if label == "loaded":
                entries = self.read_entries()
                self.record(f"{case.tag} exported", counts, variants)
                self.require_forward_entries(f"{case.tag} exported",
                                             counts, entries)
        (l1, p1), (l2, p2) = outs["live"], outs["loaded"]
        err = float(np.abs(p1 - p2).max())
        require(deltas["live"] == plan, f"{case.tag}: live forward launched "
                f"{deltas['live']}, expected {plan}")
        require(deltas["loaded"] == deltas["live"],
                f"{case.tag}: loaded forward launched {deltas['loaded']}, a "
                f"live one {deltas['live']}")
        require(np.array_equal(l1, l2), f"{case.tag}: labels differ")
        require(err <= 1e-6, f"{case.tag}: probs differ by {err:g}")
        runs = {"live": [], "loaded": []}
        for pred in (live, loaded):
            pred.predict(images)  # warm
        for _ in range(SERVE_ROUNDS):
            for label in ("live", "loaded", "loaded", "live"):
                pred = live if label == "live" else loaded
                t0 = time.perf_counter()
                for _ in range(SERVE_CALLS):
                    pred.predict(images)
                runs[label].append(SERVE_CALLS * BATCH
                                   / (time.perf_counter() - t0))
        ips = {k: float(np.median(v)) for k, v in runs.items()}
        print(f"[evaluate] {case.tag} artifact ({made}): loaded forward "
              f"launches {deltas['loaded']} == live; labels equal; probs "
              f"max |diff| {err:g} (bitwise equal: "
              f"{bool(np.array_equal(p1, p2))}); predict imgs/s at batch "
              f"{BATCH}, median of {2 * SERVE_ROUNDS} turns: live "
              f"{ips['live']:.1f}, loaded {ips['loaded']:.1f}; {self.gpu}")
        self.export_ips = getattr(self, "export_ips", {})
        self.export_ips[case.tag] = ips

    def export_ops(self):
        """Each ``ogvt::`` op exported alone (a module that calls its
        wrapper on its inputs), at one stage shape of a case that reaches
        it, bf16, saved and loaded; the loaded program's output bitwise a
        direct launch on the same inputs, and one launch of the wrapper
        per run."""
        import io

        import torch

        from outgridvit_tpu_torch.ops import library

        todo = (("grid_mhsa", "grid_mhsa", TIN, 1),
                ("mlp_branch", "mlp_branch", TIN, 0),
                ("attn_branch", "attn_branch", TIN, 0),
                ("grid_mhsa_packed", "grid_mhsa_packed", A7M_48, 0),
                ("grid_mhsa_packed", "grid_mhsa_long", A7M_96, 0),
                ("outlook_agg_proj", "outlook_agg", MODEL_B, 0),
                ("outlook_branch", "outlook_branch", MODEL_B, 0),
                ("outlook_softmax_agg", "outlook_softmax", MODEL_B_O, 0),
                ("dwconv3x3", "dwconv3x3", MODEL_B_O, 0),
                ("attn_branch_nhwc", "attn_branch_nhwc", A_BASE, 0))
        require({op for op, *_ in todo} == set(library.OPS),
                f"export_ops covers {sorted({op for op, *_ in todo})}, the "
                f"library has {sorted(library.OPS)}")

        class OneOp(torch.nn.Module):
            def __init__(self, fn, consts):
                super().__init__()
                self.fn, self.consts = fn, consts

            def forward(self, *tensors):
                return self.fn(*tensors, *self.consts)

        for op, name, case, stage in todo:
            sh = stage_shapes(case, BATCH)[stage]
            args = self.fwd_args(name, sh, torch.bfloat16,
                                 sh["H_block"] if name == "mlp_branch"
                                 else None)
            if name == "grid_mhsa":
                args += (sh["grid_variant"],)
            if name == "mlp_branch":
                args += (sh["mlp_variant"],)
            fn = self.kernels[name][0]
            n = len([a for a in args if isinstance(a, torch.Tensor)])
            tensors, consts = args[:n], args[n:]
            t0 = time.perf_counter()
            with torch.no_grad():
                program = torch.export.export(OneOp(fn, consts), tensors)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            buf.seek(0)
            loaded = torch.export.load(buf).module()
            sec = time.perf_counter() - t0
            nodes = [str(nd.target) for nd in loaded.graph.nodes
                     if nd.op == "call_function"
                     and str(nd.target).startswith("ogvt.")]
            require(nodes == [f"ogvt.{op}.default"],
                    f"export {op}: graph calls {nodes}")
            want = fn(*args)
            before = fn.launches
            with torch.inference_mode():
                got = loaded(*tensors)
            require(fn.launches == before + 1,
                    f"export {op}: {fn.launches - before} launches")
            require(torch.equal(got, want),
                    f"export {op} {case.tag} stage {stage}: not bitwise the "
                    "direct launch")
            print(f"[evaluate] ogvt::{op} exported alone at {case.tag} stage "
                  f"{stage} ({tuple(tensors[0].shape)} bf16): graph "
                  f"{nodes}, loaded output bitwise the direct launch, one "
                  f"launch; export + save + load {sec:.2f} s")

    def kernels_line(self):
        out = []
        for name, (source, replaces, covers) in SOURCES.items():
            by_path = self.launches[name]
            t = self.ms[name]
            sources = (source,) if isinstance(source, str) else source
            out.append({
                "name": name, "route": "cuda", "source": sources[0],
                "replaces": replaces, "covers": covers,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_by_variant": self.variants[name],
                "max_abs_err": self.max_err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "ms_per": t["per"],
            })
            if name in self.ab:
                out[-1]["ab_vs_partition_attn_branch_unpartition_ms"] = \
                    self.ab[name]
            if name in self.ab_lib:
                out[-1][AB_KEY.get(name, "ab_vs_sdpa_ms")] = \
                    self.ab_lib[name]
            if name in self.ab_fma:
                out[-1][AB_OLD_KEY.get(name, "ab_vs_fma_kernel_ms")] = \
                    self.ab_fma[name]
            if name in self.share:
                out[-1]["bf16_bitwise_share_min"] = self.share[name]
            if len(sources) > 1:
                out[-1]["sources"] = list(sources)
                out[-1]["launches_by_entry"] = self.entries[name]
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1

    from outgridvit_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gpu = gpu_name_and_power_limit()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"gpu: {gpu}")

    build = kernel_build.build()
    kernel_build.load()
    print(f"[build] nvcc {kernel_build.find_nvcc()} built={build.built} "
          f"seconds={build.seconds:.2f} -> {build.path.name}")
    for line in build.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill" in line):
            print(f"[build] {line.strip()}")

    kernel_build.load_layouts()  # the launch plans' layout queries

    smoke = Smoke(dev, gpu)
    t0 = time.perf_counter()
    for case in CASES:
        # MODEL_B_V runs MODEL_B's kernels at its shapes; A7M_DWB the 7M
        # step with the depthwise backward, whose shapes MODEL_B_O holds
        full = case not in (MODEL_B_V, A7M_DWB)
        if full:
            smoke.compare_all(case)
        if case is not A7M_DWB:
            smoke.serve(case)
        if full:
            smoke.time_kernels(case, backward=False, iters=12)
        smoke.train(case)
        if case is not MODEL_B_V:
            smoke.time_kernels(case, backward=True, iters=6)
        if case is A_BASE:
            smoke.ab_nhwc()
        if case is MODEL_B_O:
            smoke.ab_vs_library()
            smoke.ab_mlp()
            smoke.ab_attn()
            smoke.ab_grid()
            smoke.ab_outlook()
        torch.cuda.empty_cache()
        print(f"[phase] {case.tag} done at {time.perf_counter() - t0:.1f} s")
    smoke.loop()
    torch.cuda.empty_cache()
    print(f"[phase] loop done at {time.perf_counter() - t0:.1f} s")
    smoke.evaluate()
    torch.cuda.empty_cache()
    print(f"[phase] evaluate done at {time.perf_counter() - t0:.1f} s")
    smoke.analyze()
    torch.cuda.empty_cache()
    print(f"[phase] analyze done at {time.perf_counter() - t0:.1f} s")
    for name in FWD + BWD:
        require(smoke.launches[name], f"{name}: no launch on a main path")

    print(gpu)
    print(json.dumps({"kernels": smoke.kernels_line()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
