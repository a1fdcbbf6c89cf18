"""Port parity, the baseline zoo: ``outgridvit_tpu_torch.models.baselines``
against ``outgridvit_tpu/models/baselines.py`` on the CPU with the same
weights (JAX variables -> ``load_flax_variables``, strict) and inputs.

Each of the ten ``build_baseline`` names is held at narrow widths through
its constructor fields (ResNet-50 and EfficientNetV2-S have none: full
width at 8 px), eval and train mode (batch statistics), fp32; a few in bf16
against JAX in bf16. The port's kernel paths run their plain versions here
(the MLPs, the MaxViTs' window and grid cores) against JAX's XLA paths.
Then: the window partition, the stem surgeries and special parameters, one
train step of a narrow MaxViT against the JAX step, every full-width
parameter count against JAX's (the port's built on the ``meta`` device,
JAX's from ``jax.eval_shape``), and the baseline CLI in a subprocess.

Bars: 1e-4 on fp32 logits and 1e-5 on BN statistics (ResNet-50's and
EfficientNetV2-S's train mode at full width just above the port's
readings, ``TRAIN_AT``), the partition bitwise; bf16 logits
within 2e-2 of max |fp32 logits| of JAX's bf16 ones; one fp32 train step as
``tests/test_torch_dropout.py`` holds it.
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outgridvit_tpu.models import baselines as jb
from outgridvit_tpu.ops.grid import window_partition as jax_window_partition
from outgridvit_tpu.ops.grid import (
    window_unpartition as jax_window_unpartition,
)
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.models import baselines as tb
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.grid import window_partition, window_unpartition
from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    StepDraws,
    make_train_step,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

ROOT = Path(__file__).resolve().parents[1]

# full-width parameter counts at 100 classes (JAX's; the three of
# tests/test_baselines_extended.py are the reference's published table's)
PARAMS = {
    "resnet18_cifar": 11_220_132,
    "resnet50_cifar": 23_705_252,
    "convnext_tiny": 27_893_572,
    "effnetv2_s": 20_305_588,
    "deit_tiny_patch4": 5_380_132,
    "deit_small_patch4": 21_376_996,
    "vit_micro_patch4": 32_452,
    "maxvit_nano_cifar": 2_577_124,
    "maxvit_tiny_cifar": 25_063_140,
    "swin_tiny_patch2": 8_622_724,
}

# name: (JAX module, port module, input px); narrow where the JAX class
# has width fields
NARROW = {
    "resnet18_cifar": (lambda: jb.ResNet18Cifar(num_classes=10, width=8),
                       lambda **kw: tb.ResNet18Cifar(10, width=8, **kw), 8),
    "resnet50_cifar": (lambda: jb.ResNet50Cifar(num_classes=10),
                       lambda **kw: tb.ResNet50Cifar(10, **kw), 8),
    "convnext_tiny": (
        lambda: jb.ConvNeXtTiny(num_classes=10, dims=(8, 16, 24, 32),
                                depths=(1, 1, 2, 1)),
        lambda **kw: tb.ConvNeXtTiny(10, (8, 16, 24, 32), (1, 1, 2, 1),
                                     **kw), 32),
    "effnetv2_s": (lambda: jb.EfficientNetV2S(num_classes=10),
                   lambda **kw: tb.EfficientNetV2S(10, **kw), 8),
    "deit_tiny_patch4": (
        lambda: jb.DeiT(num_classes=10, dim=16, depth=2, num_heads=2),
        lambda **kw: tb.DeiT(10, 4, 16, 2, 2, img=16, **kw), 16),
    "deit_small_patch4": (
        lambda: jb.DeiT(num_classes=10, dim=24, depth=1, num_heads=3,
                        mlp_ratio=2.0),
        lambda **kw: tb.DeiT(10, 4, 24, 1, 3, 2.0, img=16, **kw), 16),
    "vit_micro_patch4": (
        lambda: jb.DeiT(num_classes=10, patch=4, dim=32, depth=2,
                        num_heads=2),
        lambda **kw: tb.DeiT(10, 4, 32, 2, 2, img=16, **kw), 16),
    "maxvit_nano_cifar": (
        lambda: jb.MaxViTNano(num_classes=10, stem_dim=16, dims=(16, 32),
                              depths=(1, 1)),
        lambda **kw: tb.MaxViTNano(10, 16, (16, 32), (1, 1), img=32, **kw),
        32),
    "maxvit_tiny_cifar": (
        lambda: jb.MaxViTTiny(num_classes=10, stem_dim=16, dims=(16, 32),
                              depths=(2, 1)),
        lambda **kw: tb.MaxViTTiny(10, 16, (16, 32), (2, 1), img=16, **kw),
        16),
    "swin_tiny_patch2": (
        lambda: jb.SwinTiny(num_classes=10, dims=(16, 32), depths=(2, 2)),
        lambda **kw: tb.SwinTiny(10, 2, (16, 32), (2, 2), img=16, **kw), 16),
}
BATCH = 3
# train mode of the full-width deep CNNs, (px, batch, logits bar, BN
# statistics bar): at 8 px their last stages' batch statistics come from a
# handful of values, and the fast variance cancels so badly that JAX's
# jitted and eager forwards disagree by 1.7e-2, so they run at 32 px and
# batch 4. There the port reads 1.37e-4 on ResNet-50's logits and 2.45e-5
# on EfficientNetV2-S's statistics (in allclose's units, |d| / (1 + |x|)),
# the rest under the default bars. Both are JAX's fp32 statistics more than
# the port's: against a forward whose batch statistics are summed in fp64,
# JAX's jitted logits are 1.28e-4 off and the port's 3.4e-5 (ResNet-50),
# JAX's statistics 2.56e-5 off and the port's 1.34e-5 (EfficientNetV2-S)
TRAIN_AT = {"resnet50_cifar": (32, 4, 1.5e-4, 1.5e-5),
            "effnetv2_s": (32, 4, 1e-4, 3e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _random_variables(jmod, img, seed=0):
    """Variables of the JAX module's tree, every leaf drawn from numpy:
    weights at their fan-in scale, norm scales near 1, BN statistics
    plausible."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "var" in name and "batch_stats" in name:
            return (1.0 + 0.5 * rng.random(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if ("scale" in name or "gamma" in name) else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


@functools.lru_cache(maxsize=None)
def _pair(name):
    jmake, tmake, img = NARROW[name]
    jmod = jmake()
    variables = _random_variables(jmod, img)
    port = load_flax_variables(tmake(), variables)  # strict
    return jmod, variables, port, img


@pytest.mark.parametrize("name", list(NARROW))
def test_baseline_logits_match_jax(name):
    jmod, variables, port, img = _pair(name)
    x = np.random.default_rng(1).normal(size=(BATCH, img, img, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(_t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # train mode: batch statistics (the zoo's drop-path rates are 0)
    img, batch, tol, stats_tol = TRAIN_AT.get(name, (img, BATCH, 1e-4,
                                                     1e-5))
    x = np.random.default_rng(2).normal(size=(batch, img, img, 3)).astype(
        np.float32)
    want, upd = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port.train()(_t(x), DropPathMasks({}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    stats = jax_tree_to_port(_tree_np(dict(upd).get("batch_stats", {})),
                             port.flax_renames)
    assert set(stats) == {k for k, _ in port.named_buffers()}
    for k, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[k], atol=stats_tol,
                                   rtol=stats_tol, err_msg=k)
    port.load_state_dict(saved)
    port.eval()


@pytest.mark.parametrize("name", ["maxvit_nano_cifar", "swin_tiny_patch2",
                                  "deit_tiny_patch4", "resnet18_cifar"])
def test_baseline_bf16_logits_match_jax_bf16(name):
    jmake, tmake, img = NARROW[name]
    _, variables, fp32, _ = _pair(name)
    jmod = jmake().clone(dtype=jnp.bfloat16)
    port = load_flax_variables(tmake(dtype=torch.bfloat16), variables)
    x = np.random.default_rng(2).normal(size=(BATCH, img, img, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x))(
        variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = port.eval()(_t(x)).numpy()
        ref = fp32.eval()(_t(x)).numpy()
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - want).max() <= 2e-2 * scale, (
        np.abs(got - want).max(), scale)


def test_window_partition_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 8, 12, 5)).astype(np.float32)
    for w in (1, 2, 4):
        want, wmeta = jax_window_partition(jnp.asarray(x), w)
        got, meta = window_partition(_t(x), w)
        assert tuple(meta) == tuple(wmeta)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = window_unpartition(got, meta)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            np.asarray(jax_window_unpartition(want, wmeta)), back.numpy())
    with pytest.raises(ValueError, match="divisible"):
        window_partition(_t(x), 3)
    with pytest.raises(ValueError, match="> 0"):
        window_partition(_t(x), 0)


def test_surgeries_and_special_parameters():
    meta = "meta"
    r18 = tb.build_baseline("resnet18", 100, device=meta)
    assert tuple(r18.stem.weight.shape) == (64, 3, 3, 3)
    assert r18.stem.stride == 1 and not hasattr(r18, "maxpool")
    mt = tb.build_baseline("maxvit_tiny", 100, device=meta)
    assert tuple(mt.stem_conv1.weight.shape) == (64, 3, 3, 3)
    assert mt.stem_conv1.stride == mt.stem_conv2.stride == 1
    # MaxViT-T at 32 px: windows of 4 until stage 3 (2 px, windows of 2)
    assert [b.window_attn.window_size for b in mt.blocks] == \
        [4] * 9 + [2, 2]
    cn = tb.build_baseline("convnext_tiny", 100, device="cpu")
    assert (cn.stem.weight.shape[-1], cn.stem.stride) == (2, 2)
    assert torch.all(cn.stages_0_0.gamma == 1e-6)
    ef = tb.build_baseline("effnetv2_s", 100, device=meta)
    se = ef.blocks_3_0.se  # reduction on the block input's 64 channels
    assert tuple(se.reduce.weight.shape) == (16, 256, 1, 1)
    deit = tb.build_baseline("deit_tiny", 100, device="cpu", seed=3)
    assert tuple(deit.cls_token.shape) == (1, 1, 192)
    assert tuple(deit.pos_embed.shape) == (1, 65, 192)
    assert torch.all(deit.cls_token == 0)
    assert 0.015 < deit.pos_embed.std().item() < 0.025
    # Swin's region mask at a shift of 2 on an 8 x 8 map with windows of 4
    mask = tb.swin_region_mask(8, 8, 4, 2)
    assert mask.shape == (4, 16, 16)
    assert set(np.unique(mask)) == {0.0, np.float32(-1e30)}
    assert (mask == mask.transpose(0, 2, 1)).all()
    assert (np.diagonal(mask, axis1=1, axis2=2) == 0).all()
    # tokens a window lets each token see: its pre-roll region's
    seen = sorted(sorted((m == 0).sum(1).tolist()) for m in mask)
    assert seen == [[4] * 16] * 4, seen  # each window cut in 4 regions
    with pytest.raises(ValueError, match="Unknown baseline"):
        tb.build_baseline("vgg16", 10, device=meta)


@pytest.mark.parametrize("name", list(PARAMS))
def test_full_width_parameter_counts_match_jax(name):
    port = tb.build_baseline(name, 100, device="meta")
    got = sum(p.numel() for p in port.parameters())
    shapes = jax.eval_shape(jb.build_baseline(name, 100).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == PARAMS[name]
    assert port.name == name and not port.training


def test_maxvit_train_step_matches_jax():
    jmod, variables, _, img = _pair("maxvit_tiny_cifar")
    port = load_flax_variables(NARROW["maxvit_tiny_cifar"][1](), variables)
    lr = dict(base_lr=1e-3, total_steps=20, warmup_steps=2, min_lr=1e-6)
    jstate = JaxTrainState.create(
        apply_fn=jmod.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=make_optimizer(jax_schedule(**lr), 0.05, 1.0))
    jstep = jax_train_step(JaxStepConfig(num_classes=10), jax_schedule(**lr))
    state = TrainState.create(port, AdamW(warmup_cosine_lr(**lr), 0.05,
                                          1.0))
    step = make_train_step(StepConfig(num_classes=10), warmup_cosine_lr(**lr))
    rng = np.random.default_rng(4)
    for _ in range(1):
        x = rng.normal(size=(4, img, img, 3)).astype(np.float32)
        y = rng.integers(0, 10, 4)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)),
                           jax.random.PRNGKey(0))
        state, tm = step(state, (_t(x), _t(y)),
                         StepDraws(None, None, DropPathMasks({})))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    renames = port.flax_renames
    mu = jax_tree_to_port(_tree_np(jstate.opt_state[1][0].mu), renames)
    for k, m in state.opt_state.mu.items():
        np.testing.assert_allclose(m.numpy(), mu[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    theirs = jax_tree_to_port(_tree_np(jstate.params), renames)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[k], atol=2e-3,
                                   rtol=0, err_msg=k)


def _cli(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "outgridvit_tpu_torch.train_cifar32_baselines",
         *args], cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)


def test_baseline_cli_on_the_cpu(tmp_path):
    models = ["vit_micro_patch4", "maxvit_nano_cifar"]
    proc = _cli(["--models", *models, "--dataset", "synthetic",
                 "--num-samples", "32", "--batch-size", "16", "--epochs",
                 "1", "--num-classes", "10", "--num-workers", "0",
                 "--img-size", "16", "--print-every", "1", "--device",
                 "cpu", "--output-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    for name in models:
        assert f"##### Baseline: {name} #####" in out
        assert (tmp_path / f"last_{name}.ckpt").read_bytes()[:4] == b"OGVT"
        assert re.search(rf"^{name}: train top1 \d+\.\d\d% \| best val top1 "
                         r"(\d+\.\d\d%|n/a)$", out, re.M), out[-2000:]
    assert "===== Baseline summary =====" in out
    assert "device=cpux1" in out and "compute=bfloat16" in out
    if not torch.cuda.is_available():  # the card by default, no fallback
        proc = _cli(["--models", "vit_micro_patch4", "--dataset",
                     "synthetic", "--output-dir", str(tmp_path)])
        assert proc.returncode == 2 and "no CUDA device" in proc.stderr
