"""Port parity, the 64px Model A path (Tiny-ImageNet-200,
``configs/tinyimagenet200_model_a.yaml``) against ``outgridvit_tpu`` on the
same numpy inputs (CPU).

- Kernel #3 (``grid_mhsa_pallas_th``, the head-chunked core of the 64px
  stages 1-3) and kernel #4 (``mlp_branch_pallas``, the row-layout MLP of
  stage 0) in interpret mode against the plain versions of the port's
  shared kernels, forward and backward, at their own shapes.
- A tiny Model A whose stage 0 has grids of N=64 tokens (16px input,
  grid 2, C=16), so that its attention takes the fused branch (#5): eval
  logits, and one ``make_train_step`` with the Tiny-ImageNet recipe (crop
  pad 8, ImageNet statistics, cutmix only, no label smoothing) on the JAX
  step's own draws.
- The bf16 P.V rounding point of grids with N > 16, pinned against the JAX
  XLA path (``outgridvit_tpu/models/blocks.py:394``).
- The dispatch by grid size (16 < N < 64 takes kernel #6's core on the
  kernel path, against the JAX #6 in interpret mode), the launch tags at the
  full Tiny-ImageNet widths,
  ``chip_smoke.py``'s configuration, the parameter count and the weight and
  optimizer-state bridge of the full 64px tree.

Tolerances: kernels 3e-5 forward and 2e-3 gradients in fp32, 5e-2 in bf16
(``tests/test_attn_branch_pallas.py``), bf16 parameter gradients 5e-2 of
their largest element; 1e-4 on logits and 1e-5 for one train step
(``docs/PARITY.md``).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models import blocks as jblocks
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops import augment as jaug
from outgridvit_tpu.ops.grid_attention_pallas_t import grid_mhsa_pallas_th
from outgridvit_tpu.ops.mlp_branch_pallas import mlp_branch_pallas
from outgridvit_tpu.training import mixing as jmixing
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu.utils.port_torch import port_torch_state_dict
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.models.blocks import GridAttention2D
from outgridvit_tpu_torch.models.layers import DropPath, LayerNorm
from outgridvit_tpu_torch.ops import augment as taug
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.grid_attention import (
    grid_mhsa_backward_reference,
    grid_mhsa_reference,
    grid_mhsa_variant,
)
from outgridvit_tpu_torch.ops.mlp_branch import (
    mlp_branch_backward_reference,
    mlp_branch_reference,
    mlp_branch_variant,
)
from outgridvit_tpu_torch.training.mixing import MixDraws, apply_mix_draws
from outgridvit_tpu_torch.training.optim import AdamW
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    StepDraws,
    make_train_step,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
    load_jax_train_state,
)

ROOT = Path(__file__).resolve().parents[1]
TIN_YAML = ROOT / "configs" / "tinyimagenet200_model_a.yaml"
TINY64 = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.2,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG, BATCH = 16, 8
# the Tiny-ImageNet recipe (scripts/bench_config.py:32, :75)
AUG = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
           crop_pad=8)
MIX = dict(mixup_alpha=0.0, cutmix_alpha=1.0, mix_prob=0.5)
MIX_DRAW = dict(mixup_alpha=0.0, cutmix_alpha=1.0, prob=0.5)
LR = dict(base_lr=5e-4, total_steps=20, warmup_steps=3, min_lr=1e-6)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_grads(names, got, want, dtype, tol):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        if dtype == "bf16" and name not in ("dx", "dqkv"):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(_np(g) - w).max()) <= tol * scale, name
        else:
            np.testing.assert_allclose(_np(g), w, atol=tol, rtol=tol,
                                       err_msg=name)


# ---- kernel #3: the head-chunked grid MHSA core -------------------------

@pytest.mark.parametrize("C,heads,dtype", [(384, 6, "f32"), (256, 8, "f32"),
                                           (384, 6, "bf16")])
def test_grid_mhsa_plain_matches_pallas_th(C, heads, dtype):
    # the 64px stages 3 (hd 64) and 2 (hd 32), N=16; the interpret-mode
    # unroll of 256 token pairs per head sets the cost, not G
    G, N = 2, 16
    rng = np.random.default_rng(C)
    qkv = rng.normal(size=(G, N, 3 * C)).astype(np.float32)
    dout = rng.normal(size=(G, N, C)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    got = grid_mhsa_reference(_t(qkv, tdt), heads)
    dqkv = grid_mhsa_backward_reference(_t(qkv, tdt), _t(dout, tdt), heads)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q: grid_mhsa_pallas_th(q, heads),
                            jnp.asarray(qkv, jdt))
        (want_dqkv,) = vjp(jnp.asarray(dout, jdt))
    ftol, gtol = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}[dtype]
    assert got.dtype == dqkv.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ftol, rtol=ftol)
    np.testing.assert_allclose(_np(dqkv), np.asarray(want_dqkv, np.float32),
                               atol=gtol, rtol=gtol)


# ---- kernel #4: the row-layout MLP branch --------------------------------

MLP_GRADS = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("H,dtype", [(128, "f32"), (256, "f32"),
                                     (256, "bf16")])
def test_mlp_branch_plain_matches_row_pallas(H, dtype):
    # 64px stage 0: C=64, H = 2C (outlooker MLP) / 4C (block MLP); M=4096
    M, C = 4096, 64
    rng = np.random.default_rng(H)
    args = [rng.normal(size=(M, C)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=C)).astype(np.float32),
            (0.1 * rng.normal(size=C)).astype(np.float32),
            (rng.normal(size=(C, H)) * C ** -0.5).astype(np.float32),
            (0.02 * rng.normal(size=H)).astype(np.float32),
            (rng.normal(size=(H, C)) * H ** -0.5).astype(np.float32),
            (0.02 * rng.normal(size=C)).astype(np.float32)]
    dy = rng.normal(size=(M, C)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    targs = [_t(a, torch.float32 if i in (1, 2) else tdt)
             for i, a in enumerate(args)]
    jargs = [jnp.asarray(a, jnp.float32 if i in (1, 2) else jdt)
             for i, a in enumerate(args)]
    got = mlp_branch_reference(*targs, "gelu", 1e-5, True)
    grads = mlp_branch_backward_reference(*targs, _t(dy, tdt), "gelu", 1e-5,
                                          True)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda *a: mlp_branch_pallas(*a, "gelu", 1e-5, True), *jargs)
        want_grads = vjp(jnp.asarray(dy, jdt))
    ftol, gtol = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ftol, rtol=ftol)
    _close_grads(MLP_GRADS, grads, want_grads, dtype, gtol)


# ---- the tiny N=64 model against the JAX model and step ------------------

def _randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def walk(t, col):
        if isinstance(t, dict):
            return {k: walk(v, col) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        if col == "batch_stats" and a.mean() == 1.0:  # running var
            return (1.0 + 0.5 * rng.random(a.shape)).astype(np.float32)
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)

    return {col: walk(dict(tree), col) for col, tree in variables.items()}


@pytest.fixture(scope="module")
def tiny64():
    jmodel = jax_build_model(TINY64, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(_tree_np(dict(init)))
    return jmodel, variables


def test_tiny_64_token_model_logits_match_jax(tiny64, monkeypatch):
    jmodel, variables = tiny64
    port = load_flax_variables(build_model(TINY64, device="cpu"), variables)
    seen = []
    branch = tblocks.attn_branch_autograd
    monkeypatch.setattr(tblocks, "attn_branch_autograd",
                        lambda x, *a: seen.append(x.shape) or branch(x, *a))
    x = np.random.default_rng(1).normal(size=(3, IMG, IMG, 3)).astype(
        np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_t(x))
    assert seen == [(3 * 4, 64, 16)]  # stage 0 took the fused branch
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _inject_masks(masks):
    """Route explicit keep masks into the JAX model's DropPath modules."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, jlayers.DropPath)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        deterministic = kwargs.get("deterministic",
                                   args[1] if len(args) > 1 else True)
        if mod.rate == 0.0 or deterministic:
            return x
        keep = masks["/".join(mod.path)].astype(x.dtype)
        scale = keep * jnp.asarray(1.0 / (1.0 - mod.rate), x.dtype)
        return x * scale[:, None, None, None]

    return interceptor


def test_tiny_64_token_train_step_matches_jax(tiny64):
    """One step with the Tiny-ImageNet recipe on the JAX step's own draws
    (the JAX step eagerly around a jitted apply, as in
    tests/test_torch_train.py)."""
    from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_lr
    from outgridvit_tpu_torch.training.optim import warmup_cosine_lr

    jmodel, variables = tiny64
    masks_now = {}

    @functools.partial(jax.jit, static_argnames=("train", "mutable"))
    def japply(variables, x, masks, rngs, train, mutable):
        with nn.intercept_methods(_inject_masks(masks)):
            return jmodel.apply(variables, x, train=train, mutable=mutable,
                                rngs=rngs)

    def apply_fn(variables, x, train, mutable, rngs):
        return japply(variables, x, masks_now, rngs, train, tuple(mutable))

    jstate = JaxTrainState.create(
        apply_fn=apply_fn, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=make_optimizer(jax_lr(**LR), 0.05, 1.0))
    jcfg = JaxStepConfig(num_classes=10, label_smoothing=0.0,
                         grad_clip_norm=1.0,
                         augment=jaug.AugmentConfig(**AUG), **MIX)
    model = load_flax_variables(build_model(TINY64, device="cpu"), variables)
    state = TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05, 1.0))
    step = make_train_step(StepConfig(num_classes=10, label_smoothing=0.0,
                                      grad_clip_norm=1.0,
                                      augment=taug.AugmentConfig(**AUG),
                                      **MIX), warmup_cosine_lr(**LR))

    # the first key whose mix draw applies cutmix, so that branch is held
    for seed in range(32):
        base_rng = jax.random.PRNGKey(seed)
        r_aug, r_mix, _, _ = jax.random.split(jax.random.fold_in(base_rng, 0),
                                              4)
        mix = jmixing.sample_mix_draws(r_mix, BATCH, IMG, IMG, **MIX_DRAW)
        if bool(mix.apply):
            break
    assert bool(mix.apply) and bool(mix.use_cutmix)
    data = np.random.default_rng(9)
    images = data.integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8)
    labels = data.integers(0, 10, BATCH)
    aug = jaug.sample_augment_draws(r_aug, images.shape, jcfg.augment)
    rates = {m.path: m.rate for m in model.modules()
             if isinstance(m, DropPath) and m.rate > 0}
    masks = {p: np.random.default_rng(8).random(BATCH) < 1.0 - r
             for p, r in rates.items()}
    masks_now.update((p, jnp.asarray(m)) for p, m in masks.items())

    jstate, jm = jax_train_step(jcfg, jax_lr(**LR), jit=False)(
        jstate, (jnp.asarray(images), jnp.asarray(labels)), base_rng)
    state, tm = step(state, (_t(images), _t(labels)), StepDraws(
        taug.AugmentDraws(*(None if f is None else _t(np.asarray(f))
                            for f in aug)),
        MixDraws(*(_t(np.asarray(f)) for f in mix)),
        DropPathMasks({p: _t(m) for p, m in masks.items()})))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # JAX's grads from its first AdamW moment: mu = (1 - b1) * clip(g)
    scale = max(1.0, float(jm["grad_norm"]) / 1.0)
    mu = jax_tree_to_port(_tree_np(jstate.opt_state[1][0].mu))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(mu)
    for k, m in mu.items():
        np.testing.assert_allclose(grads[k], m / np.float32(0.1) * scale,
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    stats = jax_tree_to_port(_tree_np(jstate.batch_stats))
    for k, v in stats.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v,
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# ---- the bf16 P.V rounding point ------------------------------------------

def test_bf16_grid_attention_rounds_probabilities_like_jax():
    """Grids of N > 16 cast the probabilities to the compute dtype before
    P.V in every JAX path. The port's plain N=64 path once summed fp32
    probabilities: 47% of the bf16 outputs of this module, and 33% of the
    bare core's, were one rounding off the JAX XLA path."""
    rng = np.random.default_rng(0)
    C, heads, hd = 32, 2, 16
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)
    wp = (rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    lb = (0.1 * rng.normal(size=C)).astype(np.float32)
    # zero biases: the XLA path then rounds the projections once, as the
    # fused branch does, and only the P.V rounding point is left to differ
    params = {"mhsa": {"qkv": {"kernel": wqkv, "bias": np.zeros(3 * C)},
                       "proj": {"kernel": wp, "bias": np.zeros(C)}}}
    want = jblocks.GridAttention2D(
        dim=C, num_heads=heads, grid_size=2, use_pallas=False,
        dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x, jnp.bfloat16),
        ln=(jnp.asarray(ls), jnp.asarray(lb), 1e-5))
    port = GridAttention2D(C, heads, 2, dtype=torch.bfloat16)
    ln = LayerNorm(C, 1e-5)
    with torch.no_grad():
        port.mhsa.qkv.weight.copy_(_t(wqkv.T))
        port.mhsa.proj.weight.copy_(_t(wp.T))
        ln.weight.copy_(_t(ls))
        ln.bias.copy_(_t(lb))
        got = port(_t(x, torch.bfloat16), ln)
    assert got.dtype == torch.bfloat16
    differ = _np(got) != np.asarray(want, np.float32)
    assert differ.mean() < 0.01, differ.mean()

    qkv = (rng.normal(size=(32, 64, 3 * C)) * 2).astype(np.float32)
    q, k, v = (jnp.asarray(qkv, jnp.bfloat16).reshape(32, 64, 3, heads, hd)
               [:, :, i] for i in range(3))
    a = jax.nn.softmax(jnp.einsum("bnhd,bmhd->bhnm", q, k,
                                  preferred_element_type=jnp.float32)
                       * hd ** -0.5, axis=-1)
    want = jnp.einsum("bhnm,bmhd->bnhd", a.astype(jnp.bfloat16), v,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    got = grid_mhsa_reference(_t(qkv, torch.bfloat16), heads,
                              round_probs=True)
    differ = _np(got) != np.asarray(want, np.float32).reshape(32, 64, C)
    assert differ.mean() < 0.01, differ.mean()


# ---- the dispatch by grid size ---------------------------------------------

def test_grids_between_16_and_64_tokens(monkeypatch):
    # 12x12 map, grid 2: grids of N=36 tokens (kernel #6 in the JAX package)
    rng = np.random.default_rng(3)
    C = 16
    x = rng.normal(size=(2, 12, 12, C)).astype(np.float32)
    params = {"mhsa": {
        "qkv": {"kernel": (rng.normal(size=(C, 3 * C)) * 0.25)
                .astype(np.float32),
                "bias": (0.1 * rng.normal(size=3 * C)).astype(np.float32)},
        "proj": {"kernel": (rng.normal(size=(C, C)) * 0.25)
                 .astype(np.float32),
                 "bias": (0.1 * rng.normal(size=C)).astype(np.float32)}}}
    want = jblocks.GridAttention2D(dim=C, num_heads=2, grid_size=2,
                                   use_pallas=False).apply(
        {"params": params}, jnp.asarray(x),
        ln=(jnp.ones(C), jnp.zeros(C), 1e-5))
    port = GridAttention2D(C, 2, 2)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            dense = getattr(port.mhsa, name)
            dense.weight.copy_(_t(params["mhsa"][name]["kernel"].T))
            dense.bias.copy_(_t(params["mhsa"][name]["bias"]))
        got = port(_t(x), LayerNorm(C, 1e-5))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the kernel path runs #6's core (its plain version on a CPU tensor),
    # as JAX runs grid_mhsa_pallas at this N
    calls = []
    packed = tblocks.grid_mhsa_packed_autograd
    monkeypatch.setattr(
        tblocks, "grid_mhsa_packed_autograd",
        lambda q, h, k: calls.append((tuple(q.shape), k)) or packed(q, h, k))
    port.mhsa.use_kernels = True
    with pltpu.force_tpu_interpret_mode():
        want6 = jblocks.GridAttention2D(dim=C, num_heads=2, grid_size=2,
                                        use_pallas=True).apply(
            {"params": params}, jnp.asarray(x),
            ln=(jnp.ones(C), jnp.zeros(C), 1e-5))
    with torch.no_grad():
        got = port(_t(x), LayerNorm(C, 1e-5))
    assert calls == [((8, 36, 3 * C), True)]
    np.testing.assert_allclose(_np(got), np.asarray(want6), atol=1e-5,
                               rtol=1e-5)


def test_launch_tags_at_the_tiny_imagenet_widths(monkeypatch):
    """The full-width Tiny-ImageNet model at one 64px image: stage 0 takes
    the fused branch (#5) and the row-layout MLP tag (#4), stages 1-3 the
    head-chunked core tag (#3)."""
    calls = []

    def spy(kind, fn, shape_of, variant_of):
        def wrapped(*a):
            calls.append((kind, shape_of(a), variant_of(a)))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tblocks, "attn_branch_autograd", spy(
        "branch", tblocks.attn_branch_autograd, lambda a: a[0].shape,
        lambda a: None))
    monkeypatch.setattr(tblocks, "grid_mhsa_autograd", spy(
        "grid", tblocks.grid_mhsa_autograd, lambda a: a[0].shape,
        lambda a: a[3]))
    monkeypatch.setattr(tlayers, "mlp_branch_autograd", spy(
        "mlp", tlayers.mlp_branch_autograd, lambda a: a[0].shape,
        lambda a: a[11]))
    cfg = yaml.safe_load(TIN_YAML.read_text())["model"]
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    branch = [c for c in calls if c[0] == "branch"]
    grid = [c for c in calls if c[0] == "grid"]
    mlp = [c for c in calls if c[0] == "mlp"]
    assert [s for _, s, _ in branch] == [(64, 64, 64)] * 2
    assert [(s, v) for _, s, v in grid] == (
        [((64, 16, 384), "th")] * 3 + [((16, 16, 768), "th")] * 4
        + [((4, 16, 1152), "th")] * 2)
    assert [v for _, _, v in mlp] == ["row"] * 4 + ["t"] * 18
    assert grid_mhsa_variant(16, 48) == "t"  # the 32px 7M keeps #1, #2
    assert mlp_branch_variant(32 * 32, 48) == "t"


# ---- augmentation and mixing at 64 px ------------------------------------

def test_augment_and_cutmix_at_64px_match_jax():
    B, size = 4, 64
    images = np.random.default_rng(4).integers(0, 256, (B, size, size, 3),
                                               np.uint8)
    jcfg = jaug.AugmentConfig(**AUG)
    d = jaug.sample_augment_draws(jax.random.PRNGKey(5), images.shape, jcfg)
    ops = np.arange(2 * B) % 14
    d = d._replace(op_ids=jnp.asarray(ops.reshape(2, B), jnp.int32))
    want = np.asarray(jaug.apply_augment_draws(jnp.asarray(images), d, jcfg))
    got = taug.apply_augment_draws(
        _t(images), taug.AugmentDraws(*(None if f is None
                                        else _t(np.asarray(f)) for f in d)),
        taug.AugmentConfig(**AUG))
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=1e-6)
    assert float(np.asarray(d.crop_top).max()) <= 16
    labels = np.arange(B)
    for seed in range(6):
        m = jmixing.sample_mix_draws(jax.random.PRNGKey(seed), B, size, size,
                                     **MIX_DRAW)
        assert not bool(m.apply) or bool(m.use_cutmix)
        wx, wy = jmixing.apply_mix_draws(jnp.asarray(want), labels, m, 200)
        gx, gy = apply_mix_draws(got, _t(labels),
                                 MixDraws(*(_t(np.asarray(f)) for f in m)),
                                 200)
        np.testing.assert_allclose(_np(gx), np.asarray(wx), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(gy), np.asarray(wy), atol=1e-6)


# ---- configuration, parameter count, weight bridge -----------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_tiny_imagenet_config_and_param_count():
    chip_smoke = _chip_smoke()
    cfg = yaml.safe_load(TIN_YAML.read_text())["model"]
    assert chip_smoke.TIN_MODEL_CFG == cfg
    shapes = jax.eval_shape(jax_build_model(cfg, use_pallas=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    port = build_model(cfg, device="meta")
    assert sum(p.numel() for p in port.parameters()) == want == \
        chip_smoke.TIN_PARAMS == 22_542_628
    # the kernel shapes of a serving batch of 64
    got = [(s["attn"], s["G"], s["N"], s["C"], s["heads"], s["M"],
            s["grid_variant"], s["mlp_variant"])
           for s in chip_smoke.stage_shapes(chip_smoke.TIN)]
    assert got == [
        ("branch", 4096, 64, 64, 2, 262144, "t", "row"),
        ("grid", 4096, 16, 128, 4, 65536, "th", "t"),
        ("grid", 1024, 16, 256, 8, 16384, "th", "t"),
        ("grid", 256, 16, 384, 6, 4096, "th", "t")]


def test_64px_weights_and_optimizer_state_carry_across_leaf_for_leaf():
    cfg = yaml.safe_load(TIN_YAML.read_text())["model"]
    shapes = jax.eval_shape(jax_build_model(cfg, use_pallas=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(6)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), tree)

    params, stats = fill(shapes["params"]), fill(shapes["batch_stats"])
    mu, nu = fill(shapes["params"]), fill(shapes["params"])
    state = load_jax_train_state(
        build_model(cfg, device="cpu"), AdamW(1e-3), params=params,
        batch_stats=stats, mu=mu, nu=nu, count=7, step=7)
    sd = state.model.state_dict()
    want = jax_tree_to_port(params)
    want.update(jax_tree_to_port(stats))
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    for name, tree in (("mu", mu), ("nu", nu)):
        for k, v in jax_tree_to_port(tree).items():
            np.testing.assert_array_equal(
                getattr(state.opt_state, name)[k].numpy(), v, err_msg=k)
    assert int(state.opt_state.count) == state.step == 7
    back = port_torch_state_dict({k: t.numpy() for k, t in sd.items()},
                                 {"params": params, "batch_stats": stats},
                                 strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": params,
                                               "batch_stats": stats})):
        np.testing.assert_array_equal(np.asarray(a), b)
