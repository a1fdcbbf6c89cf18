"""Port parity, Model B (OutlookerFrontGridNet, ``configs/
cifar100_model_b.yaml``) against ``outgridvit_tpu`` on the same numpy inputs
(CPU, fp32).

- The full-width weight tree (from ``jax.eval_shape``) and its AdamW state
  carry across strictly, leaf for leaf, both ways; 12,266,266 parameters;
  ``chip_smoke.py``'s Model B configuration is the yaml's.
- A tiny Model B (front depth 2, two narrow stages, 16 px) against the JAX
  model with ``use_pallas=False``, in the port's ``xla`` mode and the three
  fused outlook modes (#7, #8, and #9 with the depthwise mode "t" of #10:
  their plain versions here): logits in eval mode and in train mode (JAX's
  drop-path masks injected), and one ``fused_agg`` train step and one
  ``fused_outlook`` + "t" step with the yaml's recipe on the JAX step's
  draws; one step of a tiny Model A with the depthwise mode "bwd" (#11).
- ``model.use_pallas`` and ``model.remat`` are read, never dropped: a fused
  mode reaches the outlook op, and what is not ported raises.

Tolerances (``docs/PARITY.md``): 1e-4 on logits, 1e-5 for one train step.
The fused modes and the XLA path differ only in the order of fp32 sums.
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

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops import augment as jaug
from outgridvit_tpu.training import mixing as jmixing
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_lr
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu.utils.port_torch import port_torch_state_dict
from outgridvit_tpu_torch.models import OutlookerFrontGridNet, build_model
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.models.layers import DropPath
from outgridvit_tpu_torch.ops import augment as taug
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.training.mixing import MixDraws
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
    load_jax_train_state,
)

ROOT = Path(__file__).resolve().parents[1]
B_YAML = ROOT / "configs" / "cifar100_model_b.yaml"
TINY_B = {
    "type": "model_b", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "outlooker_front_depth": 2, "dpr_max": 0.2,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG, BATCH = 16, 8
MODES = ("xla", "fused_agg", "fused_agg_v", "fused_outlook")
# fused_outlook runs with the depthwise kernels' mode "t" (#9 with #10, the
# path chip_smoke.py drives); the other modes with the grouped conv
PATH_DWCONV = {"fused_outlook": "t"}
TINY_A = dict(TINY_B, type="model_a", dpr_max=0.1)
# the cifar100_model_b.yaml recipe (CIFAR-100 statistics, crop pad 4)
AUG = dict(mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
           crop_pad=4)
MIX = dict(mixup_alpha=0.0, cutmix_alpha=1.0, mix_prob=0.5)
MIX_DRAW = dict(mixup_alpha=0.0, cutmix_alpha=1.0, prob=0.5)
LR = dict(base_lr=5e-4, total_steps=20, warmup_steps=3, min_lr=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(mode):
    return TINY_B if mode == "xla" else dict(TINY_B, use_pallas=mode)


# ---- the full-width tree, its count and chip_smoke's config ---------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_model_b_weights_and_optimizer_state_carry_across_leaf_for_leaf():
    cfg = yaml.safe_load(B_YAML.read_text())["model"]
    shapes = jax.eval_shape(jax_build_model(cfg, use_pallas=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    count = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert count == 12_266_266
    rng = np.random.default_rng(7)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), tree)

    params, stats = fill(shapes["params"]), fill(shapes["batch_stats"])
    mu, nu = fill(shapes["params"]), fill(shapes["params"])
    model = build_model(dict(cfg, use_pallas="fused_agg"), device="cpu")
    assert isinstance(model, OutlookerFrontGridNet)
    assert sum(p.numel() for p in model.parameters()) == count
    state = load_jax_train_state(model, AdamW(1e-3), params=params,
                                 batch_stats=stats, mu=mu, nu=nu, count=3,
                                 step=3)
    sd = state.model.state_dict()
    want = jax_tree_to_port(params)
    want.update(jax_tree_to_port(stats))
    assert set(sd) == set(want)
    assert any(k.startswith("front.2.attn.v.") for k in sd)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    for name, tree in (("mu", mu), ("nu", nu)):
        for k, v in jax_tree_to_port(tree).items():
            np.testing.assert_array_equal(
                getattr(state.opt_state, name)[k].numpy(), v, err_msg=k)
    variables = {"params": params, "batch_stats": stats}
    back = port_torch_state_dict({k: t.numpy() for k, t in sd.items()},
                                 variables, strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want_leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(got) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))

    chip_smoke = _chip_smoke()
    smoke_cfg = dict(chip_smoke.MODEL_B_MODEL_CFG)
    assert smoke_cfg.pop("use_pallas") == "fused_agg"
    assert smoke_cfg == cfg
    assert chip_smoke.MODEL_B_PARAMS == count
    # Model B's kernel shapes at a serving batch of 64: grids of N = 16 and
    # 4 tokens (#1, tag "t") and the 32x32x64 front (#7 / #8)
    shapes_b = chip_smoke.stage_shapes(chip_smoke.MODEL_B)
    assert [(s["G"], s["N"], s["C"], s["grid_variant"], s["mlp_variant"])
            for s in shapes_b] == [
        (4096, 16, 64, "t", "t"), (4096, 4, 128, "t", "t"),
        (1024, 4, 256, "t", "t"), (256, 4, 384, "t", "t")]


# ---- the tiny model against JAX -------------------------------------------

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
def tiny_b():
    jmodel = jax_build_model(TINY_B, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    return jmodel, _randomize(_tree_np(dict(init)))


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


def _masks(model, seed=8):
    rng = np.random.default_rng(seed)
    return {m.path: rng.random(BATCH) < 1.0 - m.rate
            for m in model.modules() if isinstance(m, DropPath) and m.rate}


@pytest.mark.parametrize("mode", MODES)
def test_tiny_model_b_logits_match_jax(tiny_b, mode):
    jmodel, variables = tiny_b
    port = load_flax_variables(
        build_model(_port_cfg(mode), device="cpu",
                    dwconv=PATH_DWCONV.get(mode, "xla")), variables)
    x = np.random.default_rng(1).normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)

    masks = _masks(port)
    # make_dpr: front_0's rate is 0, every later block's is not
    assert {p.split("/")[0] for p in masks} == {"front_1", "stages_0_0",
                                                "stages_1_0"}
    with nn.intercept_methods(_inject_masks(
            {p: jnp.asarray(m) for p, m in masks.items()})):
        want, new = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(_t(x), DropPathMasks({p: _t(m) for p, m in masks.items()}))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    stats = jax_tree_to_port(_tree_np(new["batch_stats"]))
    for k, v in stats.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), v,
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _step_matches_jax(jmodel, variables, port_cfg, dwconv, spies,
                      monkeypatch):
    """One port step of ``port_cfg`` (depthwise mode ``dwconv``) against
    one JAX step with the yaml's recipe, on the JAX step's own draws (the
    JAX step eagerly around a jitted apply, as in tests/test_torch_train.py).
    ``spies``: {label: (module, function name)} whose calls' first shapes
    are recorded and returned."""
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
    model = load_flax_variables(
        build_model(port_cfg, device="cpu", dwconv=dwconv), variables)
    state = TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05, 1.0))
    step = make_train_step(StepConfig(num_classes=10, label_smoothing=0.0,
                                      grad_clip_norm=1.0,
                                      augment=taug.AugmentConfig(**AUG),
                                      **MIX), warmup_cosine_lr(**LR))
    calls = {label: [] for label in spies}
    for label, (module, name) in spies.items():
        real = getattr(module, name)
        monkeypatch.setattr(
            module, name, lambda *a, real=real, label=label:
            calls[label].append(tuple(a[0].shape)) or real(*a))
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
    masks = _masks(model)
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
    return calls


def test_tiny_model_b_fused_train_step_matches_jax(tiny_b, monkeypatch):
    """One step through the fused_agg path (#7's plain versions)."""
    calls = _step_matches_jax(
        *tiny_b, _port_cfg("fused_agg"), "xla",
        {"agg": (tblocks, "outlook_agg_proj_autograd")}, monkeypatch)
    assert calls == {"agg": [(BATCH, IMG, IMG, 16)] * 2}


def test_tiny_model_b_fused_outlook_dwconv_t_train_step_matches_jax(
        tiny_b, monkeypatch):
    """One step of the path chip_smoke.py drives as ``model_b_o``:
    fused_outlook (#9) at the front, the depthwise mode "t" (#10) in every
    MBConv, their plain versions here; JAX with use_pallas=False computes
    the same function in fp32."""
    calls = _step_matches_jax(
        *tiny_b, _port_cfg("fused_outlook"), "t",
        {"softmax": (tblocks, "outlook_softmax_autograd"),
         "dwconv": (tlayers, "dwconv3x3_autograd")}, monkeypatch)
    # two front outlookers; the MBConvs of stages 0 and 1 (mid = 4 C)
    assert calls == {"softmax": [(BATCH, IMG, IMG, 16)] * 2,
                     "dwconv": [(BATCH, IMG, IMG, 64),
                                (BATCH, IMG // 2, IMG // 2, 128)]}


@pytest.fixture(scope="module")
def tiny_a():
    jmodel = jax_build_model(TINY_A, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                jnp.zeros((1, IMG, IMG, 3)))
    return jmodel, _randomize(_tree_np(dict(init)), seed=2)


def test_tiny_model_a_dwconv_bwd_train_step_matches_jax(tiny_a, monkeypatch):
    """One Model A step with the depthwise mode "bwd" (#11: the grouped
    conv forward, the written-out backward) against the JAX step."""
    calls = _step_matches_jax(
        *tiny_a, TINY_A, "bwd", {"dwconv": (tlayers, "dwconv3x3_autograd")},
        monkeypatch)
    assert calls == {"dwconv": [(BATCH, IMG, IMG, 64),
                                (BATCH, IMG // 2, IMG // 2, 128)]}


# ---- model.use_pallas and model.remat are read ----------------------------

@pytest.mark.parametrize("mode,entry", [
    ("xla", None), ("fused_agg", "outlook_agg_proj_autograd"),
    ("fused_agg_v", "outlook_branch_autograd"),
    ("fused_outlook", "outlook_softmax_autograd")])
def test_use_pallas_reaches_the_outlook_op(mode, entry, monkeypatch):
    calls = {}
    for name in ("outlook_agg_proj_autograd", "outlook_branch_autograd",
                 "outlook_softmax_autograd"):
        real = getattr(tblocks, name)
        monkeypatch.setattr(
            tblocks, name,
            lambda *a, name=name, real=real:
            calls.setdefault(name, []).append(a[-1]) or real(*a))
    model = build_model(_port_cfg(mode), device="cpu")
    with torch.no_grad():
        model(torch.zeros(2, IMG, IMG, 3))
    # two front outlookers, on the plain versions (use_kernels False)
    assert calls == ({} if entry is None else {entry: [False, False]})
    modes = {m.mode for m in model.modules()
             if isinstance(m, tblocks.OutlookAttention2d)}
    assert modes == {mode}
    # Model A honours the key the same way
    a = build_model(dict(_port_cfg(mode), type="model_a"), device="cpu")
    assert {m.mode for m in a.modules()
            if isinstance(m, tblocks.OutlookAttention2d)} == {mode}


def test_unported_use_pallas_and_remat_raise():
    # every value the JAX build takes builds, fused_outlook (#9) too
    for use_pallas in (None, True, False, "fused_outlook"):
        build_model(dict(TINY_B, use_pallas=use_pallas), device="meta")
    with pytest.raises(ValueError, match="use_pallas"):
        build_model(dict(TINY_B, use_pallas="fused"), device="meta")
    with pytest.raises(ValueError, match="dwconv"):
        build_model(TINY_B, device="meta", dwconv="taps")
    for remat in ("dots", "nothing", "dots_no_batch"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dict(TINY_B, remat=remat), device="meta")
    for remat in (False, None, "off", "none", 0, ""):
        build_model(dict(TINY_B, remat=remat), device="meta")
