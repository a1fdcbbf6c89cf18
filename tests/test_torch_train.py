"""Port parity, training: ``outgridvit_tpu_torch.training`` and the train-mode
model against ``outgridvit_tpu`` on the same numpy inputs and the same draws
(CPU, fp32).

The JAX draws come from the keys the JAX step itself derives
(``fold_in(base_rng, step)`` split four ways, ``training/steps.py:60-61``)
through ``sample_augment_draws`` / ``sample_mix_draws``; drop-path masks are
drawn with numpy and routed into the JAX model with
``flax.linen.intercept_methods`` around ``DropPath.__call__``, keyed on the
module path. Nothing in the JAX package changes for that.

The JAX step runs with ``jit=False`` around a jitted ``apply_fn``: under one
``jax.jit`` of the whole step, XLA fuses the enhance blend
``deg + f*(x - deg)`` with its neighbours and can flip the floor() of a
value at an exact integer (measured on this test's first batch: 2 of 6,144
augmented values one pixel level apart between the jitted and the eager JAX
step, enough to move the loss by 2e-5). The port evaluates the blend
unfused, as eager JAX does, and matches it bit for bit.

Tolerances: 1e-5 per fp32 op and for one train step (loss, metrics, every
gradient, BN statistics); 1e-6 for one clip + AdamW update; the uint8
augmentation path bit-exact; 5e-4 on an 8-step loss trajectory and 2e-3 on
the parameters after it (the ``docs/PARITY.md`` bars).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops import augment as jaug
from outgridvit_tpu.ops.drop_path import drop_path as jax_drop_path
from outgridvit_tpu.training import losses as jlosses
from outgridvit_tpu.training import mixing as jmixing
from outgridvit_tpu.training.metrics import accuracy_topk as jax_accuracy
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models.layers import BatchNorm, DropPath
from outgridvit_tpu_torch.ops import augment as taug
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks, drop_path
from outgridvit_tpu_torch.training.losses import (
    cross_entropy_smoothed,
    soft_target_cross_entropy,
)
from outgridvit_tpu_torch.training.metrics import accuracy_topk
from outgridvit_tpu_torch.training.mixing import (
    MixDraws,
    apply_mix_draws,
    sample_mix_draws,
)
from outgridvit_tpu_torch.training.optim import (
    AdamW,
    global_norm,
    warmup_cosine_lr,
)
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

TINY = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.2,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 4},
    ],
}
IMG, BATCH, STEPS = 16, 8, 8
AUG = dict(mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
           crop_pad=2)
MIX = dict(mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.5)
MIX_DRAW = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.5)
LR = dict(base_lr=5e-4, total_steps=20, warmup_steps=3, min_lr=1e-6)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- layers ---------------------------------------------------------------

def test_batchnorm_train_mode_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 5, 5, 6)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=6)).astype(np.float32)
    bias = (0.1 * rng.normal(size=6)).astype(np.float32)
    mean = (0.1 * rng.normal(size=6)).astype(np.float32)
    var = (1 + 0.5 * rng.random(6)).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    want, mutated = jlayers.BatchNorm().apply(
        variables, jnp.asarray(x), use_running_average=False,
        mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean))
        bn.running_var.copy_(_t(var))
    got = bn(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    stats = mutated["batch_stats"]["bn"]
    # running statistics: the biased batch variance at momentum 0.9
    np.testing.assert_allclose(_np(bn.running_mean), stats["mean"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(bn.running_var), stats["var"], atol=1e-5,
                               rtol=1e-5)


def test_drop_path_with_injected_masks_matches_jax():
    x = np.random.default_rng(1).normal(size=(6, 3, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rate = 0.3
    want = jax_drop_path(jnp.asarray(x), rate, key, deterministic=False)
    keep = np.asarray(jax.random.bernoulli(key, p=1.0 - rate,
                                           shape=(6, 1, 1, 1))).reshape(6)
    assert 0 < keep.sum() < 6
    np.testing.assert_array_equal(_np(drop_path(_t(x), _t(keep), rate)),
                                  np.asarray(want))
    dp = DropPath(rate)
    dp.path = "stages_0_0/dp3"
    masks = DropPathMasks({"stages_0_0/dp3": _t(keep)})
    np.testing.assert_array_equal(_np(dp(_t(x), masks)), np.asarray(want))
    assert dp.eval()(_t(x), None) is not None  # identity in eval mode
    with pytest.raises(ValueError, match="drop-path masks"):
        dp.train()(_t(x), None)


# ---- mixing ---------------------------------------------------------------

def _mix_draws_to_torch(d):
    return MixDraws(*(_t(np.asarray(f)) for f in d))


def test_apply_mix_draws_matches_jax_on_every_branch():
    rng = np.random.default_rng(2)
    images = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    labels = rng.integers(0, 10, BATCH)
    seen = set()
    for seed in range(12):
        d = jmixing.sample_mix_draws(jax.random.PRNGKey(seed), BATCH, IMG,
                                     IMG, **MIX_DRAW)
        want_x, want_y = jmixing.apply_mix_draws(
            jnp.asarray(images), jnp.asarray(labels), d, 10)
        got_x, got_y = apply_mix_draws(_t(images), _t(labels),
                                       _mix_draws_to_torch(d), 10)
        np.testing.assert_allclose(_np(got_x), np.asarray(want_x),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(got_y), np.asarray(want_y),
                                   atol=1e-6, rtol=1e-6)
        seen.add((bool(d.apply), bool(d.use_cutmix) if d.apply else None))
    assert seen == {(False, None), (True, True), (True, False)}


def test_sample_mix_draws_ranges_and_reproducibility():
    def draw(seed):
        return sample_mix_draws(torch.Generator().manual_seed(seed), 16, 32,
                                24, **MIX_DRAW)

    d = draw(0)
    assert sorted(d.perm.tolist()) == list(range(16))
    assert 0.0 <= float(d.lam_m) <= 1.0 and 0.0 <= float(d.lam_c0) <= 1.0
    assert 0 <= int(d.cx) < 24 and 0 <= int(d.cy) < 32
    assert all(torch.equal(a, b) for a, b in zip(d, draw(0)))
    # Beta(0.8, 0.8) over many draws: mean 1/2, variance 1/(4*2.6)
    g = torch.Generator().manual_seed(1)
    lam = np.array([float(sample_mix_draws(g, 2, 4, 4, 0.8, 0.0).lam_m)
                    for _ in range(2000)])
    assert abs(lam.mean() - 0.5) < 0.03
    assert abs(lam.var() - 1 / 10.4) < 0.01


# ---- augmentation ---------------------------------------------------------

def _aug_draws_to_torch(d):
    return taug.AugmentDraws(*(None if f is None else _t(np.asarray(f))
                               for f in d))


def _uint8_stage_jax(images, d, cfg):
    """The JAX recipe up to normalization (crop/flip warp, RandAugment), in
    int32, from the same private functions apply_augment_draws runs."""
    x = jnp.asarray(images).astype(jnp.int32)
    B, H, W, _ = x.shape
    one, zero = jnp.ones((B,), jnp.float32), jnp.zeros((B,), jnp.float32)
    p = float(cfg.crop_pad)
    crop_m = jnp.stack([one, zero, d.crop_left - p, zero, one,
                        d.crop_top - p], 1)
    flip_m = jnp.stack([jnp.where(d.flip, -1.0, 1.0), zero,
                        jnp.where(d.flip, float(W), 0.0), zero, one, zero], 1)
    x = jaug._affine_warp_nearest(x, jaug._compose_affine(crop_m, flip_m))
    return jaug.rand_augment_apply(x, d.op_ids, d.signs, cfg.ra_magnitude)


def _uint8_stage_port(images, d, cfg):
    xf = taug.apply_augment_draws(
        _t(images), d, taug.AugmentConfig(**dict(
            cfg.__dict__, random_erasing_p=0.0, mean=(0.0,) * 3,
            std=(1 / 255,) * 3)))
    return torch.round(xf).to(torch.int32)


@pytest.mark.parametrize("size", [16, 32])
def test_apply_augment_draws_bit_exact_on_every_op(size):
    B = BATCH
    images = np.random.default_rng(4).integers(0, 256, (B, size, size, 3),
                                               np.uint8)
    jcfg = jaug.AugmentConfig(**AUG)
    d = jaug.sample_augment_draws(jax.random.PRNGKey(2), images.shape, jcfg)
    # every op id over the two RandAugment slots, each with both signs
    ops = np.arange(2 * B) % 14
    signs = np.where(np.arange(2 * B) % 2, 1.0, -1.0)
    d = d._replace(op_ids=jnp.asarray(ops.reshape(2, B), jnp.int32),
                   signs=jnp.asarray(signs.reshape(2, B), jnp.float32))
    want = np.asarray(_uint8_stage_jax(images, d, jcfg))
    # the warp/RandAugment output, exact (normalize with mean 0, std 1/255
    # returns the integer pixels, exactly representable)
    got = _uint8_stage_port(images, _aug_draws_to_torch(d),
                            taug.AugmentConfig(**AUG))
    np.testing.assert_array_equal(got.numpy(), want)
    # the whole recipe, normalization and erasing included
    want_f = np.asarray(jaug.apply_augment_draws(jnp.asarray(images), d, jcfg))
    got_f = taug.apply_augment_draws(_t(images), _aug_draws_to_torch(d),
                                     taug.AugmentConfig(**AUG))
    np.testing.assert_allclose(_np(got_f), want_f, atol=1e-6, rtol=1e-6)
    assert bool(np.asarray(d.er_apply).any())


def test_sample_augment_draws_ranges():
    cfg = taug.AugmentConfig(**AUG)
    d = taug.sample_augment_draws(torch.Generator().manual_seed(0),
                                  (64, IMG, IMG, 3), cfg)
    assert set(d.crop_top.tolist()) <= set(range(2 * cfg.crop_pad + 1))
    assert d.op_ids.shape == (2, 64) and int(d.op_ids.max()) < 14
    assert set(d.signs.unique().tolist()) == {-1.0, 1.0}
    er = d.er_apply
    assert bool(((d.er_top + d.er_h)[er] <= IMG).all())
    assert bool(((d.er_left + d.er_w)[er] <= IMG).all())
    assert d.er_noise.shape == (64, IMG, IMG, 3)


# ---- losses, metrics, schedule, optimizer --------------------------------

def test_losses_and_accuracy_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(9, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 9)
    soft = rng.random((9, 10)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        float(soft_target_cross_entropy(_t(logits), _t(soft))),
        float(jlosses.soft_target_cross_entropy(logits, soft)), rtol=1e-6)
    for s in (0.0, 0.1):
        np.testing.assert_allclose(
            float(cross_entropy_smoothed(_t(logits), _t(labels), s)),
            float(jlosses.cross_entropy_smoothed(logits, labels, s)),
            rtol=1e-6)
    for targets in (labels, soft):
        got = accuracy_topk(_t(logits), _t(targets))
        want = jax_accuracy(jnp.asarray(logits), jnp.asarray(targets))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}


def test_lr_schedule_matches_jax():
    for kw in (LR, dict(LR, warmup_steps=0)):
        ours, theirs = warmup_cosine_lr(**kw), jax_schedule(**kw)
        for count in (0, 1, 2, 3, 4, 10, 19, 25):
            np.testing.assert_allclose(float(ours(count)),
                                       float(theirs(count)), rtol=1e-6)
    assert float(warmup_cosine_lr(**LR)(0)) == pytest.approx(5e-4 / 3)


def test_clip_and_adamw_update_match_optax():
    rng = np.random.default_rng(7)
    params = {"classifier": {"kernel": rng.normal(size=(8, 5)),
                             "bias": rng.normal(size=5)},
              "head_norm": {"bn": {"scale": 1 + rng.normal(size=8) * 0.1,
                                   "bias": rng.normal(size=8)}}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    tx = make_optimizer(jax_schedule(**LR), 0.05, 1.0)
    ours = AdamW(warmup_cosine_lr(**LR), 0.05, 1.0)
    tparams = {k: _t(v) for k, v in jax_tree_to_port(params).items()}
    jstate, tstate = tx.init(params), ours.init(tparams)
    jparams = params
    for scale in (3.0, 0.05):  # clipped, then not
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
            params)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tgrads = {k: _t(v) for k, v in jax_tree_to_port(grads).items()}
        gnorm = global_norm(list(tgrads.values()))
        ours.apply_(tparams, tgrads, tstate, gnorm, torch.tensor(True))
        for k, v in jax_tree_to_port(_tree_np(jparams)).items():
            np.testing.assert_allclose(_np(tparams[k]), v, atol=1e-6,
                                       rtol=1e-6, err_msg=k)
        adam = jstate[1][0]
        for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
            for k, v in jax_tree_to_port(_tree_np(tree)).items():
                np.testing.assert_allclose(
                    _np(getattr(tstate, name)[k]), v, atol=1e-6, rtol=1e-6,
                    err_msg=f"{name} {k}")
        assert int(tstate.count) == int(adam.count)


# ---- the train step of the tiny model against make_train_step ------------

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


@pytest.fixture(scope="module")
def run():
    """8 steps of the tiny model through the JAX step and the port's, on
    the same state, batches and draws, then one step whose loss is NaN."""
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(_tree_np(dict(init)))
    masks_now = {}

    @functools.partial(jax.jit, static_argnames=("train", "mutable"))
    def japply(variables, x, masks, rngs, train, mutable):
        with nn.intercept_methods(_inject_masks(masks)):
            return jmodel.apply(variables, x, train=train, mutable=mutable,
                                rngs=rngs)

    def apply_fn(variables, x, train, mutable, rngs):
        return japply(variables, x, masks_now, rngs, train, tuple(mutable))

    tx = make_optimizer(jax_schedule(**LR), 0.05, 1.0)
    jstate = JaxTrainState.create(apply_fn=apply_fn,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=tx)
    jcfg = JaxStepConfig(num_classes=10, grad_clip_norm=1.0,
                         augment=jaug.AugmentConfig(**AUG), **MIX)
    jstep = jax_train_step(jcfg, jax_schedule(**LR), jit=False)

    model = load_flax_variables(build_model(TINY, device="cpu"), variables)
    state = TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05, 1.0))
    step = make_train_step(StepConfig(num_classes=10, grad_clip_norm=1.0,
                                      augment=taug.AugmentConfig(**AUG),
                                      **MIX), warmup_cosine_lr(**LR))
    rates = {m.path: m.rate for m in model.modules()
             if isinstance(m, DropPath) and m.rate > 0}
    rng = np.random.default_rng(8)
    base_rng = jax.random.PRNGKey(11)
    out = {"jm": [], "tm": [], "mix": []}

    def one_step(i, images, labels):
        nonlocal jstate, state
        r_aug, r_mix, _, _ = jax.random.split(
            jax.random.fold_in(base_rng, i), 4)
        aug = jaug.sample_augment_draws(r_aug, images.shape, jcfg.augment)
        mix = jmixing.sample_mix_draws(r_mix, BATCH, IMG, IMG, **MIX_DRAW)
        masks = {p: rng.random(BATCH) < 1.0 - r for p, r in rates.items()}
        masks_now.update((p, jnp.asarray(m)) for p, m in masks.items())
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)),
                           base_rng)
        state, tm = step(state, (_t(images), _t(labels)), StepDraws(
            _aug_draws_to_torch(aug), _mix_draws_to_torch(mix),
            DropPathMasks({p: _t(m) for p, m in masks.items()})))
        out["jm"].append({k: float(v) for k, v in jm.items()})
        out["tm"].append({k: float(v) for k, v in tm.items()})
        out["mix"].append((bool(mix.apply), bool(mix.use_cutmix)))

    data = np.random.default_rng(9)
    for i in range(STEPS):
        one_step(i, data.integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8),
                 data.integers(0, 10, BATCH))
        if i == 0:
            out["grads0"] = {k: p.grad.numpy().copy()
                             for k, p in model.named_parameters()}
            out["jmu0"] = jax_tree_to_port(_tree_np(jstate.opt_state[1][0].mu))
            out["bn0"] = ({k: v.numpy().copy()
                           for k, v in model.named_buffers()},
                          jax_tree_to_port(_tree_np(jstate.batch_stats)))
    out["params"] = ({k: p.detach().numpy().copy()
                      for k, p in model.named_parameters()},
                     jax_tree_to_port(_tree_np(jstate.params)))

    # the non-finite guard: a NaN classifier bias makes the loss NaN
    nan_params = jax.tree_util.tree_map(np.array, _tree_np(jstate.params))
    nan_params["classifier"]["bias"][0] = np.nan
    jstate = jstate.replace(params=nan_params)
    with torch.no_grad():
        model.classifier.bias[0] = float("nan")
    before = {
        "port": ({k: t.clone() for k, t in model.state_dict().items()},
                 {k: t.clone() for k, t in state.opt_state.mu.items()},
                 int(state.opt_state.count)),
        "jax": (_tree_np(jstate.params), _tree_np(jstate.batch_stats),
                _tree_np(jstate.opt_state)),
    }
    one_step(STEPS, data.integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8),
             data.integers(0, 10, BATCH))
    out["guard"] = (before, state, jstate)
    return out


def test_train_step_matches_jax_one_step(run):
    jm, tm = run["jm"][0], run["tm"][0]
    assert set(tm) == set(jm) == {"loss", "top1", "top3", "top5",
                                  "grad_norm", "clipped", "nonfinite", "lr"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    # JAX's grads from its first AdamW moment: mu = (1 - b1) * clip(g)
    gnorm = jm["grad_norm"]
    scale = max(1.0, gnorm / 1.0)
    assert jm["clipped"] == 1.0
    grads = run["grads0"]
    assert set(grads) == set(run["jmu0"])
    for k, mu in run["jmu0"].items():
        np.testing.assert_allclose(grads[k], mu / np.float32(0.1) * scale,
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    ours, theirs = run["bn0"]
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_train_trajectory_matches_jax(run):
    # the 8 steps cover both mixing branches and the apply gate
    assert {a for a, _ in run["mix"][:STEPS]} == {True, False}
    assert {c for a, c in run["mix"][:STEPS] if a} == {True, False}
    losses = [[m["loss"] for m in run[k][:STEPS]] for k in ("tm", "jm")]
    np.testing.assert_allclose(losses[0], losses[1], atol=5e-4, rtol=0)
    for k in ("top1", "lr", "clipped"):
        np.testing.assert_allclose([m[k] for m in run["tm"][:STEPS]],
                                   [m[k] for m in run["jm"][:STEPS]],
                                   atol=1e-5, err_msg=k)
    ours, theirs = run["params"]
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=2e-3, rtol=0, err_msg=k)


def test_nonfinite_guard_matches_jax(run):
    before, state, jstate = run["guard"]
    tm, jm = run["tm"][STEPS], run["jm"][STEPS]
    assert tm == jm
    assert tm["nonfinite"] == 1.0 and tm["loss"] == 0.0
    assert tm["grad_norm"] == 0.0
    params, mu, count = before["port"]
    for k, t in state.model.state_dict().items():  # params and BN stats
        torch.testing.assert_close(t, params[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    for k, t in state.opt_state.mu.items():
        torch.testing.assert_close(t, mu[k], rtol=0, atol=0, msg=k)
    assert int(state.opt_state.count) == count == STEPS
    assert state.step == STEPS + 1 == int(jstate.step)
    jparams, jstats, jopt = before["jax"]
    for a, b in ((jparams, jstate.params), (jstats, jstate.batch_stats),
                 (jopt, jstate.opt_state)):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(_tree_np(b))):
            np.testing.assert_array_equal(x, y)


def test_train_step_samples_its_own_draws_reproducibly():
    def run_twice(seed):
        model = build_model(TINY, device="cpu", seed=1)
        sched = warmup_cosine_lr(**LR)
        state = TrainState.create(model, AdamW(sched))
        step = make_train_step(StepConfig(
            num_classes=10, augment=taug.AugmentConfig(**AUG), **MIX), sched)
        g = torch.Generator().manual_seed(seed)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (BATCH, IMG, IMG, 3), np.uint8))
        y = torch.arange(BATCH) % 10
        losses = []
        for _ in range(2):
            state, m = step(state, (x, y), generator=g)
            losses.append(float(m["loss"]))
        return losses, state

    a, state = run_twice(0)
    assert a == run_twice(0)[0] and np.isfinite(a).all()
    assert state.step == 2 and int(state.opt_state.count) == 2
    with pytest.raises(ValueError, match="draws or a generator"):
        make_train_step(StepConfig(num_classes=10))(
            state, (torch.zeros(2, IMG, IMG, 3), torch.zeros(2)))
