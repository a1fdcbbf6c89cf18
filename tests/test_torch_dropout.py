"""Port parity, the model options item 10 of the port's roadmap covers:
train-mode dropout, the pool downsample, the strided outlook and the two
composite stages, against ``outgridvit_tpu`` on the CPU with the same
weights and inputs.

Dropout masks reach flax's own ``nn.Dropout`` by module path: an
``nn.intercept_methods`` interceptor names the site being called and a
stand-in for ``flax.linen.stochastic.random`` returns that site's numpy
mask from ``bernoulli``, so flax's code computes ``select(mask, x /
keep, 0)`` itself; drop-path masks are routed as in
``tests/test_torch_train.py``. The port gets the same masks by path
(``DropPathMasks(..., dropout=...)``). In training the port computes its
masks on the device (``ops/dropout.py:HashedDropout``); the superstep,
resume and remat invariants are held with those.

Bars: bitwise for the dropout function (fp32 and bf16); 1e-5 per fp32
module and for two fp32 train steps (loss, metrics, AdamW's first moment,
BN statistics), 2e-3 on the parameters after them; bf16
modules within 2e-2 of JAX's bf16; bitwise for the superstep, a resume and
remat against eager steps.
"""

import contextlib
import functools

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from outgridvit_tpu.models import blocks as jblocks
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.stage_config import DownsampleConfig as JDownCfg
from outgridvit_tpu.stage_config import StageCfg as JStageCfg
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu.utils.port_torch import port_torch_state_dict
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.models.layers import DropPath
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.dropout import HashedDropout, dropout
from outgridvit_tpu_torch.stage_config import DownsampleConfig, StageCfg
from outgridvit_tpu_torch.training.checkpoints import (
    load_checkpoint,
    save_checkpoint,
)
from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
from outgridvit_tpu_torch.training.steps import (
    DrawLayout,
    StepConfig,
    StepDraws,
    TrainSuperstep,
    make_train_step,
    sample_step_draws,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

RATES = {"attn_drop": 0.2, "proj_drop": 0.3, "ffn_drop": 0.25}
TINY_A = {
    "type": "model_a", "num_classes": 10, "stem_dim": 8, "dpr_max": 0.2,
    "downsample": {"kind": "pool"},
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2, **RATES},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4, **RATES},
    ],
}
TINY_B = dict(TINY_A, type="model_b", outlooker_front_depth=1,
              downsample={"kind": "conv"})
IMG, BATCH = 8, 4
LR = dict(base_lr=1e-3, total_steps=20, warmup_steps=2, min_lr=1e-6)


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


def _init(jmod, x, seed=0, **kw):
    """Variables of the JAX module's tree drawn from numpy (the shapes from
    ``jax.eval_shape``, no compile): weights at their fan-in scale, LN and
    BN scales near 1, biases near 0, running variances in [1, 1.5]."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), **kw)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and "var" in name:
            return (1.0 + 0.5 * rng.random(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.normal(size=s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


class _Bernoulli:
    """Stands in for ``flax.linen.stochastic.random``: ``bernoulli`` returns
    the mask of the site the interceptor names; everything else is
    ``jax.random``'s."""

    def __init__(self):
        self.masks, self.path = {}, None

    def bernoulli(self, rng, p, shape):
        mask = jnp.asarray(self.masks[self.path])
        assert tuple(mask.shape) == tuple(shape), (self.path, shape)
        return mask

    def __getattr__(self, name):
        return getattr(jax.random, name)


def _interceptor(bern, dp_masks):
    def icpt(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(mod, nn.Dropout):
            bern.path = "/".join(mod.path)
            return next_fun(*args, **kwargs)
        if isinstance(mod, jlayers.DropPath):
            x = args[0]
            det = kwargs.get("deterministic",
                             args[1] if len(args) > 1 else True)
            if mod.rate == 0.0 or det:
                return x
            keep = jnp.asarray(dp_masks["/".join(mod.path)]).astype(x.dtype)
            scale = keep * jnp.asarray(1.0 / (1.0 - mod.rate), x.dtype)
            return x * scale.reshape((-1,) + (1,) * (x.ndim - 1))
        return next_fun(*args, **kwargs)

    return icpt


@contextlib.contextmanager
def jax_masks(do_masks, dp_masks=None):
    """Run flax with these dropout (and drop-path) masks by module path."""
    bern = _Bernoulli()
    bern.masks = do_masks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_stochastic, "random", bern)
        with nn.intercept_methods(_interceptor(bern, dp_masks or {})):
            yield


def _masks(sites, rates, seed):
    """numpy keep masks for ``{path: shape}`` at ``rates[path]``."""
    rng = np.random.default_rng(seed)
    return {p: rng.random(shape) < 1.0 - rates[p]
            for p, shape in sites.items()}


def _record_sites(module, x):
    """{path: shape} of every dropout site a train forward of the port
    module (called ``module(x, masks)``) asks for; its parameters and
    statistics are left as they were."""
    rec = []
    masks = DropPathMasks(generator=torch.Generator().manual_seed(0),
                          dropout=HashedDropout(0, torch.zeros(
                              (), dtype=torch.int32), record=rec))
    saved = {k: v.clone() for k, v in module.state_dict().items()}
    with torch.no_grad():
        module.train()(x, masks)
    module.load_state_dict(saved)
    module.eval()
    return dict(rec)


def _site_rates(module, sites):
    """The rate of each site, from the module that owns it (an outlook or
    grid attention's ``Dropout_0`` is its probabilities' site when its
    ``attn_drop`` is active, as in every caller here)."""
    owners = {getattr(m, "path", None): m for m in module.modules()}
    rates = {}
    for p in sites:
        owner = owners[p.rsplit("/", 1)[0]]
        rates[p] = (owner.drop if isinstance(owner, tlayers.ChannelMLP)
                    else owner.attn_drop if p.endswith("Dropout_0")
                    else owner.proj_drop)
    return rates


# ---- the dropout function against flax's nn.Dropout ------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.25, 0.6])
def test_dropout_is_flax_dropout(dtype, rate):
    rng = np.random.default_rng(int(rate * 100))
    x = rng.normal(size=(3, 5, 7)).astype(np.float32) * 3
    mask = rng.random(x.shape) < 1.0 - rate
    fake = _Bernoulli()
    fake.masks, fake.path = {"d": mask}, "d"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_stochastic, "random", fake)
        want = np.asarray(nn.Dropout(rate, deterministic=False).apply(
            {}, jnp.asarray(x).astype(dtype),
            rngs={"dropout": jax.random.PRNGKey(0)}).astype(jnp.float32))
    tx = _t(x).to(getattr(torch, dtype))
    got = dropout(tx, _t(mask), rate)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16" and float(torch.tensor(
            1.0 - rate, dtype=torch.bfloat16)) != 1.0 - rate:
        # a division by keep rounded to bf16, not a product with 1/keep:
        # the product rounds differently at some elements
        prod = torch.where(_t(mask), (tx.float() * (1.0 / (1.0 - rate))
                                      ).to(tx.dtype), 0.0)
        assert not torch.equal(prod, got)


def test_dropout_rate_one_zero_and_eval():
    x = _t(np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32))
    masks = DropPathMasks({}, dropout={"d": torch.ones(2, 3,
                                                       dtype=torch.bool)})
    # rate 1 and rate 0 are the site's (apply_dropout), with masks or not
    assert torch.equal(tlayers.apply_dropout(x, 1.0, masks, "d", True),
                       torch.zeros_like(x))
    assert tlayers.apply_dropout(x, 0.0, masks, "d", True) is x
    jx = jnp.asarray(x.numpy())
    np.testing.assert_array_equal(np.asarray(nn.Dropout(1.0).apply(
        {}, jx, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})),
        0.0)
    # eval mode (flax deterministic) returns x; so does the port's site,
    # and a train-mode site without masks refuses
    assert tlayers.apply_dropout(x, 0.5, None, "d", training=False) is x
    assert torch.equal(tlayers.apply_dropout(x, 1.0, None, "d", True),
                       torch.zeros_like(x))
    with pytest.raises(ValueError, match="needs masks"):
        tlayers.apply_dropout(x, 0.5, None, "d", training=True)


# ---- each dropout site against the JAX module -------------------------------

def _module_parity(jmod, tmod, x, jkw, tcall, sites, rates, port_alias=(),
                   tol=1e-5, seed=0):
    """Train-mode output and input gradient (of sum(out^2)) of the JAX
    module with the sites' masks against the port module, loaded with the
    same weights, with the same masks (``port_alias``: (port site, JAX
    site) pairs, the port site taking the JAX site's mask)."""
    jx = jnp.asarray(x)
    variables = _init(jmod, x, seed, **jkw)
    load_flax_variables(tmod, variables)
    masks = _masks(sites, rates, seed + 1)

    def jfun(xx):
        with jax_masks(masks):
            return jmod.apply(variables, xx, deterministic=False, **jkw,
                              rngs={"dropout": jax.random.PRNGKey(1)})

    want = jfun(jx)
    jgrad = jax.grad(lambda xx: jnp.sum(jfun(xx) ** 2))(jx)
    port_masks = dict(masks)
    for port_site, jax_site in port_alias:
        port_masks[port_site] = masks[jax_site]
    tdp = DropPathMasks({}, dropout={p: _t(m) for p, m in port_masks.items()})
    tx = _t(x).requires_grad_(True)
    out = tcall(tmod.train(), tx, tdp)
    out.float().pow(2).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=tol,
                               rtol=tol)


OUTLOOK_CASES = {  # name: (attn_drop, proj_drop)
    "attn": (0.2, 0.0), "proj": (0.0, 0.3), "both": (0.2, 0.3)}


@pytest.mark.parametrize("mode", tblocks.OUTLOOK_MODES)
@pytest.mark.parametrize("case", list(OUTLOOK_CASES))
def test_outlook_attention_dropout_matches_jax(mode, case):
    attn_drop, proj_drop = OUTLOOK_CASES[case]
    B, H, C, heads = 2, 6, 16, 2
    x = np.random.default_rng(3).normal(size=(B, H, H, C)).astype(np.float32)
    jmod = jblocks.OutlookAttention2d(dim=C, num_heads=heads,
                                      attn_drop=attn_drop,
                                      proj_drop=proj_drop, use_pallas=False)
    tmod = tblocks.OutlookAttention2d(C, heads, 3, mode=mode,
                                      attn_drop=attn_drop,
                                      proj_drop=proj_drop)
    sites = {"Dropout_0": (B, H, H, heads, 9), "Dropout_1": (B, H, H, C)}
    rates = {"Dropout_0": attn_drop, "Dropout_1": proj_drop}
    # #9's path (proj_drop alone) creates no probability dropout, so its
    # projection dropout is Dropout_0, as in JAX's fused branch
    alias = ((("Dropout_0", "Dropout_1"),) if mode == "fused_outlook"
             and attn_drop == 0.0 else ())
    _module_parity(jmod, tmod, x, {}, lambda m, xx, dp: m(xx, dp), sites,
                   rates, alias)


def _site_names(tmod):
    for name, m in tmod.named_modules():
        if hasattr(m, "path"):
            m.path = name.replace(".", "/")


@pytest.mark.parametrize("xla", [False, True], ids=["kernel", "xla"])
@pytest.mark.parametrize("case", list(OUTLOOK_CASES))
@pytest.mark.parametrize("grid,H", [(4, 8), (1, 8)], ids=["n4", "n64"])
def test_grid_attention_dropout_matches_jax(xla, case, grid, H):
    attn_drop, proj_drop = OUTLOOK_CASES[case]
    B, C, heads = 2, 16, 2
    N = (H // grid) ** 2
    x = np.random.default_rng(4).normal(size=(B, H, H, C)).astype(np.float32)
    ln = (np.random.default_rng(5).normal(size=C).astype(np.float32) * 0.1
          + 1.0, np.random.default_rng(6).normal(size=C).astype(np.float32)
          * 0.1)
    jmod = jblocks.GridAttention2D(dim=C, num_heads=heads, grid_size=grid,
                                   attn_drop=attn_drop, proj_drop=proj_drop,
                                   use_pallas=False)
    tmod = tblocks.GridAttention2D(C, heads, grid, xla=xla,
                                   attn_drop=attn_drop, proj_drop=proj_drop)
    _site_names(tmod)
    tln = tlayers.LayerNorm(C, 1e-5)
    with torch.no_grad():
        tln.weight.copy_(_t(ln[0]))
        tln.bias.copy_(_t(ln[1]))
    G = B * grid * grid
    sites = {"mhsa/Dropout_0": (G, heads, N, N),
             "mhsa/Dropout_1": (B, H, H, C)}
    rates = {"mhsa/Dropout_0": attn_drop, "mhsa/Dropout_1": proj_drop}
    # the kernel paths (proj_drop alone) name the output's site Dropout_0
    alias = ((("mhsa/Dropout_0", "mhsa/Dropout_1"),)
             if not xla and attn_drop == 0.0 else ())
    _module_parity(jmod, tmod, x,
                   {"ln": (jnp.asarray(ln[0]), jnp.asarray(ln[1]), 1e-5)},
                   lambda m, xx, dp: m(xx, tln, dp), sites, rates, alias)


@pytest.mark.parametrize("xla", [False, True], ids=["kernel", "xla"])
def test_channel_mlp_dropout_matches_jax(xla):
    B, H, C = 2, 4, 16
    x = np.random.default_rng(7).normal(size=(B, H, H, C)).astype(np.float32)
    jmod = jlayers.ChannelMLP(dim=C, mlp_ratio=2.0, drop=0.25,
                              use_pallas=False)
    tmod = tlayers.ChannelMLP(C, 2.0, xla=xla, drop=0.25)
    sites = {"Dropout_0": (B, H, H, 2 * C), "Dropout_1": (B, H, H, C)}
    rates = dict.fromkeys(sites, 0.25)
    _module_parity(jmod, tmod, x, {}, lambda m, xx, dp: m(xx, None, dp),
                   sites, rates)


# ---- the kernel-or-plain dispatch under each rate alone ---------------------

SPIED = {"grid": (tblocks, "grid_mhsa_autograd"),
         "branch": (tblocks, "attn_branch_autograd"),
         "packed": (tblocks, "grid_mhsa_packed_autograd"),
         "agg": (tblocks, "outlook_agg_proj_autograd"),
         "agg_v": (tblocks, "outlook_branch_autograd"),
         "softmax": (tblocks, "outlook_softmax_autograd"),
         "mlp": (tlayers, "mlp_branch_autograd")}


@pytest.mark.parametrize("mode", ["fused_agg", "fused_agg_v",
                                  "fused_outlook"])
@pytest.mark.parametrize("rate", ["attn_drop", "proj_drop", "ffn_drop",
                                  "eval"])
def test_dispatch_under_each_rate_alone(monkeypatch, mode, rate):
    calls = dict.fromkeys(SPIED, 0)
    for key, (mod, name) in SPIED.items():
        fn = getattr(mod, name)

        def spy(*a, key=key, fn=fn, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    stages = [{k: v for k, v in s.items() if k not in RATES}
              for s in TINY_A["stages"]]
    if rate != "eval":
        stages = [dict(s, **{rate: 0.2}) for s in stages]
    else:
        stages = [dict(s, **RATES) for s in stages]
    # stage 0 at 16 px has grids of N = 16; stage 1 N = 4 ("t")
    model = build_model(dict(TINY_A, stages=stages, use_pallas=mode,
                             dpr_max=0.0), device="cpu")
    x = torch.randn(2, 16, 16, 3)
    masks = DropPathMasks({}, dropout=HashedDropout(
        0, torch.zeros((), dtype=torch.int32)))
    with torch.no_grad():
        (model.eval() if rate == "eval" else model.train())(x, masks)
    value = {"fused_agg": "agg", "fused_agg_v": "agg_v",
             "fused_outlook": "softmax"}[mode]
    want = {"grid": 2, "mlp": 4, value: 2}  # 2 blocks, 2 MLPs each
    if rate == "attn_drop":  # the grid core and #9 off, #7 / #8 stay
        want["grid"] = 0
        if mode == "fused_outlook":
            want[value] = 0
    if rate == "ffn_drop":  # every MLP unfused
        want["mlp"] = 0
    assert calls == {k: want.get(k, 0) for k in SPIED}, calls


# ---- eval mode: the rates change nothing, on every path ---------------------

def _eval_masks(with_masks):
    return (DropPathMasks({}, dropout=HashedDropout(
        0, torch.zeros((), dtype=torch.int32))) if with_masks else None)


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["no_masks", "masks"])
@pytest.mark.parametrize("grid", [4, 1], ids=["n4", "n64"])
def test_xla_attention_eval_is_dropout_free(grid, with_masks):
    # the plain einsum path (use_pallas: false) in eval mode is flax's
    # deterministic Dropout: x, with or without masks
    B, H, C, heads = 2, 8, 16, 2
    x = _t(np.random.default_rng(8).normal(size=(B, H, H, C)).astype(
        np.float32))
    ln = tlayers.LayerNorm(C, 1e-5)
    drop = tblocks.GridAttention2D(C, heads, grid, xla=True, attn_drop=0.2,
                                   proj_drop=0.3)
    clean = tblocks.GridAttention2D(C, heads, grid, xla=True)
    clean.load_state_dict(drop.state_dict())
    _site_names(drop)
    with torch.no_grad():
        got = drop.eval()(x, ln, _eval_masks(with_masks))
        want = clean.eval()(x, ln)
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["no_masks", "masks"])
@pytest.mark.parametrize("use_pallas", [False, "fused_agg"],
                         ids=["xla", "fused_agg"])
@pytest.mark.parametrize("cfg", [TINY_A, TINY_B], ids=["model_a", "model_b"])
def test_eval_logits_are_dropout_free(cfg, use_pallas, with_masks):
    clean = dict(cfg, use_pallas=use_pallas, stages=[
        {k: v for k, v in st.items() if k not in RATES}
        for st in cfg["stages"]])
    drop = build_model(dict(cfg, use_pallas=use_pallas), device="cpu",
                       seed=3)
    base = build_model(clean, device="cpu", seed=3)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = drop.eval()(x, _eval_masks(with_masks))
        want = base.eval()(x)
    assert torch.equal(got, want)


# ---- train steps of tiny Model A and Model B against the JAX step ----------

def _step_pair(cfg, steps=2):
    """``steps`` fp32 train steps of the tiny model through the JAX step and
    the port's on the same state, batches and masks (dropout at every site,
    drop-path)."""
    jmodel = jax_build_model(cfg, use_pallas=False)
    variables = _init(jmodel, np.zeros((1, IMG, IMG, 3), np.float32))
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    sites = _record_sites(model, torch.zeros(BATCH, IMG, IMG, 3))
    site_rate = _site_rates(model, sites)
    dp_rates = {m.path: m.rate for m in model.modules()
                if isinstance(m, DropPath) and m.rate > 0}
    now = {"do": {}, "dp": {}}

    @functools.partial(jax.jit, static_argnames=("train", "mutable"))
    def japply(variables, x, do, dp, rngs, train, mutable):
        with jax_masks(do, dp):
            return jmodel.apply(variables, x, train=train, mutable=mutable,
                                rngs=rngs)

    def apply_fn(variables, x, train, mutable, rngs):
        return japply(variables, x, now["do"], now["dp"], rngs, train,
                      tuple(mutable))

    tx = make_optimizer(jax_schedule(**LR), 0.05, 1.0)
    jstate = JaxTrainState.create(apply_fn=apply_fn,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=tx)
    jstep = jax_train_step(JaxStepConfig(num_classes=10), jax_schedule(**LR),
                           jit=False)
    state = TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05,
                                           1.0))
    step = make_train_step(StepConfig(num_classes=10), warmup_cosine_lr(**LR))
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps):
        images = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
        labels = rng.integers(0, 10, BATCH)
        now["do"] = {p: jnp.asarray(m) for p, m in _masks(
            sites, site_rate, 100 + i).items()}
        now["dp"] = {p: jnp.asarray(rng.random(BATCH) < 1.0 - r)
                     for p, r in dp_rates.items()}
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)),
                           jax.random.PRNGKey(5))
        state, tm = step(state, (_t(images), _t(labels)), StepDraws(
            None, None, DropPathMasks(
                {p: _t(np.asarray(m)) for p, m in now["dp"].items()},
                dropout={p: _t(np.asarray(m))
                         for p, m in now["do"].items()})))
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()}))
    return out, state, jstate, sites


@pytest.mark.parametrize("cfg", [TINY_A, TINY_B], ids=["model_a", "model_b"])
def test_dropout_train_steps_match_jax(cfg):
    out, state, jstate, sites = _step_pair(cfg)
    kinds = {p.rsplit("/", 2)[-2] + "/" + p.rsplit("/", 1)[-1]
             for p in sites}
    assert {"attn/Dropout_0", "attn/Dropout_1", "mhsa/Dropout_0",
            "mhsa/Dropout_1", "mlp/Dropout_0", "mlp/Dropout_1"} <= kinds
    for jm, tm in out:
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    # the gradients through AdamW's first moment (0.1 x the clipped
    # gradient, summed over the steps); the parameters within the repo's
    # 2e-3 bar, as AdamW scales near-zero gradients (a key bias) up
    mu = jax_tree_to_port(_tree_np(jstate.opt_state[1][0].mu))
    for k, m in state.opt_state.mu.items():
        np.testing.assert_allclose(m.numpy(), mu[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    theirs = jax_tree_to_port(_tree_np(jstate.params))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[k], atol=2e-3,
                                   rtol=0, err_msg=k)
    stats = jax_tree_to_port(_tree_np(jstate.batch_stats))
    for k, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)


# ---- the pool downsample ---------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("train", [False, True])
def test_pool_downsample_matches_jax(dtype, tol, train):
    x = np.random.default_rng(8).normal(size=(2, 8, 8, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jlayers.Downsample(16, 32, JDownCfg(kind="pool"), dtype=jdt)
    variables = _init(jmod, x)
    want, _ = jmod.apply(variables, jnp.asarray(x).astype(jdt), train=train,
                         mutable=["batch_stats"])
    tmod = tlayers.Downsample(16, 32, DownsampleConfig(kind="pool"),
                              dtype=tdt)
    load_flax_variables(_Wrap(tmod, "downs_0"),
                        {c: {"downs_0": t} for c, t in variables.items()})
    with torch.no_grad():
        got = tmod.train(train)(_t(x).to(tdt))
    assert tuple(got.shape) == (2, 4, 4, 32) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


class _Wrap(torch.nn.Module):
    """A module under the torch name ``downs.0`` (the bridge's rename
    target for ``downs_0``)."""

    def __init__(self, mod, name):
        super().__init__()
        self.downs = torch.nn.ModuleList([mod])


@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_downsample_kinds_roundtrip(kind):
    """JAX -> port -> JAX (``port_torch_state_dict``, strict) is exact for
    both kinds; the pool kind's logits are held by the train-step test."""
    cfg = dict(TINY_A, downsample={"kind": kind}, dpr_max=0.0)
    jmodel = jax_build_model(cfg, use_pallas=False)
    variables = _init(jmodel, np.zeros((1, 16, 16, 3), np.float32))
    port = load_flax_variables(build_model(cfg, device="cpu"), variables)
    conv = port.downs[0].op[0]
    assert isinstance(conv, tlayers.Dense if kind == "pool"
                      else tlayers.ConvNHWC)
    back = port_torch_state_dict(port.state_dict(), variables, strict=True)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


# ---- the strided outlook ---------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "fused_agg", "fused_outlook"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_strided_outlook_matches_jax(mode, dtype, tol):
    B, H, C, heads = 2, 8, 16, 2
    x = np.random.default_rng(10).normal(size=(B, H, H, C)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jblocks.OutlookAttention2d(dim=C, num_heads=heads, stride=2,
                                      use_pallas=False, dtype=jdt)
    variables = _init(jmod, x)
    want = jmod.apply(variables, jnp.asarray(x).astype(jdt))
    tmod = tblocks.OutlookAttention2d(C, heads, 3, dtype=tdt, mode=mode,
                                      stride=2)
    with torch.no_grad():
        for name in ("attn", "v", "proj"):
            getattr(tmod, name).weight.copy_(
                _t(variables["params"][name]["kernel"]).t())
            getattr(tmod, name).bias.copy_(
                _t(variables["params"][name]["bias"]))
        got = tmod(_t(x).to(tdt))
    assert tuple(got.shape) == (B, H // 2, H // 2, C)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_strided_outlook_dropout_matches_jax():
    B, H, C, heads = 2, 8, 16, 2
    x = np.random.default_rng(11).normal(size=(B, H, H, C)).astype(
        np.float32)
    jmod = jblocks.OutlookAttention2d(dim=C, num_heads=heads, stride=2,
                                      attn_drop=0.2, proj_drop=0.3,
                                      use_pallas=False)
    tmod = tblocks.OutlookAttention2d(C, heads, 3, mode="fused_agg", stride=2,
                                      attn_drop=0.2, proj_drop=0.3)
    sites = {"Dropout_0": (B, 4, 4, heads, 9), "Dropout_1": (B, 4, 4, C)}
    _module_parity(jmod, tmod, x, {}, lambda m, xx, dp: m(xx, dp), sites,
                   {"Dropout_0": 0.2, "Dropout_1": 0.3})


def test_strided_outlook_fails_where_jax_fails():
    C, heads = 8, 2
    # odd H: the VALID pool gives H // 2, the aggregate (H - 1) // 2 + 1
    x = np.ones((1, 7, 7, C), np.float32)
    jmod = jblocks.OutlookAttention2d(dim=C, num_heads=heads, stride=2,
                                      use_pallas=False)
    with pytest.raises(ValueError, match="inconsistent"):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="inconsistent"):
        tblocks.OutlookAttention2d(C, heads, stride=2)(_t(x))
    # the outlooker block's residual cannot add the strided output
    x = np.ones((1, 8, 8, C), np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jblocks.OutlookerBlock2d(dim=C, num_heads=heads, stride=2,
                                 use_pallas=False).init(
            jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="residual"):
        tblocks.OutlookerBlock2d(C, heads, stride=2)(_t(x))
    with pytest.raises(ValueError, match="stride"):
        tblocks.OutlookAttention2d(C, heads, stride=0)


# ---- the composite stages ----------------------------------------------------

STAGE = dict(dim=16, depth=2, num_heads=2, grid_size=4, outlook_heads=2,
             drop_path=0.1, **RATES)


def _stage_pair(kind, depth=2):
    jcfg, tcfg = JStageCfg(**STAGE), StageCfg(**STAGE)
    if kind == "maxout":
        jmod = jblocks.MaxOutStage(cfg=jcfg, depth=depth, use_pallas=False)
        tmod = tblocks.MaxOutStage(tcfg, depth)
    else:
        jmod = jblocks.StageOutThenGrid(cfg=jcfg, depth=depth, out_depth=2,
                                        use_pallas=False)
        tmod = tblocks.StageOutThenGrid(tcfg, depth, out_depth=2)
    return jmod, tmod


@pytest.mark.parametrize("kind", ["maxout", "out_then_grid"])
def test_composite_stage_matches_jax(kind):
    jmod, tmod = _stage_pair(kind)
    x = np.random.default_rng(12).normal(size=(BATCH, IMG, IMG, 16)).astype(
        np.float32)
    variables = _init(jmod, x)
    tops = sorted(variables["params"])
    assert tops == (["blocks_0", "blocks_1"] if kind == "maxout" else
                    ["blocks_0", "blocks_1", "outlookers_0", "outlookers_1"])
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod.eval()(_t(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)

    # train mode: batch statistics, drop-path and dropout by path
    sites = _record_sites(tmod, _t(x))
    rates = _site_rates(tmod, sites)
    do = _masks(sites, rates, 13)
    rng = np.random.default_rng(14)
    dp = {m.path: rng.random(BATCH) < 0.9 for m in tmod.modules()
          if isinstance(m, DropPath) and m.rate > 0}
    with jax_masks(do, dp):
        want, _ = jmod.apply(variables, jnp.asarray(x), train=True,
                             deterministic=False, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(1),
                                   "droppath": jax.random.PRNGKey(2)})
    with torch.no_grad():
        got = tmod.train()(_t(x), DropPathMasks(
            {p: _t(m) for p, m in dp.items()},
            dropout={p: _t(m) for p, m in do.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---- superstep, resume and remat with dropout on ----------------------------

CPU_A = dict(TINY_A, dpr_max=0.2)


def _state(cfg=CPU_A, seed=0):
    model = build_model(cfg, device="cpu", seed=seed)
    return TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05, 1.0))


def _snapshot(state):
    out = {f"model.{k}": v.clone() for k, v in
           state.model.state_dict().items()}
    out.update((f"mu.{k}", v.clone()) for k, v in state.opt_state.mu.items())
    out.update((f"nu.{k}", v.clone()) for k, v in state.opt_state.nu.items())
    out["count"] = state.opt_state.count.clone()
    out["device_step"] = state.device_step.clone()
    return out


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad[:10]


def _batches(n, seed=15):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, BATCH, 16, 16, 3, generator=g),
            torch.randint(0, 10, (n, BATCH), generator=g))


def test_superstep_with_dropout_is_k_eager_steps():
    cfg = StepConfig(num_classes=10)
    x, y = _batches(2)
    eager = _state()
    step = make_train_step(cfg, warmup_cosine_lr(**LR))
    ms = []
    for i in range(2):
        eager, m = step(eager, (x[i], y[i]), seed=21)
        ms.append(m)
    sup = TrainSuperstep(cfg, warmup_cosine_lr(**LR), k=2)
    graph, gm = sup(_state(), (x, y), seed=21)
    _assert_bitwise(_snapshot(graph), _snapshot(eager))
    for k in gm:
        assert torch.equal(gm[k], torch.stack([m[k] for m in ms])), k
    assert graph.step == eager.step == 2
    # the draws' buffer holds the K steps' [B] drop-path masks only: no
    # element-sized dropout mask crosses from the host
    prep = next(iter(sup.prepared.values()))
    assert prep.layout.slots and all(
        key[0] == "drop" and shape == (BATCH,)
        for key, shape, *_ in prep.layout.slots)
    # another seed is another set of masks: another graph
    sup(graph, (x, y), seed=22)
    assert len(sup.prepared) == 2


def test_resume_with_dropout_is_an_uninterrupted_run(tmp_path):
    cfg = StepConfig(num_classes=10)
    step = make_train_step(cfg, warmup_cosine_lr(**LR))
    x, y = _batches(3)
    full = _state()
    for i in range(3):
        full, _ = step(full, (x[i], y[i]), seed=5)
    part = _state()
    part, _ = step(part, (x[0], y[0]), seed=5)
    save_checkpoint(str(tmp_path / "c.ckpt"), part, epoch=0)
    resumed = _state(seed=99)  # other weights, overwritten by the load
    resumed = load_checkpoint(str(tmp_path / "c.ckpt"), resumed)["state"]
    assert resumed.step == 1 and int(resumed.device_step) == 1
    for i in (1, 2):
        resumed, _ = step(resumed, (x[i], y[i]), seed=5)
    _assert_bitwise(_snapshot(resumed), _snapshot(full))


class _Recording(HashedDropout):
    """A HashedDropout that keeps each mask it makes, by path."""

    def __init__(self, seed, step):
        super().__init__(seed, step)
        self.log = []

    def keep(self, path, rate, shape, device):
        mask = super().keep(path, rate, shape, device)
        self.log.append((path, mask))
        return mask


def test_remat_recompute_reproduces_dropout_masks():
    cfg = StepConfig(num_classes=10)
    step = make_train_step(cfg, warmup_cosine_lr(**LR))
    x, y = _batches(1)
    results, records = {}, {}
    for remat in (None, "nothing"):
        mcfg = CPU_A if remat is None else dict(CPU_A, remat=remat)
        st = _state(mcfg)
        draws = sample_step_draws(torch.Generator().manual_seed(3), cfg,
                                  tuple(x[0].shape))
        draws.drop_masks.dropout = _Recording(7, st.device_step)
        st, m = step(st, (x[0], y[0]), draws)
        results[remat] = (_snapshot(st), m)
        records[remat] = draws.drop_masks.dropout.log
    _assert_bitwise(results["nothing"][0], results[None][0])
    # the recompute asked every site again and got its forward's mask
    plain = dict(records[None])
    assert len(records[None]) == len(plain)
    seen = {}
    for path, mask in records["nothing"]:
        assert torch.equal(mask, plain[path]), path
        seen[path] = seen.get(path, 0) + 1
    assert seen and set(seen.values()) == {2}


def test_hashed_masks_are_a_function_of_seed_step_site_and_index():
    step = torch.zeros((), dtype=torch.int32)
    src = HashedDropout(3, step)
    shape = (64, 128, 16)
    a = src.keep("a/Dropout_0", 0.1, shape, "cpu")
    assert a.dtype == torch.bool and tuple(a.shape) == shape
    assert torch.equal(a, HashedDropout(3, step.clone()).keep(
        "a/Dropout_0", 0.1, shape, "cpu"))
    assert abs(a.float().mean().item() - 0.9) < 3e-3
    # a prefix of a larger site's mask: the index is the flat element index
    big = src.keep("a/Dropout_0", 0.1, (2 * 64 * 128 * 16,), "cpu")
    assert torch.equal(big[:a.numel()], a.reshape(-1))
    others = [src.keep("a/Dropout_1", 0.1, shape, "cpu"),
              HashedDropout(4, step).keep("a/Dropout_0", 0.1, shape, "cpu")]
    step += 1
    others.append(src.keep("a/Dropout_0", 0.1, shape, "cpu"))
    for o in others:
        agree = (o == a).float().mean().item()
        assert abs(agree - (0.9 ** 2 + 0.1 ** 2)) < 5e-3  # independent
    assert abs(src.keep("x", 0.5, shape, "cpu").float().mean().item()
               - 0.5) < 3e-3


def test_drawlayout_unchanged_by_dropout():
    cfg = StepConfig(num_classes=10)
    g = torch.Generator().manual_seed(0)
    with_do = sample_step_draws(g, cfg, (BATCH, 16, 16, 3),
                                drop_order=[("stages_0_0/dp2", 0.1)])
    with_do.drop_masks.dropout = HashedDropout(
        0, torch.zeros((), dtype=torch.int32))
    plain = sample_step_draws(torch.Generator().manual_seed(0), cfg,
                              (BATCH, 16, 16, 3),
                              drop_order=[("stages_0_0/dp2", 0.1)])
    assert DrawLayout(with_do, 2).slots == DrawLayout(plain, 2).slots
