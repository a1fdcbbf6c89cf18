"""Port parity, per-block rematerialization (``outgridvit_tpu_torch/models/
rematerialize.py`` against ``outgridvit_tpu/models/rematerialize.py``;
CPU, fp32, tiny models of ``tests/test_experiments.py``'s widths at 8 px
with drop-path rates above 0).

- One train step with each policy (``nothing``, ``dots``,
  ``dots_no_batch``), Model A and Model B, is bitwise the port's step
  without remat: loss, parameters, BatchNorm statistics, AdamW moments
  and count; the K = 2 train superstep with remat is bitwise two eager
  remat steps.
- The same step against the JAX step with the same policy (masks
  injected into flax): loss, grad norm, gradients and BatchNorm statistics
  within the step tolerance of ``docs/PARITY.md`` (1e-5).
- A recompute draws no drop-path mask and records none (the warm-up's
  order has no duplicate), and updates no BatchNorm statistic; the
  selective policies cache only products.
- The policy names, the ``ValueError`` for an unknown one and the falsy
  YAML values as ``tests/test_remat.py`` holds them for JAX.
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
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import rematerialize as rm
from outgridvit_tpu_torch.models.blocks import OutGridBlock
from outgridvit_tpu_torch.models.layers import BatchNorm, DropPath
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks, draw_drop_masks
from outgridvit_tpu_torch.training.optim import AdamW
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    StepDraws,
    TrainSuperstep,
    make_train_step,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

STAGES = [
    {"dim": 8, "depth": 2, "num_heads": 2, "grid_size": 2,
     "outlook_heads": 2, "mlp_ratio": 2.0, "mbconv_expand_ratio": 2.0},
    {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
     "outlook_heads": 2, "mlp_ratio": 2.0, "mbconv_expand_ratio": 2.0},
]
CFGS = {
    "a": {"type": "model_a", "num_classes": 10, "stem_dim": 8,
          "dpr_max": 0.3, "stages": STAGES},
    "b": {"type": "model_b", "num_classes": 10, "stem_dim": 8,
          "outlooker_front_depth": 2, "dpr_max": 0.3, "stages": STAGES},
}
POLICIES = ("nothing", "dots", "dots_no_batch")
IMG, BATCH = 8, 4
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models' steps are many small ops: one intra-op thread keeps
    them fast when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    return x, rng.integers(0, 10, BATCH)


def _state(model_key, remat=None, xla=False):
    cfg = dict(CFGS[model_key])
    if remat is not None:
        cfg["remat"] = remat
    if xla:
        cfg["use_pallas"] = False
    return TrainState.create(build_model(cfg, device="cpu", seed=1),
                             AdamW(LR, 0.05, 1.0))


def _tensors(state):
    """Every tensor a step changes, by name."""
    out = dict(state.model.state_dict())
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    out["count"] = state.opt_state.count
    out["device_step"] = state.device_step
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, bad


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model_key", ["a", "b"])
def test_remat_step_is_bitwise_the_step_without_remat(model_key, policy):
    x, y = _batch()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    step = make_train_step(StepConfig(10))
    base, bm = step(_state(model_key), batch, seed=3)
    state = _state(model_key, policy)
    assert state.model.remat == policy
    state, m = step(state, batch, seed=3)
    _assert_bitwise(base, state)
    for k in bm:
        assert torch.equal(bm[k], m[k]), k
    # the step really recomputed: BN statistics moved once, not twice
    stem = state.model.stem.stem[1].running_mean
    assert not torch.equal(stem, torch.zeros_like(stem))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model_key", ["a", "b"])
def test_remat_superstep_is_bitwise_k_eager_remat_steps(model_key, policy):
    rng = np.random.default_rng(5)
    images = torch.from_numpy(
        rng.standard_normal((2, BATCH, IMG, IMG, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (2, BATCH)))
    cfg = StepConfig(10)
    eager = _state(model_key, policy)
    step = make_train_step(cfg)
    ms = []
    for i in range(2):
        eager, m = step(eager, (images[i], labels[i]), seed=11)
        ms.append(m)
    graph = _state(model_key, policy)
    graph, gm = TrainSuperstep(cfg, k=2)(graph, (images, labels), seed=11)
    _assert_bitwise(eager, graph)
    for k in gm:
        assert torch.equal(gm[k], torch.stack([m[k] for m in ms])), k


def test_recompute_draws_and_records_no_mask_and_moves_no_statistic(
        monkeypatch):
    """Under remat the forward's DropPaths draw once each: the recorded
    order is the order without remat, with no duplicate, so the superstep's
    draw_drop_masks takes it; a recompute reads the masks drawn and leaves
    the BatchNorm statistics."""
    x, y = _batch()
    orders, calls = {}, {"block": 0, "again": 0, "bn_update": 0}
    real_block = OutGridBlock.forward
    real_get = DropPathMasks.get
    real_bn = BatchNorm.forward

    def block(self, *a):
        calls["block"] += 1
        return real_block(self, *a)

    def get(self, *a, again=False):
        calls["again"] += again
        return real_get(self, *a, again=again)

    def bn(self, x):
        calls["bn_update"] += self.training and not rm.recomputing()
        return real_bn(self, x)

    monkeypatch.setattr(OutGridBlock, "forward", block)
    monkeypatch.setattr(DropPathMasks, "get", get)
    monkeypatch.setattr(BatchNorm, "forward", bn)
    counts = {}
    for remat in (None, "nothing"):
        for k in calls:
            calls[k] = 0
        model = _state("a", remat).model.train()
        order = []
        masks = DropPathMasks(generator=torch.Generator().manual_seed(0),
                              record=order)
        loss = model(torch.from_numpy(x), masks).square().mean()
        loss.backward()
        orders[remat] = order
        counts[remat] = dict(calls)
    assert orders["nothing"] == orders[None]
    assert len({p for p, _ in orders[None]}) == len(orders[None]) > 0
    draw_drop_masks(torch.Generator(), orders["nothing"], BATCH)
    n_blocks = sum(s["depth"] for s in STAGES)
    assert counts[None] == {"block": n_blocks, "again": 0,
                            "bn_update": counts[None]["bn_update"]}
    # each block ran again in the backward, read its masks again, and
    # updated no statistic there
    assert counts["nothing"]["block"] == 2 * n_blocks
    assert counts["nothing"]["again"] == len(orders[None])
    assert counts["nothing"]["bn_update"] == counts[None]["bn_update"]


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_selective_policies_cache_only_products(policy):
    """What the selective checkpoint caches of one block: the products the
    JAX policy saves (dots: every dot and convolution; dots_no_batch: the
    dots without batch dimensions), never an allocation a launch writes
    into."""
    seen = []
    policy_fn = rm.remat_policy(policy)

    def spy(ctx, op, *args, **kwargs):
        decision = policy_fn(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            seen.append(op)
        return decision

    block = _state("a").model.stages[0][0].train()
    x = torch.randn(BATCH, IMG, IMG, 8, requires_grad=True)
    masks = DropPathMasks(generator=torch.Generator().manual_seed(0))
    out = torch.utils.checkpoint.checkpoint(
        lambda t: block(t, masks), x, use_reentrant=False,
        context_fn=functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            spy))
    out.sum().backward()
    aten = torch.ops.aten
    assert seen and set(seen) <= rm._POLICIES[policy]
    assert aten.addmm.default in seen
    if policy == "dots":
        assert aten.convolution.default in seen and aten.bmm.default in seen
    else:
        assert aten.bmm.default not in seen
        assert aten.convolution.default not in seen


def test_remat_policy_names():
    assert rm.remat_policy("nothing") is None
    aten = torch.ops.aten
    for name, saved, recomputed in (
            ("dots", aten.bmm.default, aten.exp.default),
            (" DOTS_no_batch ", aten.addmm.default, aten.bmm.default)):
        policy = rm.remat_policy(name)
        assert policy(None, saved) == \
            torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
        assert policy(None, recomputed) == \
            torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="Unknown remat policy"):
        rm.remat_policy("bogus")
    with pytest.raises(ValueError, match="Unknown remat policy"):
        build_model(dict(CFGS["a"], remat="bogus"), device="meta")


def test_remat_yaml_falsy_forces_off(monkeypatch):
    """A falsy YAML remat key resolves to 'off' (no checkpoint), an absent
    key to None; OUTGRIDVIT_REMAT is not read."""
    used = []
    real = rm.checkpoint
    monkeypatch.setattr(rm, "checkpoint",
                        lambda *a, **k: used.append(1) or real(*a, **k))
    monkeypatch.setenv("OUTGRIDVIT_REMAT", "dots")
    x = torch.from_numpy(_batch()[0])

    def checkpoints(cfg):
        used.clear()
        model = build_model(dict(cfg, dpr_max=0.0), device="cpu").train()
        model(x).sum().backward()
        return model.remat, len(used)

    assert checkpoints(CFGS["a"]) == (None, 0)
    for off in (False, "", 0, None, "off", "none", "0"):
        remat, n = checkpoints(dict(CFGS["a"], remat=off))
        assert n == 0 and remat == ("off" if not off else off), off
    # one checkpoint a block: Model A's blocks, Model B's front and blocks
    assert checkpoints(dict(CFGS["a"], remat="nothing")) == ("nothing", 3)
    assert checkpoints(dict(CFGS["b"], remat="dots")) == ("dots", 5)
    # a no-grad forward checkpoints nothing
    used.clear()
    with torch.no_grad():
        build_model(dict(CFGS["b"], remat="dots"), device="cpu")(x)
    assert not used


# ---- against the JAX step with the same policy ----------------------------

def _inject_masks(masks):
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


@pytest.mark.parametrize("model_key,policy", [
    ("a", "nothing"), ("a", "dots"), ("a", "dots_no_batch"),
    ("b", "nothing")])
def test_remat_step_matches_the_jax_remat_step(model_key, policy):
    cfg = dict(CFGS[model_key], remat=policy)
    jmodel = jax_build_model(cfg, use_pallas=False)
    assert jmodel.remat == policy
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, IMG, IMG, 3)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = load_flax_variables(
        build_model(dict(cfg, use_pallas=False), device="cpu"), variables)
    rng = np.random.default_rng(7)
    masks = {m.path: rng.random(BATCH) < 1.0 - m.rate
             for m in model.modules() if isinstance(m, DropPath) and m.rate}
    assert len(masks) >= 4

    @functools.partial(jax.jit, static_argnames=("train", "mutable"))
    def japply(variables, x, train, mutable, rngs):
        with nn.intercept_methods(_inject_masks(
                {p: jnp.asarray(m) for p, m in masks.items()})):
            return jmodel.apply(variables, x, train=train,
                                mutable=list(mutable), rngs=rngs)

    jstate = JaxTrainState.create(
        apply_fn=lambda v, x, train, mutable, rngs: japply(
            v, x, train, tuple(mutable), rngs),
        params=variables["params"], batch_stats=variables["batch_stats"],
        tx=make_optimizer(LR, 0.05, 1.0))
    x, y = _batch(3)
    jstate, jm = jax_train_step(JaxStepConfig(num_classes=10), jit=False)(
        jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(0))
    state = TrainState.create(model, AdamW(LR, 0.05, 1.0))
    state, tm = make_train_step(StepConfig(10))(
        state, (torch.from_numpy(x), torch.from_numpy(y)),
        StepDraws(drop_masks=DropPathMasks(
            {p: torch.from_numpy(m) for p, m in masks.items()})))
    for k in ("loss", "top1", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # JAX's grads from its first AdamW moment: mu = (1 - b1) * clip(g); the
    # parameters after one AdamW step are ill-conditioned where a grad is
    # ~0 (a key bias), so the grads are held instead
    scale = max(1.0, float(jm["grad_norm"]) / 1.0)
    mu = jax_tree_to_port(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state[1][0].mu))
    grads = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    assert set(grads) == set(mu)
    for k, m in mu.items():
        np.testing.assert_allclose(grads[k], m / np.float32(0.1) * scale,
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    stats = jax_tree_to_port(jax.tree_util.tree_map(np.asarray,
                                                    jstate.batch_stats))
    sd = state.model.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
