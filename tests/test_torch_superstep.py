"""Port parity, the K-step train superstep: ``outgridvit_tpu_torch.training.
steps.TrainSuperstep`` on the CPU against K ``make_train_step`` calls and
against ``outgridvit_tpu``'s ``make_train_superstep`` (fp32, tiny model).

- A step's draws drawn before the step (augment, mix and drop-path masks in
  the order the forward records) are bitwise those the in-forward path
  draws for the same ``(seed, step)``, and so is the step they drive.
- The CPU superstep (warm-up from a snapshot, the draws through one flat
  buffer, K eager steps) is bitwise K single steps, also for a group with
  a non-finite step in the middle.
- ``lr`` reads the device step: ``warmup_cosine_lr(state.step)`` across a
  checkpoint and a resume, which restore the device step from the host
  one.
- Against the JAX scan (``jit=False``) over K = 3 steps fed the draws the
  scan derives (``fold_in(base_rng, state.step)``) and one drop-path mask
  set (the scan traces its body once): ``tests/test_torch_train.py``'s
  trajectory bars, 5e-4 on the losses, 2e-3 on the parameters.
- ``train_model``'s ``OUTGRIDVIT_PROFILE_DIR`` trace of the first epoch.

``train_model`` at K > 1 against K = 1 and a resume at K > 1 are in
``tests/test_torch_loop.py``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops import augment as jaug
from outgridvit_tpu.training import mixing as jmixing
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import (
    make_train_superstep as jax_train_superstep,
)
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.data.datasets import get_synthetic_dataloaders
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops import augment as taug
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.training import checkpoints as tckpt
from outgridvit_tpu_torch.training import loop as tloop
from outgridvit_tpu_torch.training.mixing import MixDraws
from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
from outgridvit_tpu_torch.training.steps import (
    DrawLayout,
    StepConfig,
    StepDraws,
    TrainSuperstep,
    make_train_step,
    make_train_superstep,
    sample_step_draws,
    step_generator,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

TINY = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.3,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
    ],
}
IMG, BATCH, K = 16, 8, 3
AUG = dict(mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
           crop_pad=2)
MIX = dict(mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.5)
LR = dict(base_lr=5e-4, total_steps=20, warmup_steps=3, min_lr=1e-6)
CFG = StepConfig(num_classes=10, grad_clip_norm=1.0,
                 augment=taug.AugmentConfig(**AUG), **MIX)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """As ``tests/test_torch_loop.py``: the tiny model's thousands of small
    ops run far faster on one intra-op thread when workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=2):
    model = build_model(TINY, device="cpu", seed=seed)
    return TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05,
                                          1.0))


def _batches(seed=0, k=K):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (k, BATCH, IMG, IMG, 3),
                                          np.uint8)),
            torch.from_numpy(rng.integers(0, 10, (k, BATCH)).astype(
                np.int32)))


def _drop_order(model):
    """The (path, rate) order a train forward of ``model`` draws its masks
    in, recorded on a copy (the forward updates BN statistics)."""
    order = []
    copy.deepcopy(model).train()(
        torch.zeros(BATCH, IMG, IMG, 3),
        DropPathMasks(generator=torch.Generator(), record=order))
    return order


def _tensors(state):
    return ([t.detach() for t in state.model.state_dict().values()]
            + [*state.opt_state.mu.values(), *state.opt_state.nu.values(),
               state.opt_state.count, state.device_step])


def _assert_same_state(a, b):
    assert a.step == b.step
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)


class _SpyMasks(DropPathMasks):
    """In-forward draws, keeping each mask by path."""

    def __init__(self, generator):
        super().__init__(generator=generator)
        self.seen = {}

    def get(self, path, rate, batch, device):
        self.seen[path] = super().get(path, rate, batch, device)
        return self.seen[path]


# ---- the draws, before the forward ----------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (11, 7)])
def test_predrawn_draws_are_bitwise_the_in_forward_ones(seed, step):
    order = _drop_order(build_model(TINY, device="cpu"))
    assert len(order) == 4 and all(r > 0 for _, r in order)
    x, y = _batches(seed, 1)
    states = [_state(), _state()]
    for s in states:
        s.set_step(step)
    g = step_generator(seed, step)
    live = sample_step_draws(g, CFG, tuple(x[0].shape))
    spy = _SpyMasks(g)
    states[0], m0 = make_train_step(CFG, warmup_cosine_lr(**LR))(
        states[0], (x[0], y[0]), draws=live._replace(drop_masks=spy))
    pre = sample_step_draws(step_generator(seed, step), CFG,
                            tuple(x[0].shape), drop_order=order)
    assert list(pre.drop_masks.masks) == [p for p, _ in order]
    assert list(spy.seen) == [p for p, _ in order]
    for p, mask in spy.seen.items():
        assert torch.equal(pre.drop_masks.masks[p], mask), p
    for a, b in ((live.augment, pre.augment), (live.mix, pre.mix)):
        for f, u, v in zip(a._fields, a, b):
            assert (u is None and v is None) or torch.equal(u, v), f
    states[1], m1 = make_train_step(CFG, warmup_cosine_lr(**LR))(
        states[1], (x[0], y[0]), draws=pre)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    _assert_same_state(states[0], states[1])


def test_draw_layout_round_trips_k_steps_bitwise():
    order = _drop_order(build_model(TINY, device="cpu"))
    draws = [sample_step_draws(step_generator(4, i), CFG,
                               (BATCH, IMG, IMG, 3), drop_order=order)
             for i in range(K)]
    layout = DrawLayout(draws[0], K)
    assert all(off % 16 == 0 for *_, off, _ in layout.slots)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    layout.fill(layout.views(buf), draws)
    for d, back in zip(draws, layout.steps(buf)):
        for a, b in ((d.augment, back.augment), (d.mix, back.mix)):
            for f, u, v in zip(a._fields, a, b):
                assert (u is None and v is None) or (
                    u.dtype == v.dtype and torch.equal(u, v)), f
        assert d.drop_masks.masks.keys() == back.drop_masks.masks.keys()
        for p, m in d.drop_masks.masks.items():
            assert torch.equal(back.drop_masks.masks[p], m), p
    bad = draws[0]._replace(drop_masks=DropPathMasks({}))
    with pytest.raises(ValueError, match="layout"):
        layout.fill(layout.views(buf), [bad] * K)


# ---- the CPU superstep against K single steps ----------------------------

def _nan_mix(d):
    """A mixup draw whose blend factor is NaN: the step's loss is NaN."""
    return d._replace(mix=d.mix._replace(
        lam_m=torch.tensor(float("nan")), use_cutmix=torch.tensor(False),
        apply=torch.tensor(True)))


@pytest.mark.parametrize("nonfinite_at", [None, 1])
def test_cpu_superstep_equals_k_train_steps(nonfinite_at):
    x, y = _batches(1)
    single, grouped = _state(), _state()
    sched = warmup_cosine_lr(**LR)
    step = make_train_step(CFG, sched)
    superstep = make_train_superstep(CFG, sched, k=K)
    for group in range(2):
        if nonfinite_at is None:
            ms = []
            for i in range(K):
                single, m = step(single, (x[i], y[i]), seed=5)
                ms.append(m)
            grouped, got = superstep(grouped, (x, y), seed=5)
        else:
            order = _drop_order(single.model)
            draws = [sample_step_draws(step_generator(5, single.step + i),
                                       CFG, tuple(x[0].shape),
                                       drop_order=order) for i in range(K)]
            draws[nonfinite_at] = _nan_mix(draws[nonfinite_at])
            ms = []
            for i in range(K):
                single, m = step(single, (x[i], y[i]), draws=draws[i])
                ms.append(m)
            grouped, got = superstep(grouped, (x, y), draws=draws)
            want = [float(i == nonfinite_at) for i in range(K)]
            assert got["nonfinite"].tolist() == want
            assert got["loss"][nonfinite_at] == 0.0
        assert set(got) == set(ms[0])
        for k in got:
            assert torch.equal(got[k], torch.stack([m[k] for m in ms])), k
        _assert_same_state(grouped, single)
    assert grouped.step == int(grouped.device_step) == 2 * K
    expect = 2 * K - (2 if nonfinite_at is not None else 0)
    assert int(grouped.opt_state.count) == expect
    assert TrainSuperstep.replays == 0  # no graph on the CPU
    assert len(superstep.prepared) == 1


def test_superstep_refuses_what_it_cannot_run():
    superstep = make_train_superstep(CFG, k=K)
    x, y = _batches(0)
    with pytest.raises(ValueError, match="K=3"):
        superstep(_state(), (x[:2], y[:2]), seed=0)
    with pytest.raises(ValueError, match="seed or"):
        superstep(_state(), (x, y))
    with pytest.raises(ValueError, match="drawn before"):
        superstep(_state(), (x, y), draws=[sample_step_draws(
            torch.Generator(), CFG, tuple(x[0].shape))] * K)


# ---- the device step: lr, checkpoints, resume -----------------------------

def test_lr_reads_the_device_step_across_a_resume(tmp_path):
    sched = warmup_cosine_lr(**LR)
    superstep = make_train_superstep(CFG, sched, k=K)
    x, y = _batches(2)
    state = _state()
    state, m1 = superstep(state, (x, y), seed=1)
    tckpt.save_checkpoint(str(tmp_path / "c.ckpt"), state, epoch=1)
    resumed = tckpt.load_checkpoint(str(tmp_path / "c.ckpt"),
                                    _state(seed=9))["state"]
    assert resumed.step == int(resumed.device_step) == K
    resumed, m2 = make_train_superstep(CFG, sched, k=K)(resumed, (x, y),
                                                        seed=1)
    state, m3 = superstep(state, (x, y), seed=1)
    lrs = torch.cat([m1["lr"], m2["lr"]])
    want = torch.stack([sched(torch.tensor(s, dtype=torch.int32))
                        for s in range(2 * K)])
    assert torch.equal(lrs, want)
    assert torch.equal(m2["lr"], m3["lr"])
    for k in m2:
        assert torch.equal(m2[k], m3[k]), k
    _assert_same_state(resumed, state)
    assert resumed.step == int(resumed.device_step) == 2 * K


# ---- against the JAX scan -------------------------------------------------

def _inject_masks(masks):
    """Route explicit keep masks into the JAX model's DropPath modules (as
    ``tests/test_torch_train.py``)."""

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


def _t(a):
    return torch.from_numpy(np.array(a))


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


def test_superstep_matches_the_jax_scan():
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(init)))
    model = load_flax_variables(build_model(TINY, device="cpu"), variables)
    rates = {p: r for p, r in _drop_order(model)}
    masks = {p: np.random.default_rng(8).random(BATCH) < 1.0 - r
             for p, r in rates.items()}

    @jax.jit
    def japply(variables, x, rngs):
        with nn.intercept_methods(_inject_masks(
                {p: jnp.asarray(m) for p, m in masks.items()})):
            return jmodel.apply(variables, x, train=True,
                                mutable=["batch_stats"], rngs=rngs)

    def apply_fn(variables, x, train, mutable, rngs):
        assert train and tuple(mutable) == ("batch_stats",)
        return japply(variables, x, rngs)

    jcfg = JaxStepConfig(num_classes=10, grad_clip_norm=1.0,
                         augment=jaug.AugmentConfig(**AUG), **MIX)
    jstate = JaxTrainState.create(
        apply_fn=apply_fn, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=make_optimizer(jax_schedule(**LR), 0.05, 1.0))
    x, y = _batches(9)
    base_rng = jax.random.PRNGKey(11)
    jstate, jm = jax_train_superstep(jcfg, jax_schedule(**LR), jit=False)(
        jstate, (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())), base_rng)

    draws = []
    for i in range(K):
        r_aug, r_mix, _, _ = jax.random.split(
            jax.random.fold_in(base_rng, i), 4)
        aug = jaug.sample_augment_draws(r_aug, tuple(x[0].shape),
                                        jcfg.augment)
        mix = jmixing.sample_mix_draws(r_mix, BATCH, IMG, IMG,
                                       mixup_alpha=0.8, cutmix_alpha=1.0,
                                       prob=0.5)
        draws.append(StepDraws(
            taug.AugmentDraws(*(None if f is None else _t(f) for f in aug)),
            MixDraws(*(_t(f) for f in mix)),
            DropPathMasks({p: _t(m) for p, m in masks.items()})))
    state = TrainState.create(model, AdamW(warmup_cosine_lr(**LR), 0.05,
                                           1.0))
    state, tm = make_train_superstep(CFG, warmup_cosine_lr(**LR), k=K)(
        state, (x, y), draws=draws)

    assert set(tm) == set(jm)
    assert all(tm[k].shape == (K,) for k in tm)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=5e-4, rtol=0)
    for k in ("top1", "lr", "clipped", "nonfinite"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == K
    want = jax_tree_to_port(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=2e-3,
                                   rtol=0, err_msg=k)


# ---- the first epoch's profiler trace -------------------------------------

def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.setenv("OUTGRIDVIT_PROFILE_DIR", str(tmp_path / "prof"))
    loader, _, _ = get_synthetic_dataloaders(
        batch_size=4, num_samples=12, img_size=8, num_classes=10, seed=0)
    tloop.train_model(
        build_model(dict(TINY, dpr_max=0.0), device="cpu"), loader,
        epochs=2, device="cpu", use_amp=False, print_every=0,
        num_classes=10, early_stop=False, steps_per_dispatch=2,
        save_path=str(tmp_path / "b.ckpt"), last_path=str(tmp_path / "l.ckpt"))
    traces = sorted((tmp_path / "prof").iterdir())
    assert [p.name for p in traces] == ["train_epoch1.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert "[profile] wrote torch trace to" in capsys.readouterr().out
