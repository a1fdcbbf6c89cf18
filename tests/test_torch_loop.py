"""Port parity, the training entry point: the eval step and K-batch eval
superstep, checkpoints and ``train_model`` of ``outgridvit_tpu_torch``
against ``outgridvit_tpu`` on the same weights, data and seeds (CPU, fp32).

- ``make_eval_step`` (uint8 in, normalized in the step) against JAX
  ``make_eval_step`` within 1e-4; the CPU superstep bitwise K eval steps.
- ``train_model`` on a tiny deterministic config (fp32, mixing off,
  ``dpr_max: 0``, host augmentation, a val split with ragged tails) against
  JAX ``train_model`` started from the same state, over 2 epochs, within
  ``tests/test_torch_train.py``'s trajectory bars: 5e-4 on losses, 1e-5 on
  top-k, lr and clip shares, 5e-4 on grad norms, 2e-3 on the parameters.
- Resume: 1 epoch then a resume for the second is bitwise an uninterrupted
  2-epoch run, with the full recipe (mixing, drop-path, device
  augmentation), at K = 1 and K = 3; ``steps_per_dispatch`` K > 1 (each
  full K-group through the train superstep) is bitwise K = 1.
- Early stopping and best tracking follow JAX's on scripted val metrics.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outgridvit_tpu.data.datasets import (
    get_synthetic_structured_dataloaders as jax_structured,
)
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.parallel.mesh import make_mesh
from outgridvit_tpu.training import checkpoints as jckpt
from outgridvit_tpu.training import loop as jloop
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import make_eval_step as jax_eval_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.data.datasets import (
    get_synthetic_dataloaders,
    get_synthetic_structured_dataloaders,
)
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.training import checkpoints as tckpt
from outgridvit_tpu_torch.training import loop as tloop
from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
from outgridvit_tpu_torch.training.steps import (
    EvalSuperstep,
    make_eval_step,
    make_eval_superstep,
    step_generator,
)
from outgridvit_tpu_torch.training.train_state import TrainState
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
    load_jax_train_state,
)

TINY = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.0,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
    ],
}
IMG = 16
NORM = ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761))
# fp32, no mixing, host augmentation: the loop's only randomness is the
# loaders', which both packages draw alike
LOOP = dict(epochs=2, lr=5e-4, weight_decay=0.05, autocast_dtype="fp32",
            use_amp=False, grad_clip_norm=1.0, warmup_ratio=0.2,
            min_lr=1e-5, label_smoothing=0.1, print_every=2,
            num_classes=10, early_stop=False, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tiny model's steps are thousands of small ops: with the test
    workers sharing the cores, torch's intra-op thread pool makes them
    ~50x slower than one thread does (measured on an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(variables, seed=0):
    """Perturb the init so BN statistics and every parameter are
    non-trivial."""
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
def tiny():
    """The tiny JAX model and randomized variables, and the port's model
    holding the same weights."""
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(_tree_np(dict(init)))
    return jmodel, variables


def _port_model(variables, dtype=torch.float32):
    return load_flax_variables(build_model(TINY, dtype=dtype, device="cpu"),
                               variables)


# ---- the eval step and superstep -----------------------------------------

def test_eval_step_matches_jax_with_normalize_inside(tiny):
    jmodel, variables = tiny
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (12, IMG, IMG, 3), np.uint8)
    labels = rng.integers(0, 10, 12).astype(np.int32)
    want = jax_eval_step(jmodel.apply, normalize=NORM)(
        variables["params"], variables["batch_stats"],
        (jnp.asarray(images), jnp.asarray(labels)))
    got = make_eval_step(_port_model(variables), normalize=NORM)(
        (torch.from_numpy(images), torch.from_numpy(labels)))
    assert set(got) == set(want) == {"loss", "top1", "top3", "top5"}
    for k in got:
        assert got[k].shape == () and got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("normalize", [None, NORM])
def test_cpu_superstep_equals_k_eval_steps(tiny, normalize):
    model = _port_model(tiny[1])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (3, 4, IMG, IMG, 3), np.uint8))
    if normalize is None:
        x = x.float() / 255.0
    y = torch.from_numpy(rng.integers(0, 10, (3, 4)).astype(np.int32))
    replays = EvalSuperstep.replays
    got = make_eval_superstep(model, normalize=normalize, k=3)((x, y))
    step = make_eval_step(model, normalize=normalize)
    for i in range(3):
        for k, v in step((x[i], y[i])).items():
            assert torch.equal(got[k][i], v), k
    assert EvalSuperstep.replays == replays  # no graph on the CPU
    with pytest.raises(ValueError, match="K=2"):
        make_eval_superstep(model, k=2)((x, y))


def test_step_generator_depends_on_seed_and_step():
    draws = {(s, t): torch.rand(4, generator=step_generator(s, t))
             for s in (0, 1) for t in (0, 1)}
    assert torch.equal(draws[0, 1],
                       torch.rand(4, generator=step_generator(0, 1)))
    assert len({tuple(v.tolist()) for v in draws.values()}) == 4


# ---- checkpoints ----------------------------------------------------------

def _trained_state(seed=0):
    model = build_model(TINY, device="cpu", seed=seed)
    state = TrainState.create(model, AdamW(1e-3))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k in state.opt_state.mu:
            state.opt_state.mu[k].normal_(generator=g)
            state.opt_state.nu[k].uniform_(generator=g)
        for b in model.buffers():
            b.uniform_(0.5, 1.5, generator=g)
    state.opt_state.count.fill_(7)
    state.set_step(9)
    return state


def test_checkpoint_round_trip_copies_in_place(tmp_path):
    src = _trained_state(0)
    path = tmp_path / "d" / "c.ckpt"
    tckpt.save_checkpoint(str(path), src, epoch=3, best_top1=41.5,
                          extra={"best_epoch": 2})
    assert path.read_bytes()[:4] == b"OGVT"
    dst = _trained_state(1)
    ptrs = [t.data_ptr() for t in dst.model.state_dict().values()]
    out = tckpt.load_checkpoint(str(path), dst)
    assert out["state"] is dst and out["epoch"] == 3
    assert out["best_top1"] == 41.5 and out["extra"] == {"best_epoch": 2}
    assert [t.data_ptr() for t in dst.model.state_dict().values()] == ptrs
    for a, b in zip(src.model.state_dict().values(),
                    dst.model.state_dict().values()):
        assert torch.equal(a, b)
    for k in src.opt_state.mu:
        assert torch.equal(src.opt_state.mu[k], dst.opt_state.mu[k])
        assert torch.equal(src.opt_state.nu[k], dst.opt_state.nu[k])
    assert int(dst.opt_state.count) == 7 and dst.step == 9
    assert int(dst.device_step) == 9
    raw = tckpt.load_checkpoint(str(path))["state"]
    assert raw["step"] == raw["device_step"] == 9
    assert set(raw) == {"model", "opt_state", "step", "device_step"}
    model = build_model(TINY, device="cpu", seed=5)
    tckpt.load_model_variables(str(path), model)
    for a, b in zip(src.model.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)
    (tmp_path / "bad").write_bytes(b"XXXX")
    with pytest.raises(ValueError, match="not an outgridvit_tpu_torch"):
        tckpt.load_checkpoint(str(tmp_path / "bad"))
    other = dict(TINY, num_classes=7)
    with pytest.raises(ValueError, match="classifier"):
        tckpt.load_model_variables(str(path), build_model(other,
                                                          device="cpu"))


def test_jax_checkpoint_carries_across(tmp_path, tiny):
    """A JAX train state written by the JAX package, read back by it, into
    the port through load_jax_train_state, and through the port's own
    checkpoint: every tensor as JAX had it."""
    jmodel, variables = tiny
    tx = make_optimizer(1e-3, 0.05, 1.0)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=tx)
    grads = jax.tree_util.tree_map(jnp.ones_like, jstate.params)
    _, opt = jax.jit(tx.update)(grads, jstate.opt_state, jstate.params)
    jstate = jstate.replace(opt_state=opt, step=jstate.step + 4)
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), jstate, epoch=2)
    back = jckpt.load_checkpoint(str(tmp_path / "j.ckpt"), jstate)["state"]
    adam = back.opt_state[1][0]
    state = load_jax_train_state(
        build_model(TINY, device="cpu"), AdamW(1e-3),
        params=_tree_np(back.params), batch_stats=_tree_np(back.batch_stats),
        mu=_tree_np(adam.mu), nu=_tree_np(adam.nu), count=int(adam.count),
        step=int(back.step))
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), state, epoch=2)
    fresh = TrainState.create(build_model(TINY, device="cpu", seed=3),
                              AdamW(1e-3))
    fresh = tckpt.load_checkpoint(str(tmp_path / "t.ckpt"), fresh)["state"]
    assert fresh.step == 4 and int(fresh.opt_state.count) == 1
    want = jax_tree_to_port(_tree_np(back.params))
    for k, p in fresh.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
    for name in ("mu", "nu"):
        want = jax_tree_to_port(_tree_np(getattr(adam, name)))
        for k, t in getattr(fresh.opt_state, name).items():
            np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


# ---- train_model against JAX ----------------------------------------------

def _structured(module_fn, device_augment=False):
    return module_fn(batch_size=16, num_samples=90, img_size=IMG,
                     num_classes=10, seed=4, val_split=0.2, noise=40.0,
                     device_augment=device_augment)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory, tiny):
    """Two epochs of the tiny fp32 config through both loops, from the
    same state, on the same (host-augmented) batches."""
    jmodel, variables = tiny
    tmp = tmp_path_factory.mktemp("loop")
    jtrain, jval, _ = _structured(jax_structured)
    ttrain, tval, _ = _structured(get_synthetic_structured_dataloaders)
    assert len(ttrain) == 5 and ttrain.device_augment is None
    total = LOOP["epochs"] * len(ttrain)
    warmup = int(total * LOOP["warmup_ratio"])
    sched = (LOOP["lr"], total, warmup, LOOP["min_lr"])
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=make_optimizer(jax_schedule(*sched), LOOP["weight_decay"],
                          LOOP["grad_clip_norm"]))
    jhist, jstate = jloop.train_model(
        jmodel, jtrain, val_loader=jval, state=jstate,
        save_path=str(tmp / "jb.ckpt"), last_path=str(tmp / "jl.ckpt"),
        mesh=make_mesh((1, 1), devices=jax.devices()[:1]), **LOOP)
    state = TrainState.create(_port_model(variables), AdamW(
        warmup_cosine_lr(*sched), LOOP["weight_decay"],
        LOOP["grad_clip_norm"]))
    thist, state = tloop.train_model(
        state.model, ttrain, val_loader=tval, state=state, device="cpu",
        save_path=str(tmp / "tb.ckpt"), last_path=str(tmp / "tl.ckpt"),
        **LOOP)
    return jhist, jstate, thist, state


def test_train_model_history_matches_jax(loop_runs):
    jhist, _, thist, _ = loop_runs
    assert set(thist) == set(jhist)
    assert len(thist["train_loss"]) == len(thist["val_loss"]) == 2
    for k, tol in (("train_loss", 5e-4), ("val_loss", 5e-4),
                   ("train_grad_norm", 5e-4), ("lr", 1e-5),
                   ("train_clip_frac", 1e-5),
                   *((f"{s}_top{n}", 1e-5) for s in ("train", "val")
                     for n in (1, 3, 5))):
        np.testing.assert_allclose(thist[k], jhist[k], atol=tol, rtol=0,
                                   err_msg=k)
    for k in ("train_amp_overflows", "train_nonfinite_loss_steps",
              "train_scaler_scale"):
        assert thist[k] == jhist[k], k
    for k in ("train_mem_alloc_gib", "val_mem_res_gib"):
        assert np.isnan(thist[k]).all()  # no device memory on the CPU


def test_train_model_state_matches_jax(loop_runs, tmp_path_factory):
    _, jstate, _, state = loop_runs
    assert state.step == int(jstate.step) == 10
    want = jax_tree_to_port(_tree_np(jstate.params))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=2e-3,
                                   rtol=0, err_msg=k)


class _Interrupted(Exception):
    pass


class _InterruptAt:
    """A loader that stops the run when asked for ``epoch``."""

    def __init__(self, loader, epoch):
        self.loader, self.epoch = loader, epoch
        self.device_augment = loader.device_augment

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)

    def set_epoch(self, epoch):
        if epoch == self.epoch:
            raise _Interrupted
        self.loader.set_epoch(epoch)


def _recipe_run(tmp, epochs, resume=None, k=1, last="last.ckpt",
                interrupt_at=None):
    """The full recipe on the CPU: raw uint8 and device augmentation,
    mixup/cutmix, drop-path, a val split."""
    train, val, _ = _structured(get_synthetic_structured_dataloaders,
                                device_augment=True)
    assert train.device_augment is not None and val.device_normalize
    if interrupt_at is not None:
        train = _InterruptAt(train, interrupt_at)
    model = build_model(dict(TINY, dpr_max=0.3), device="cpu", seed=2)
    return tloop.train_model(
        model, train, epochs=epochs, val_loader=val, device="cpu",
        lr=1e-3, autocast_dtype="fp32", use_amp=False, warmup_ratio=0.2,
        min_lr=1e-5, print_every=0, save_path=str(tmp / "best.ckpt"),
        last_path=str(tmp / last), resume_path=resume, mixup_alpha=0.8,
        cutmix_alpha=1.0, mix_prob=0.7, num_classes=10, early_stop=False,
        seed=11, steps_per_dispatch=k)


def _assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.device_step, b.device_step)
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    assert torch.equal(a.opt_state.count, b.opt_state.count)


def _assert_same_history(a, b, epochs=slice(None)):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]),
                                      np.asarray(b[k][epochs]), err_msg=k)


def test_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    full_hist, full = _recipe_run(tmp_path / "full", 2)
    with pytest.raises(_Interrupted):  # after epoch 1 and its checkpoint
        _recipe_run(tmp_path / "cut", 2, interrupt_at=2)
    hist, resumed = _recipe_run(tmp_path / "cut", 2,
                                resume=str(tmp_path / "cut" / "last.ckpt"),
                                last="last2.ckpt")
    assert len(hist["train_loss"]) == 1
    _assert_same_history(hist, full_hist, slice(1, 2))
    _assert_same_state(resumed, full)
    assert np.isfinite(full_hist["train_loss"]).all()
    assert full_hist["train_loss"][0] != full_hist["train_loss"][1]


def test_resume_at_k3_is_bitwise_an_uninterrupted_run(tmp_path):
    """As above with K = 3: each epoch's first three batches through the
    train superstep (its device step restored from the checkpoint)."""
    full_hist, full = _recipe_run(tmp_path / "full", 2, k=3)
    with pytest.raises(_Interrupted):
        _recipe_run(tmp_path / "cut", 2, k=3, interrupt_at=2)
    hist, resumed = _recipe_run(tmp_path / "cut", 2, k=3,
                                resume=str(tmp_path / "cut" / "last.ckpt"),
                                last="last2.ckpt")
    _assert_same_history(hist, full_hist, slice(1, 2))
    _assert_same_state(resumed, full)
    assert int(resumed.device_step) == resumed.step == 10


def _counting_superstep(monkeypatch):
    """Count train_model's superstep calls."""
    calls = []
    make = tloop.make_train_superstep

    def counted(*args, **kwargs):
        superstep = make(*args, **kwargs)

        def call(*a, **kw):
            calls.append(a[1][1].shape)
            return superstep(*a, **kw)

        return call

    monkeypatch.setattr(tloop, "make_train_superstep", counted)
    return calls


def test_steps_per_dispatch_is_bitwise_single_steps(tmp_path, monkeypatch):
    calls = _counting_superstep(monkeypatch)
    h1, s1 = _recipe_run(tmp_path / "k1", 2)
    assert calls == []
    h3, s3 = _recipe_run(tmp_path / "k3", 2, k=3)
    # 4 full batches and a ragged tail an epoch: one superstep, then single
    # steps for the 4th batch and the tail
    assert calls == [(3, 16)] * 2
    _assert_same_history(h3, h1)
    _assert_same_state(s3, s1)


# ---- early stopping and best tracking ------------------------------------

SCRIPTS = {
    "top1": ("top1", False, [10.0, 20.0, 20.0, 15.0, 30.0, 14.0, 13.0,
                             12.0]),
    "loss_monotonic": ("loss", True, [2.0, 1.5, 1.6, 1.4, 1.45, 1.41, 1.5,
                                      1.6]),
    "loss": ("loss", False, [2.0, 1.5, 1.6, 1.55, 1.7, 1.2, 1.3, 1.25]),
}


def _scripted(metric, values):
    it = iter(values)

    def run_eval(*args, **kwargs):
        v = next(it)
        top1 = v if metric == "top1" else 100.0 - 10 * v
        loss = v if metric == "loss" else 5.0 - v / 10
        return {"loss": loss, "top1": top1, "top3": top1, "top5": top1}

    return run_eval


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_early_stop_and_best_tracking_follow_jax(tmp_path, monkeypatch,
                                                 capsys, script):
    metric, monotonic, values = SCRIPTS[script]
    kw = dict(epochs=len(values), use_amp=False, print_every=0,
              num_classes=10, early_stop=True, early_stop_metric=metric,
              early_stop_patience=2, early_stop_min_delta=0.01,
              early_stop_require_monotonic=monotonic, seed=0)
    runs = {}
    for name, loop in (("jax", jloop), ("port", tloop)):
        monkeypatch.setattr(loop, "_run_eval", _scripted(metric, values))
        loader, _, _ = (get_synthetic_dataloaders if name == "port"
                        else _jax_synthetic)(
            batch_size=8, num_samples=8, img_size=8, num_classes=10, seed=0)
        out = tmp_path / name
        if name == "jax":
            model = jax_build_model(TINY, use_pallas=False)
            extra = dict(mesh=make_mesh((1, 1), devices=jax.devices()[:1]))
        else:
            model = build_model(TINY, device="cpu")
            extra = dict(device="cpu")
        hist, _ = loop.train_model(
            model, loader, val_loader=loader, save_path=str(out / "b.ckpt"),
            last_path=str(out / "l.ckpt"), **kw, **extra)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith(("Best saved", "Early-stop"))]
        lines = [re.sub(r"to \S+/(\w+)/b\.ckpt", r"to \1", ln)
                 .replace("to " + name, "to RUN") for ln in lines]
        meta = [jckpt, tckpt][name == "port"].load_checkpoint(
            str(out / "b.ckpt"))
        runs[name] = (len(hist["val_loss"]), hist["val_loss"],
                      hist["val_top1"], lines, meta["epoch"],
                      meta["best_top1"], meta["extra"])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] < len(values) or script == "loss"


def _jax_synthetic(**kw):
    from outgridvit_tpu.data.datasets import get_synthetic_dataloaders as f

    return f(**kw)


# ---- what train_model refuses ---------------------------------------------

def test_train_model_refuses_a_mismatched_model_or_device(tmp_path):
    loader, _, _ = get_synthetic_dataloaders(batch_size=4, num_samples=4,
                                             img_size=8, num_classes=10)
    model = build_model(TINY, device="cpu")
    kw = dict(epochs=1, num_classes=10, save_path=str(tmp_path / "b"),
              last_path=str(tmp_path / "l"))
    with pytest.raises(ValueError, match="build_model"):  # fp32 vs bf16
        tloop.train_model(model, loader, device="cpu", **kw)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tloop.train_model(model, loader, device="cpu", use_amp=False,
                          mesh=object(), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.train_model(model, loader, use_amp=False, **kw)


@pytest.mark.parametrize("knob", ["fp16", "float16", "bf16", "bfloat16",
                                  "fp32", "float32", "other"])
@pytest.mark.parametrize("use_amp", [True, False])
def test_dtype_from_cfg_maps_as_jax(knob, use_amp):
    got = tloop._dtype_from_cfg(knob, use_amp)
    want = jloop._dtype_from_cfg(knob, use_amp)
    assert str(got).removeprefix("torch.") == jnp.dtype(want).name
