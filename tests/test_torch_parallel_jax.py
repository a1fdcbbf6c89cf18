"""Port parity, the parallel slice against JAX: one train step of a tiny
Model A with mixing on, in a 2-rank gloo world of the port (mesh (2, 1),
spawned CPU processes, ``tests/torch_parallel_worker.py``), against the JAX
``make_train_step`` on a ``(2, 1)`` mesh of this process's virtual CPU
devices, from the same weights, batch and draws.

The JAX draws come from the keys the JAX step derives (``fold_in(base_rng,
step)`` split four ways), as ``tests/test_torch_train.py`` takes them, and
the drop-path masks are drawn with numpy and routed into flax with
``nn.intercept_methods``. The port's ranks each draw nothing: they take
their rows of the global draws (``training/steps.py:local_draws``), and
the mix, which pairs rows across the two ranks, runs on the gathered
batch. The JAX step runs with ``jit=False`` around a jitted ``apply_fn``
(see ``tests/test_torch_train.py`` for why). Bars: 1e-5 on the loss, the
metrics, the parameters, the BN statistics and the AdamW moments (fp32
per-op), as ROADMAP states them.
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops import augment as jaug
from outgridvit_tpu.parallel import batch_sharding
from outgridvit_tpu.parallel import make_mesh as jax_make_mesh
from outgridvit_tpu.parallel import shard_train_state as jax_shard
from outgridvit_tpu.training import mixing as jmixing
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_schedule
from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
from outgridvit_tpu.training.steps import make_train_step as jax_train_step
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models.layers import DropPath
from outgridvit_tpu_torch.utils.port_jax import jax_tree_to_port

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"

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
IMG, BATCH = 16, 8
AUG = dict(mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
           crop_pad=2)
MIX = dict(mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=1.0)
LR = dict(base_lr=5e-4, total_steps=20, warmup_steps=3, min_lr=1e-6)
TOL = 1e-5


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX step on mesh (2, 1) here, the port's on 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("jax_step")
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(_tree_np(dict(init)))
    rng = np.random.default_rng(8)
    masks = {m.path: rng.random(BATCH) < 1.0 - m.rate
             for m in build_model(TINY, device="meta").modules()
             if isinstance(m, DropPath) and m.rate > 0}
    assert masks and not all(m.all() for m in masks.values())

    @functools.partial(jax.jit, static_argnames=("train", "mutable"))
    def japply(variables, x, rngs, train, mutable):
        with nn.intercept_methods(_inject_masks(
                {p: jnp.asarray(m) for p, m in masks.items()})):
            return jmodel.apply(variables, x, train=train, mutable=mutable,
                                rngs=rngs)

    def apply_fn(variables, x, train, mutable, rngs):
        return japply(variables, x, rngs, train, tuple(mutable))

    mesh = jax_make_mesh((2, 1), devices=jax.devices()[:2])
    jstate = jax_shard(JaxTrainState.create(
        apply_fn=apply_fn, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=make_optimizer(jax_schedule(**LR), 0.05, 1.0)), mesh)
    jcfg = JaxStepConfig(num_classes=10, grad_clip_norm=1.0,
                         augment=jaug.AugmentConfig(**AUG), **MIX)
    jstep = jax_train_step(jcfg, jax_schedule(**LR), jit=False)
    data = np.random.default_rng(9)
    images = data.integers(0, 256, (BATCH, IMG, IMG, 3), np.uint8)
    labels = data.integers(0, 10, BATCH).astype(np.int32)
    base_rng = jax.random.PRNGKey(11)
    r_aug, r_mix, _, _ = jax.random.split(jax.random.fold_in(base_rng, 0), 4)
    aug = jaug.sample_augment_draws(r_aug, images.shape, jcfg.augment)
    mix = jmixing.sample_mix_draws(r_mix, BATCH, IMG, IMG, mixup_alpha=0.8,
                                   cutmix_alpha=1.0, prob=1.0)
    shard = batch_sharding(mesh)
    jstate, jm = jstep(jstate, (jax.device_put(images, shard),
                                jax.device_put(labels, shard)), base_rng)

    arrays = {f"var/{k}": v for k, v in _flatten(variables)}
    arrays.update((f"aug/{f}", np.asarray(v))
                  for f, v in zip(aug._fields, aug) if v is not None)
    arrays.update((f"mix/{f}", np.asarray(v))
                  for f, v in zip(mix._fields, mix))
    arrays.update((f"mask/{p}", m) for p, m in masks.items())
    np.savez(tmp / "jax_inputs.npz", images=images, labels=labels,
             config=json.dumps({"model": TINY, "lr": LR, "aug": AUG,
                                "mix": MIX}), **arrays)

    port = _free_port()
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port), str(tmp),
         "jax_step"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ports = [torch.load(tmp / f"jax_step_r{r}.pt", weights_only=False)
             for r in range(2)]
    adam = jstate.opt_state[1][0]
    want = {f"model.{k}": v for k, v in jax_tree_to_port(
        _tree_np(jstate.params)).items()}
    want.update((f"model.{k}", v) for k, v in jax_tree_to_port(
        _tree_np(jstate.batch_stats)).items())
    for part in ("mu", "nu"):
        want.update((f"{part}.{k}", v) for k, v in jax_tree_to_port(
            _tree_np(getattr(adam, part))).items())
    return ({k: float(v) for k, v in jm.items()}, want, ports,
            bool(mix.use_cutmix))


def _bn_key(k):
    return k.replace("running_mean", "mean").replace("running_var", "var")


def test_two_rank_step_matches_jax_mesh_step_metrics(run):
    jm, _, ports, _ = run
    for p in ports:
        assert set(p["metrics"]) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(p["metrics"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("part", ["params", "batch_stats", "mu", "nu"])
def test_two_rank_step_matches_jax_mesh_step_state(run, part):
    """Every leaf of the part after the step, on each rank, within 1e-5
    (``nu``, which holds squared gradients, within 1e-5 of its largest
    value over every leaf). A parameter element whose gradient is rounding noise
    (``|g| < 1e-6``, as the key bias of an attention, whose exact gradient
    is 0: softmax ignores a shift of every logit) moves by Adam's first
    step ``lr * g / (|g| + eps)``, of a size and sign the noise sets: there
    the bound is ``2 * lr``."""
    _, want, ports, _ = run
    prefix = {"params": "model.", "batch_stats": "model.",
              "mu": "mu.", "nu": "nu."}[part]
    stats = part == "batch_stats"
    keys = [k for k in ports[0]["state"] if k.startswith(prefix)
            and ("running_" in k) == stats]
    assert keys
    lr0 = LR["base_lr"] / LR["warmup_steps"]  # the schedule at step 0
    atol = TOL * max(float(np.abs(want[k]).max()) for k in keys) \
        if part == "nu" else TOL
    for p in ports:
        for k in keys:
            got = p["state"][k].numpy()
            ref = want[k]
            if part == "params":
                noise = np.abs(want["mu." + k[6:]]) < 0.1 * 1e-6  # mu = .1 g
                np.testing.assert_array_less(np.abs(got - ref)[noise],
                                             2 * lr0 + 1e-7)
                got, ref = got[~noise], ref[~noise]
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=atol,
                                       err_msg=_bn_key(k))
