"""Worker processes for the port's parallel tests (tests/test_torch_parallel*.py):
one rank of a gloo world on the CPU, running ``outgridvit_tpu_torch`` only
(no JAX), one thread a rank.

    python torch_parallel_worker.py <rank> <world> <port> <outdir> <scenario>

Each scenario writes ``<outdir>/<scenario>_r<rank>.pt`` (``torch.save`` of
a dict of results). Scenarios:

- ``jax_step``: one train step of the tiny model on mesh (2, 1) from
  ``<outdir>/jax_inputs.npz`` (flax variables, the global batch and the
  JAX-sampled draws, written by the parent test), the whole state after it;
- ``world2``: ``train_model`` on meshes (2, 1) and (1, 2), the blocks of
  the tensor-parallel leaves, a resume, the eval superstep epoch against the
  per-batch one, the mesh predictor against the single one, and a train
  step with dropout against the single device's step on the global batch;
- ``world4``: ``train_model`` on meshes (4, 1) and (2, 2), and the (2, 2)
  train superstep (K = 2) against two single steps.

Not named ``test_*``: pytest does not collect it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

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
IMG, BATCH = 16, 16
DATA = dict(batch_size=BATCH, num_samples=80, img_size=IMG, num_classes=10,
            seed=4, val_split=0.2, noise=40.0, device_augment=True)
LOOP = dict(epochs=2, device="cpu", lr=1e-3, autocast_dtype="fp32",
            use_amp=False, warmup_ratio=0.2, min_lr=1e-5, print_every=2,
            mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.7, num_classes=10,
            early_stop=False, seed=11)
DROP = {"attn_drop": 0.2, "proj_drop": 0.1, "ffn_drop": 0.2}


def loaders():
    from outgridvit_tpu_torch.data.datasets import (
        get_synthetic_structured_dataloaders,
    )

    train, val, _ = get_synthetic_structured_dataloaders(**DATA)
    return train, val


def run_train_model(tmp, mesh=None, resume=None, interrupt_at=None,
                    last="last.ckpt", k=1):
    """The full recipe (uint8 in with the device augmentation, mixup /
    cutmix, drop-path, a val split) through ``train_model``."""
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.parallel import shard_loader_for_process
    from outgridvit_tpu_torch.training.loop import train_model

    train, val = loaders()
    if mesh is not None:
        shard_loader_for_process(train, mesh)
        shard_loader_for_process(val, mesh)
    if interrupt_at is not None:
        train = InterruptAt(train, interrupt_at)
    model = build_model(TINY, device="cpu", seed=2)
    Path(tmp).mkdir(parents=True, exist_ok=True)
    return train_model(model, train, val_loader=val, mesh=mesh,
                       save_path=str(Path(tmp) / "best.ckpt"),
                       last_path=str(Path(tmp) / last), resume_path=resume,
                       steps_per_dispatch=k, **LOOP)


class Interrupted(Exception):
    pass


class InterruptAt:
    """A loader that stops the run when asked for ``epoch``."""

    def __init__(self, loader, epoch):
        self.loader, self.epoch = loader, epoch
        self.device_augment = loader.device_augment
        self.process_id = loader.process_id
        self.process_count = loader.process_count

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)

    def set_epoch(self, epoch):
        if epoch == self.epoch:
            raise Interrupted
        self.loader.set_epoch(epoch)


def whole_state(state):
    """Every tensor of a train state, tensor-parallel blocks gathered
    whole (a collective on a mesh), as CPU tensors by name."""
    from outgridvit_tpu_torch.training.checkpoints import _tree

    tree = _tree(state)
    out = {f"model.{k}": v.detach().cpu().clone()
           for k, v in tree["model"].items()}
    for part in ("mu", "nu"):
        out.update((f"{part}.{k}", v.detach().cpu().clone())
                   for k, v in tree["opt_state"][part].items())
    out["count"] = tree["opt_state"]["count"].cpu().clone()
    return out


def summary(history, state):
    whole = whole_state(state)
    return {"history": {k: list(map(float, history[k])) for k in (
                "train_loss", "val_loss", "val_top1", "train_grad_norm")},
            "step": int(state.step),
            "checksum": float(sum(v.double().abs().sum() for k, v in
                                  whole.items() if k.startswith("model."))),
            "state": whole}


def unflatten(flat):
    """``{"a/b/c": array}`` -> nested dicts."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def jax_step(rank, outdir):
    """One step of the tiny model (mixing on) on mesh (2, 1) from the
    parent's weights, batch and JAX draws."""
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.ops.augment import AugmentConfig, AugmentDraws
    from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
    from outgridvit_tpu_torch.parallel import make_mesh, shard_train_state
    from outgridvit_tpu_torch.training.mixing import MixDraws
    from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        StepDraws,
        data_rows,
        local_draws,
        make_train_step,
    )
    from outgridvit_tpu_torch.training.train_state import TrainState
    from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

    z = dict(np.load(Path(outdir) / "jax_inputs.npz"))
    cfg = json.loads(str(z.pop("config")))
    variables = unflatten({k[4:]: v for k, v in z.items()
                           if k.startswith("var/")})
    mesh = make_mesh((2, 1))
    model = load_flax_variables(build_model(cfg["model"], device="cpu"),
                                variables)
    sched = warmup_cosine_lr(**cfg["lr"])
    state = shard_train_state(TrainState.create(model, AdamW(
        sched, 0.05, 1.0)), mesh)
    step = make_train_step(StepConfig(
        num_classes=10, grad_clip_norm=1.0,
        augment=AugmentConfig(**cfg["aug"]), **cfg["mix"]), sched)
    images, labels = torch.from_numpy(z["images"]), torch.from_numpy(
        z["labels"])
    rows = data_rows(model, images.shape[0] // 2)
    aug = AugmentDraws(*(torch.from_numpy(z[f"aug/{f}"])
                         if f"aug/{f}" in z else None
                         for f in AugmentDraws._fields))
    mix = MixDraws(*(torch.from_numpy(np.array(z[f"mix/{f}"]))
                     for f in MixDraws._fields))
    masks = DropPathMasks({k[5:]: torch.from_numpy(v) for k, v in z.items()
                           if k.startswith("mask/")})
    draws = local_draws(StepDraws(aug, mix, masks), rows)
    state, metrics = step(state, (images[rows[0]], labels[rows[0]]),
                          draws=draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": whole_state(state)}


def world2(rank, outdir):
    from outgridvit_tpu_torch.models.layers import Dense
    from outgridvit_tpu_torch.parallel import make_mesh
    from outgridvit_tpu_torch.parallel.mesh import shard_dims_of

    out = {}
    tmp = Path(outdir) / "w2"  # shared: rank 0 writes, every rank reads
    mesh21, mesh12 = make_mesh((2, 1)), make_mesh((1, 2))
    own = Path(outdir) / f"w2_r{rank}"  # each rank's own output dir
    out["dp"] = summary(*run_train_model(own, mesh21))
    out["dp_ckpt"] = sorted(p.name for p in own.iterdir())
    hist, state = run_train_model(tmp / "tp", mesh12)
    out["tp"] = summary(hist, state)
    model = state.model
    out["tp_blocks"] = {
        name: (tuple(dict(model.named_parameters())[name].shape),
               tuple(state.opt_state.mu[name].shape),
               tuple(state.opt_state.nu[name].shape), dim)
        for name, dim in shard_dims_of(model).items()}
    out["tp_whole"] = {name[6:]: tuple(v.shape) for name, v in
                       out["tp"]["state"].items()
                       if name[6:] in shard_dims_of(model)}
    out["tp_gathered"] = sorted(
        n for n, m in model.named_modules()
        if isinstance(m, Dense) and "tp_shards" in m.__dict__)
    # resume: epoch 1, the world torn down at epoch 2, then epoch 2 again
    try:
        run_train_model(tmp / "cut", mesh21, interrupt_at=2)
    except Interrupted:
        pass
    out["resumed"] = summary(*run_train_model(
        tmp / "cut", mesh21, resume=str(tmp / "cut" / "last.ckpt"),
        last="last2.ckpt"))
    out.update(eval_epochs(mesh21))
    out.update(predictor(mesh21))
    out.update(dropout_step(mesh21))
    return out


def eval_epochs(mesh):
    """An eval epoch on the mesh over the train images (raw uint8, 4
    global batches of 16): per batch, and through the K = 2 eval
    superstep."""
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.parallel import shard_loader_for_process
    from outgridvit_tpu_torch.parallel.mesh import shard_model
    from outgridvit_tpu_torch.training.loop import _run_eval
    from outgridvit_tpu_torch.training.steps import (
        make_eval_step,
        make_eval_superstep,
    )

    train, val = loaders()
    shard_loader_for_process(train, mesh)
    model = shard_model(build_model(TINY, device="cpu", seed=5), mesh)
    norm = val.device_normalize
    step = make_eval_step(model, normalize=norm)
    sup = make_eval_superstep(model, normalize=norm, k=2)
    return {"eval_batch": _run_eval(step, train, "cpu"),
            "eval_super": _run_eval(step, train, "cpu", eval_superstep=sup,
                                    k=2)}


def predictor(mesh):
    from outgridvit_tpu_torch.serving import build_predictor

    images = np.random.default_rng(3).integers(0, 256, (12, IMG, IMG, 3),
                                               np.uint8)
    kw = dict(batch_size=16, img_size=IMG, dtype=torch.float32,
              device="cpu", seed=1)
    single = build_predictor(TINY, **kw).predict(images)
    multi = build_predictor(TINY, mesh=mesh, **kw).predict(images)
    try:
        build_predictor(TINY, mesh=mesh, **dict(kw, batch_size=15))
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"predict_single": single, "predict_mesh": multi,
            "predict_refused": refused}


def dropout_step(mesh):
    """One train step with every dropout rate on (masks hashed on the
    device) and mixing: the rank's rows on the mesh against the single
    device's step on the whole batch, from the same state."""
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.ops.augment import AugmentConfig
    from outgridvit_tpu_torch.parallel import (
        batch_sharding,
        shard_train_state,
    )
    from outgridvit_tpu_torch.training.optim import AdamW
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        make_train_step,
    )
    from outgridvit_tpu_torch.training.train_state import TrainState

    cfg = dict(TINY, stages=[dict(s, **DROP) for s in TINY["stages"]])
    step = make_train_step(StepConfig(
        num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=1.0,
        augment=AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3,
                              crop_pad=2)))
    g = torch.Generator().manual_seed(7)
    x = torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=g,
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (BATCH,), generator=g)
    out = {}
    for name, m in (("single", None), ("mesh", mesh)):
        state = TrainState.create(build_model(cfg, device="cpu", seed=3),
                                  AdamW(1e-3, 0.05, 1.0))
        batch = (x, y)
        if m is not None:
            state = shard_train_state(state, m)
            batch = tuple(map(batch_sharding(m).local, batch))
        metrics = []
        for _ in range(2):
            state, got = step(state, batch, seed=13)
            metrics.append({k: float(v) for k, v in got.items()})
        out[f"drop_{name}"] = (metrics, whole_state(state))
    return out


def world4(rank, outdir):
    from outgridvit_tpu_torch.models import build_model
    from outgridvit_tpu_torch.ops.augment import AugmentConfig
    from outgridvit_tpu_torch.parallel import (
        make_mesh,
        shard_train_state,
        superbatch_sharding,
    )
    from outgridvit_tpu_torch.training.optim import AdamW
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        make_train_step,
        make_train_superstep,
    )
    from outgridvit_tpu_torch.training.train_state import TrainState

    tmp = Path(outdir) / f"w4_r{rank}"
    mesh41, mesh22 = make_mesh((4, 1)), make_mesh((2, 2))
    out = {"dp": summary(*run_train_model(tmp / "dp", mesh41)),
           "dptp": summary(*run_train_model(tmp / "dptp", mesh22))}
    # the (2, 2) superstep at K = 2 against two single steps
    cfg = StepConfig(num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0,
                     mix_prob=1.0, augment=AugmentConfig(
                         mean=(0.5,) * 3, std=(0.25,) * 3, crop_pad=2))
    g = torch.Generator().manual_seed(8)
    x = torch.randint(0, 256, (2, BATCH, IMG, IMG, 3), generator=g,
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (2, BATCH), generator=g)
    x, y = (superbatch_sharding(mesh22).local(t) for t in (x, y))
    runs = {}
    for name in ("steps", "super"):
        state = shard_train_state(TrainState.create(
            build_model(TINY, device="cpu", seed=6), AdamW(1e-3, 0.05, 1.0)),
            mesh22)
        if name == "steps":
            step = make_train_step(cfg)
            for i in range(2):
                state, _ = step(state, (x[i], y[i]), seed=21)
        else:
            state, _ = make_train_superstep(cfg, k=2)(state, (x, y),
                                                      seed=21)
        runs[name] = whole_state(state)
    out["superstep"] = runs
    return out


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    outdir, scenario = Path(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    from outgridvit_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    distributed.warmup_collectives()
    try:
        out = {"jax_step": jax_step, "world2": world2,
               "world4": world4}[scenario](rank, outdir)
        torch.save(out, outdir / f"{scenario}_r{rank}.pt")
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
