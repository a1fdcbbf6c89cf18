"""Port parity, data × model parallelism, in one process (no process group):
the twins of ``tests/test_distributed.py``'s loader and row tests and of
``tests/test_sharding.py``'s rule tests, and the pieces the parallel step
is built from.

- ``ArrayDataLoader(process_id=, process_count=)``: the ranks' rows
  concatenate to the global batches; a batch that does not divide raises.
- ``local_row_slice`` partitions a batch.
- ``_TP_RULES`` on the port's parameters (``param_shard_dims``) shard the
  leaves JAX's ``param_pspec`` shards, on the port's dim of the flax dim
  (a Dense kernel ``[in, out]`` is the port's ``[out, in]``), at full width
  for the 7M config and Model B.
- A rank's drop-path and dropout masks are its rows of the global ones;
  ``local_draws`` takes a rank's rows of every per-image draw.
- The refusals: a mesh that is not the port's, a predictor batch that does
  not divide over the data axis, a mesh shape that is not the world's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outgridvit_tpu.data.pipeline import ArrayDataLoader as JaxLoader
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.parallel.mesh import param_pspec as jax_param_pspec
from outgridvit_tpu_torch.data.pipeline import ArrayDataLoader
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops.augment import AugmentConfig
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.dropout import HashedDropout
from outgridvit_tpu_torch.parallel import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    local_row_slice,
    make_mesh,
    param_pspec,
    shard_loader_for_process,
    shard_model,
    superbatch_sharding,
)
from outgridvit_tpu_torch.parallel.collectives import Axis
from outgridvit_tpu_torch.parallel.mesh import (
    flax_param_path,
    param_shard_dims,
)
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    local_draws,
    sample_step_draws,
)
from outgridvit_tpu_torch.utils.config import load_config
from outgridvit_tpu_torch.utils.port_jax import torch_key

ROOT = Path(__file__).resolve().parents[1]


def _fake_mesh(data: int, model: int = 1, index: int = 0) -> Mesh:
    """A mesh as one rank of a (data, model) world sees it, without
    process groups (nothing here runs a collective)."""
    return Mesh(np.arange(data * model).reshape(data, model),
                Axis(None, data, index), Axis(None, model, 0), None, None)


# ---- loaders and rows -------------------------------------------------------

def test_loader_process_split_covers_global_batches():
    """The ranks' rows, concatenated in rank order, are the unsplit
    loader's global batches (drop_last), bitwise the JAX loader's."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (37, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(37,))

    def make(cls, pid=None, pcount=None):
        loader = cls(images, labels, batch_size=8, shuffle=True, seed=3,
                     num_threads=1, process_id=pid, process_count=pcount)
        loader.set_epoch(2)
        return loader

    ref = make(ArrayDataLoader)
    ref.drop_last = True
    parts = [make(ArrayDataLoader, p, 2) for p in range(2)]
    jparts = [make(JaxLoader, p, 2) for p in range(2)]
    assert len(parts[0]) == len(ref) == 4 and parts[0].drop_last
    for (gx, gy), *split in zip(ref, *parts, *jparts):
        (x0, y0), (x1, y1), (j0, _), (j1, _) = split
        np.testing.assert_array_equal(np.concatenate([x0, x1]), gx)
        np.testing.assert_array_equal(np.concatenate([y0, y1]), gy)
        np.testing.assert_array_equal(x0, j0)
        np.testing.assert_array_equal(x1, j1)
    with pytest.raises(ValueError, match="not divisible"):
        ArrayDataLoader(images, labels, batch_size=9, process_id=0,
                        process_count=2)
    with pytest.raises(ValueError, match="out of range"):
        ArrayDataLoader(images, labels, batch_size=8, process_id=2,
                        process_count=2)


def test_shard_loader_splits_per_data_rank():
    """Ranks of one model group load the same rows: the split follows the
    mesh's data axis, not the process count."""
    images = np.zeros((32, 4, 4, 3), np.uint8)
    labels = np.arange(32)
    loader = ArrayDataLoader(images, labels, batch_size=8, num_threads=1)
    assert shard_loader_for_process(loader, _fake_mesh(1, 2)) is loader
    assert loader.process_count == 1
    shard_loader_for_process(loader, _fake_mesh(2, 2, index=1))
    assert (loader.process_count, loader.process_id) == (2, 1)
    assert [y.tolist() for _, y in loader][0] == [4, 5, 6, 7]
    assert shard_loader_for_process(None, _fake_mesh(2)) is None
    with pytest.raises(ValueError, match="not divisible"):
        shard_loader_for_process(ArrayDataLoader(
            images, labels, batch_size=9), _fake_mesh(2))


def test_local_row_slice_partitions_batch():
    slices = [local_row_slice(12, pid=p, pcount=3) for p in range(3)]
    rows = np.arange(12)
    np.testing.assert_array_equal(
        np.concatenate([rows[s] for s in slices]), rows)
    assert batch_sharding(_fake_mesh(2, 2, index=1)).rows(12) == slice(6, 12)
    x = torch.arange(2 * 12).reshape(2, 12)
    np.testing.assert_array_equal(
        superbatch_sharding(_fake_mesh(3, index=2)).local(x), x[:, 8:])
    with pytest.raises(ValueError):
        local_row_slice(10, pid=0, pcount=3)


# ---- the tensor-parallel rules ----------------------------------------------

def _jax_shapes(cfg):
    jmodel = jax_build_model(cfg, use_pallas=False)
    img = 32
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, img, img, 3)))["params"]


@pytest.mark.parametrize("config", ["cifar100_model_a_7m.yaml",
                                    "cifar100_model_b.yaml"])
@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_rules_shard_the_leaves_jax_shards(config, model_size):
    """Every flax leaf JAX's ``param_pspec`` shards is sharded in the port
    under the bridge's name, on the port's dim; no other leaf is."""
    cfg = load_config(ROOT / "configs" / config)["model"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            _jax_shapes(cfg))[0]:
        names = tuple(getattr(k, "key", str(k)) for k in path)
        spec = tuple(jax_param_pspec(path, leaf, model_size))
        assert spec == param_pspec("/".join(names), leaf.shape, model_size)
        if "model" in spec:
            fd = spec.index("model")
            pd = {2: (1, 0), 4: (2, 3, 1, 0)}.get(leaf.ndim,
                                                  range(leaf.ndim))[fd]
            want[torch_key(names)] = pd
    model = build_model(cfg, device="meta")
    got = param_shard_dims(model, model_size)
    assert want and got == want
    for name, dim in got.items():
        assert dict(model.named_parameters())[name].shape[dim] \
            % model_size == 0


def test_flax_param_path_through_the_bridge():
    assert flax_param_path("classifier.weight") == "classifier/kernel"
    assert flax_param_path("stages.0.1.mlp.fc1.bias") == "…/mlp/fc1/bias"
    assert (flax_param_path("stages.2.0.mbconv.expand.0.weight")
            == "…/mbconv/expand/kernel")
    assert (flax_param_path("stages.0.0.grid_attn.mhsa.proj.weight")
            == "…/grid_attn/mhsa/proj/kernel")
    assert flax_param_path("head_norm.running_mean") is None
    assert param_pspec("…/mbconv/expand/kernel", (64, 96), 2) == (
        None, "model")
    assert param_pspec("…/mbconv/expand/kernel", (64, 95), 2) == ()
    assert param_pspec("…/mlp/fc1/kernel", (64, 96), 1) == ()


# ---- a rank's draws and masks ------------------------------------------------

def test_local_draws_are_the_rows_of_the_global_draws():
    cfg = StepConfig(num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0,
                     augment=AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3,
                                           crop_pad=2))
    order = [("a/dp1", 0.3), ("b/dp2", 0.5)]
    full = sample_step_draws(torch.Generator().manual_seed(1), cfg,
                             (8, 16, 16, 3), drop_order=order)
    rows = (slice(4, 8), 8)
    part = local_draws(sample_step_draws(
        torch.Generator().manual_seed(1), cfg, (8, 16, 16, 3),
        drop_order=order), rows)
    for f, a, b in zip(full.augment._fields, full.augment, part.augment):
        if a is None:
            assert b is None
            continue
        want = a[:, 4:8] if f in ("op_ids", "signs") else a[4:8]
        assert torch.equal(b, want), f
    for f, a, b in zip(full.mix._fields, full.mix, part.mix):
        assert torch.equal(a, b), f  # the mix runs on the gathered batch
    for p, m in full.drop_masks.masks.items():
        assert torch.equal(part.drop_masks.masks[p], m[4:8])
    # a mask generator draws the global batch and keeps the rows
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    whole = DropPathMasks(generator=g1).get("a", 0.3, 8, "cpu")
    mine = DropPathMasks(generator=g2, rows=(slice(2, 4), 8)).get(
        "a", 0.3, 2, "cpu")
    assert torch.equal(mine, whole[2:4])


@pytest.mark.parametrize("shape", [(8, 5, 3), (8 * 4, 16, 2)])
def test_hashed_dropout_rows_are_the_rows_of_the_global_mask(shape):
    """A data rank's dropout masks are its rows of the single device's:
    the global flat index of a batch-major tensor ``[B * grids, ...]``."""
    step = torch.tensor(3, dtype=torch.int32)
    whole = HashedDropout(9, step).keep("s/Dropout_0", 0.3, shape, "cpu")
    per = shape[0] // 8
    for first, count in ((0, 4), (4, 4), (2, 2)):
        mine = HashedDropout(9, step, rows=(first, count)).keep(
            "s/Dropout_0", 0.3, (count * per,) + shape[1:], "cpu")
        assert torch.equal(mine, whole[first * per:(first + count) * per])
    with pytest.raises(ValueError, match="batch rows"):
        HashedDropout(9, step, rows=(0, 3)).keep("s", 0.3, (4, 2), "cpu")


# ---- meshes and refusals -----------------------------------------------------

def test_make_mesh_without_a_process_group(monkeypatch):
    for k in ("OUTGRIDVIT_COORDINATOR", "OUTGRIDVIT_NUM_PROCESSES",
              "OUTGRIDVIT_PROCESS_ID", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False  # a world of one
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.active
    assert (mesh.data.size, mesh.model.size) == (1, 1)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 1))
    model = build_model({"type": "model_a", "num_classes": 10,
                         "stages": [{"dim": 16, "depth": 1, "num_heads": 2,
                                     "grid_size": 2, "outlook_heads": 2}]},
                        device="cpu")
    assert shard_model(model, mesh) is model  # no group: nothing changes
    assert getattr(model, "parallel_mesh", None) is None
    with pytest.raises(TypeError, match="parallel.Mesh"):
        shard_model(model, object())


def test_build_predictor_refuses_a_bad_mesh():
    from outgridvit_tpu_torch.serving import build_predictor

    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8,
           "stages": [{"dim": 16, "depth": 1, "num_heads": 2,
                       "grid_size": 2, "outlook_heads": 2}]}
    with pytest.raises(ValueError, match="must divide over the data axis"):
        build_predictor(cfg, batch_size=15, img_size=8, device="cpu",
                        mesh=_fake_mesh(2))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        build_predictor(cfg, batch_size=16, img_size=8, device="cpu",
                        mesh=object())


def test_train_model_refuses_loaders_not_split_for_the_mesh(tmp_path):
    """A loader must yield the mesh's data rank's rows: an unsplit loader
    on a data axis of two ranks, or one split for another data rank,
    raises before any step (it would train on duplicated rows)."""
    from outgridvit_tpu_torch.training.loop import train_model

    model = build_model({"type": "model_a", "num_classes": 10,
                         "stem_dim": 8,
                         "stages": [{"dim": 16, "depth": 1, "num_heads": 2,
                                     "grid_size": 2, "outlook_heads": 2}]},
                        dtype=torch.float32, device="cpu")
    images = np.zeros((16, 8, 8, 3), np.uint8)
    labels = np.zeros((16,), np.int64)
    kw = dict(epochs=1, device="cpu", use_amp=False,
              save_path=str(tmp_path / "b"), last_path=str(tmp_path / "l"))
    unsplit = ArrayDataLoader(images, labels, batch_size=8, num_threads=1)
    with pytest.raises(ValueError, match="train loader yields data rank 0 "
                       "of 1"):
        train_model(model, unsplit, mesh=_fake_mesh(2), **kw)
    rank1 = ArrayDataLoader(images, labels, batch_size=8, num_threads=1,
                            process_id=1, process_count=2)
    with pytest.raises(ValueError, match="val loader yields data rank 1"):
        train_model(model, shard_loader_for_process(
            ArrayDataLoader(images, labels, batch_size=8, num_threads=1),
            _fake_mesh(2)), val_loader=rank1, mesh=_fake_mesh(2), **kw)
