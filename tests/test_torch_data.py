"""Port parity, data layer: ``outgridvit_tpu_torch.utils.config``,
``outgridvit_tpu_torch.data`` and ``utils/history`` against PyYAML and the
JAX package's ``outgridvit_tpu.data`` on the same files and seeds (CPU).

The loaders must yield the JAX loaders' batches bit for bit, in the same
order, over two epochs: CIFAR-100 pickles, SVHN ``.mat``, a Food-101
``save_to_disk`` tree, the Oxford-Pets layout and both synthetic sets, with
host augmentation and with raw uint8 for device augmentation. The fixtures
are written as ``tests/test_data.py`` and ``tests/test_cli.py`` write
theirs. Where the JAX loader ends an epoch early on a transform's error,
the port's raises it in the consumer.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from outgridvit_tpu.data import build_dataloaders as jax_build_dataloaders
from outgridvit_tpu.data import data_utils as jdu
from outgridvit_tpu.data import pipeline as jpipe
from outgridvit_tpu.utils import history as jhistory
from outgridvit_tpu_torch.data import build_dataloaders
from outgridvit_tpu_torch.data import data_utils as tdu
from outgridvit_tpu_torch.data import pipeline as tpipe
from outgridvit_tpu_torch.ops.augment import AugmentConfig
from outgridvit_tpu_torch.training.loop import _group_batches, _super_iter
from outgridvit_tpu_torch.utils import history as thistory
from outgridvit_tpu_torch.utils.config import (
    ConfigError,
    load_config,
    parse_config,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


# ---- the config reader ---------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_safe_load_on_every_config(path):
    want = yaml.safe_load(path.read_text()) or {}
    assert load_config(path) == want


@pytest.mark.parametrize("dump", [
    {}, {"sort_keys": False}, {"default_flow_style": None, "width": 10**6},
    {"default_flow_style": True, "width": 10**6}])
def test_load_config_reads_what_safe_dump_writes(tmp_path, dump):
    cfg = yaml.safe_load((ROOT / "configs" / "cifar100_model_a_7m.yaml")
                         .read_text())
    cfg["extra"] = {
        "quote": "it's", "colon": "a: b", "tight": "x:y", "hash": "a #b",
        "tiny": 1e-6, "big": 1.5e20, "neg": -3, "none": None, "empty": "",
        "str_int": "7", "str_bool": "yes", "path": "/tmp/a b/c",
        "lists": [[1, 2], {"a": [3]}, []], "map": {}, "flag": False,
        "inf": float("inf"),
    }
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg, **dump))
    assert load_config(path) == yaml.safe_load(path.read_text())


def test_load_config_scalars_resolve_as_safe_load():
    text = ("a: 1.0e6\nb: 1e-6\nc: .5\nd: -.inf\ne: on\nf: ~\ng:\n"
            "h: [1, 'a', {x: y}]\ni: \"q\\\"x\"  # comment\nj: Off\n"
            "k: +12\nl: 1_000\nm: 3.\n")
    assert parse_config(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    'a: "x\\" # y"  # c', "a: 'it''s # no'  # c", 'a: "\\\\"  # c',
    "a: b#c # d", "# head\na:  # c\n  - 1  # c\n  - {b: 2}  # c\n"])
def test_load_config_comments_and_quotes_as_safe_load(text):
    assert parse_config(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: 0x10",
    "a: 012", "a: 2020-01-01", "a: 1:30", "a:\n\tb: 1", "a: {b: 1",
    "a: b: c", "a: 1\na: 2", "---\na: 1", "a: 'x", "a:\n  b\n  c",
    "<<: {a: 1}", "a: [1, 2\n  , 3]"])
def test_load_config_refuses_what_it_does_not_read(text):
    with pytest.raises(ConfigError):
        parse_config(text)


# ---- fixtures --------------------------------------------------------------

def _write_cifar(data_dir: Path, n_train=40, n_test=16, classes=10, seed=0):
    base = data_dir / "cifar-100-python"
    base.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        payload = {b"data": rng.integers(0, 255, (n, 3072), dtype=np.uint8),
                   b"fine_labels": (np.arange(n) % classes).tolist()}
        with open(base / split, "wb") as f:
            pickle.dump(payload, f)


def _write_svhn(data_dir: Path, n_train=30, n_test=12, seed=1):
    import scipy.io

    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        scipy.io.savemat(str(data_dir / f"{split}_32x32.mat"), {
            "X": rng.integers(0, 255, (32, 32, 3, n), dtype=np.uint8),
            "y": (np.arange(n) % 10 + 1).reshape(-1, 1)})  # 10 is digit 0


def _write_food101(data_dir: Path):
    import datasets as hf_datasets
    from PIL import Image

    rng = np.random.default_rng(2)

    def split(n):
        imgs = [Image.fromarray(rng.integers(0, 255, (12, 12, 3),
                                             dtype=np.uint8))
                for _ in range(n)]
        return hf_datasets.Dataset.from_dict(
            {"image": imgs, "label": (np.arange(n) % 4).tolist()},
            features=hf_datasets.Features({
                "image": hf_datasets.Image(),
                "label": hf_datasets.ClassLabel(
                    names=[f"c{i}" for i in range(4)])}))

    hf_datasets.DatasetDict({"train": split(12), "validation": split(8)}
                            ).save_to_disk(str(data_dir / "food101"))


def _write_pets(data_dir: Path):
    from PIL import Image

    base = data_dir / "oxford-iiit-pet"
    (base / "images").mkdir(parents=True)
    (base / "annotations").mkdir()
    rng = np.random.default_rng(3)
    trainval, test = [], []
    for i in range(10):
        stem = f"Breed_{i}"
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)
                        ).save(base / "images" / f"{stem}.jpg")
        (trainval if i < 6 else test).append(f"{stem} {i % 3 + 1} 1 1")
    trainval.append("Missing_Image 1 1 1")
    (base / "annotations" / "trainval.txt").write_text("\n".join(trainval))
    (base / "annotations" / "test.txt").write_text("\n".join(test))


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [(np.asarray(x), np.asarray(y)) for x, y in loader]


def _assert_same_loaders(ours, theirs):
    assert (ours[1] is None) == (theirs[1] is None)
    assert (ours[2] is None) == (theirs[2] is None)
    for a, b in zip(ours, theirs):
        if a is None:
            continue
        assert len(a) == len(b)
        for attr in ("device_augment", "device_normalize"):
            got, want = getattr(a, attr, None), getattr(b, attr, None)
            assert (got is None) == (want is None), attr
            if got is not None and attr == "device_augment":
                assert isinstance(got, AugmentConfig)
                assert vars(got) == vars(want)
            elif got is not None:
                assert got == want
        for epoch in (1, 2):
            ga, gb = _batches(a, epoch), _batches(b, epoch)
            assert len(ga) == len(gb) == len(a)
            for (xa, ya), (xb, yb) in zip(ga, gb):
                assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)


CASES = {
    "cifar100_host_augment": (_write_cifar, {
        "dataset": "cifar100", "batch_size": 8, "img_size": 32,
        "val_split": 0.25, "num_workers": 2, "device_augment": False}),
    "cifar100_device_augment": (_write_cifar, {
        "dataset": "cifar100", "batch_size": 8, "img_size": 32,
        "val_split": 0.25, "num_workers": 2, "device_augment": True}),
    "cifar100_resized": (_write_cifar, {
        "dataset": "cifar100", "batch_size": 16, "img_size": 40,
        "num_workers": 1, "ra_num_ops": 3, "ra_magnitude": 9,
        "random_erasing_p": 0.9}),
    "svhn": (_write_svhn, {
        "dataset": "svhn", "batch_size": 8, "val_split": 0.2,
        "num_workers": 2}),
    "svhn_device_augment": (_write_svhn, {
        "dataset": "svhn", "batch_size": 8, "device_augment": True}),
    "food101": (_write_food101, {
        "dataset": "food101", "batch_size": 4, "img_size": 16,
        "val_split": 0.25, "num_workers": 1}),
    "oxfordpets": (_write_pets, {
        "dataset": "pets", "batch_size": 3, "img_size": 16,
        "num_workers": 1}),
    "synthetic": (None, {"dataset": "synthetic", "num_samples": 40,
                         "batch_size": 16, "img_size": 8}),
    "synthetic_device_augment": (None, {
        "dataset": "synthetic", "num_samples": 40, "batch_size": 16,
        "img_size": 8, "device_augment": True}),
    "synthetic_structured": (None, {
        "dataset": "synthetic_structured", "num_samples": 48,
        "batch_size": 16, "img_size": 16, "val_split": 0.25,
        "noise": 30.0}),
    "synthetic_structured_host_augment": (None, {
        "dataset": "synthetic_structured", "num_samples": 48,
        "batch_size": 16, "img_size": 16, "device_augment": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaders_bitwise_equal_jax_over_two_epochs(tmp_path, case):
    write, cfg = CASES[case]
    cfg = dict(cfg, data_dir=str(tmp_path), seed=5)
    if write is not None:
        write(tmp_path)
    ours = build_dataloaders(cfg, num_classes=10, seed=7)
    theirs = jax_build_dataloaders(cfg, num_classes=10, seed=7)
    _assert_same_loaders(ours, theirs)


def test_registry_rejects_unknown_dataset_as_jax():
    with pytest.raises(ValueError) as ours:
        build_dataloaders({"dataset": "mnist"}, 10)
    with pytest.raises(ValueError) as theirs:
        jax_build_dataloaders({"dataset": "mnist"}, 10)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("dataset", ["cifar100", "svhn", "pets", "food101",
                                     "tinyimagenet200"])
def test_missing_files_raise_file_not_found(tmp_path, dataset):
    with pytest.raises(FileNotFoundError):
        build_dataloaders({"dataset": dataset,
                           "data_dir": str(tmp_path / "nope")}, 10)


# ---- pipeline pieces -------------------------------------------------------

def test_peek_loader_one_shot_and_reiterable():
    batches = [(np.full((2, 4, 4, 3), i, np.float32), np.array([i, i]))
               for i in range(3)]

    class OneShot:
        def __init__(self):
            self._it = iter(batches)

        def __iter__(self):
            return self._it

    first, it = tpipe.peek_loader(OneShot())
    assert first[1][0] == 0
    assert [int(y[0]) for _, y in it] == [0, 1, 2]
    loader = tpipe.ArrayDataLoader(np.zeros((6, 4, 4, 3), np.uint8),
                                   np.arange(6), batch_size=2, num_threads=1)
    first, it2 = tpipe.peek_loader(loader)
    assert it2 is loader and sum(len(y) for _, y in it2) == 6


@pytest.mark.parametrize("lookahead", [1, 4])
def test_array_loader_matches_jax_with_a_transform(lookahead):
    from outgridvit_tpu.data.transforms import EvalTransform as JEval

    from outgridvit_tpu_torch.data.transforms import EvalTransform

    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (21, 8, 8, 3), dtype=np.uint8)
    labels = np.arange(21) % 4
    kw = dict(batch_size=8, shuffle=True, seed=3, num_threads=2,
              lookahead=lookahead)
    ours = tpipe.ArrayDataLoader(
        images, labels, transform=EvalTransform(8, (0.5,) * 3, (0.25,) * 3),
        drop_last=True, **kw)
    theirs = jpipe.ArrayDataLoader(
        images, labels, transform=JEval(8, (0.5,) * 3, (0.25,) * 3),
        drop_last=True, **kw)
    assert len(ours) == len(theirs) == 2
    for epoch in (1, 2):
        for (xa, ya), (xb, yb) in zip(_batches(ours, epoch),
                                      _batches(theirs, epoch)):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_prefetcher_on_the_cpu_passes_batches_through():
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 255, (3, 4, 4, 3), dtype=np.uint8),
                np.arange(3, dtype=np.int32)) for _ in range(3)]
    batches.append((np.stack([batches[0][0]] * 2),
                    np.stack([batches[0][1]] * 2)))  # a [K, B] superbatch
    got = list(tpipe.Prefetcher(iter(batches), device="cpu"))
    assert len(got) == len(batches)
    for (x, y), (xn, yn) in zip(got, batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), xn)
        np.testing.assert_array_equal(y.numpy(), yn)


def test_group_batches_stacks_full_runs_and_passes_the_rest():
    def b(n, v):
        return np.full((n, 2), v), np.full((n,), v)

    stream = [b(4, 0), b(4, 1), b(4, 2), b(4, 3), b(4, 4), b(2, 5)]
    out = list(_group_batches(iter(stream), 2, 4))
    assert [o[1].shape for o in out] == [(2, 4), (2, 4), (4,), (2,)]
    np.testing.assert_array_equal(out[1][1][:, 0], [2, 3])
    loader = tpipe.ArrayDataLoader(np.zeros((22, 2, 2, 3), np.uint8),
                                   np.arange(22), batch_size=4,
                                   num_threads=1)
    shapes = [y.shape for _, y in _super_iter(loader, 2)]
    assert shapes == [(2, 4), (2, 4), (4,), (2,)]
    assert list(_super_iter([], 2)) == []


# ---- data_utils and history ------------------------------------------------

def test_describe_loader_and_unnormalize_match_jax(capsys):
    rng = np.random.default_rng(1)
    loader = tpipe.ArrayDataLoader(
        rng.standard_normal((10, 4, 4, 3)).astype(np.float32),
        np.arange(10) % 3, batch_size=4, num_threads=1)
    ours = tdu.describe_loader(loader, "x")
    out_ours = capsys.readouterr().out
    theirs = jdu.describe_loader(loader, "x")
    assert ours == theirs and out_ours == capsys.readouterr().out
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tdu.unnormalize(x, (0.5,) * 3, (0.25,) * 3),
        jdu.unnormalize(x, (0.5,) * 3, (0.25,) * 3))


def test_history_round_trips_and_reads_across(tmp_path):
    history = {"train_loss": [1.5, 1.25], "val_top1": [], "lr": [1e-3, 5e-4],
               "train_mem_alloc_gib": [float("nan")] * 2}
    path = tmp_path / "sub" / "h.pkl"
    thistory.save_history(history, str(path))
    for load in (thistory.load_history, jhistory.load_history):
        got = load(str(path))
        assert got.keys() == history.keys()
        assert got["train_loss"] == history["train_loss"]
        assert np.isnan(got["train_mem_alloc_gib"]).all()
    with pytest.raises(ValueError, match="no non-empty keys"):
        thistory.plot_convergence({"a": {"val_top1": []}})


def test_array_loader_reraises_a_transform_error():
    """A transform that raises in the producer thread (lookahead > 1) or
    inline ends the epoch with its exception in the consumer, after the
    batches before the bad image."""
    images = np.zeros((10, 4, 4, 3), np.uint8)
    images[7] = 1

    def transform(img, rng):
        if img.any():
            raise ValueError("bad image")
        return img.astype(np.float32)

    for threads, lookahead in ((1, 4), (4, 4), (1, 1)):
        loader = tpipe.ArrayDataLoader(
            images, np.zeros(10), batch_size=3, transform=transform,
            num_threads=threads, lookahead=lookahead)
        seen = []
        with pytest.raises(ValueError, match="bad image"):
            for x, _ in loader:
                seen.append(x.shape[0])
        assert seen == [3, 3]  # the batches before the bad one
