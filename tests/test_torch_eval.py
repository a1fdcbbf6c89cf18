"""The port's evaluation entry points against the JAX package's, on the CPU:
``training/bench_eval.py:evaluate_one_epoch_logs`` (plain path, fp32, K = 1
and K = 3 with a ragged tail), the CIFAR-100-C / Tiny-ImageNet-C loaders and
suites of ``data/corruptions.py`` on fake trees, ``tinyimagenet_wnid_to_label``,
and the ``benchmark_eval`` and ``eval_robustness`` CLIs in subprocesses.

Weights go across with ``utils/port_jax.py:load_flax_variables``; inputs are
numpy arrays from a seed. Tolerances: the epoch's loss within 1e-4 of the
JAX one (fp32, sums in another order); top-1/3/5 equal but for the samples
whose k-th and (k+1)-th JAX logits lie within 1e-4 of each other (a flip
there moves the percentage by 100 / n per sample), and 1e-4 for the fp32
rounding of the per-batch percentages.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outgridvit_tpu.data import corruptions as jc
from outgridvit_tpu.data import datasets as jdatasets
from outgridvit_tpu.data.pipeline import ArrayDataLoader as JaxLoader
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.training import bench_eval as jbench
from outgridvit_tpu.training.optim import make_optimizer
from outgridvit_tpu.training.steps import make_eval_step as jax_eval_step
from outgridvit_tpu.training.steps import (
    make_eval_superstep as jax_eval_superstep,
)
from outgridvit_tpu.training.train_state import TrainState as JaxTrainState
from outgridvit_tpu_torch.data import corruptions as tc
from outgridvit_tpu_torch.data import datasets as tdatasets
from outgridvit_tpu_torch.data.pipeline import ArrayDataLoader
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.training import bench_eval as tbench
from outgridvit_tpu_torch.training.steps import (
    make_eval_step,
    make_eval_superstep,
)
from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

ROOT = Path(__file__).resolve().parents[1]
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
METRIC_KEYS = ("loss", "top1", "top3", "top5", "imgs_per_sec",
               "ms_per_batch", "epoch_seconds", "num_images", "params",
               "param_size_mb", "flops_fwd", "mem_gib", "mem_peak_gib")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of small ops: one intra-op thread each, as
    ``tests/test_torch_loop.py`` runs them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def tiny():
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(init)))
    return jmodel, variables


# ---- evaluate_one_epoch_logs -----------------------------------------------

def _epoch_data(n=61, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


def _ambiguous(logits, labels, k):
    """Samples whose top-k membership of the label can flip under a 1e-4
    change of the logits: the k-th and (k+1)-th largest within 1e-4."""
    s = -np.sort(-logits, axis=-1)
    return int((np.abs(s[:, k - 1] - s[:, k]) <= 1e-4).sum())


@pytest.mark.parametrize("k", [1, 3])
def test_evaluate_one_epoch_logs_matches_jax(tiny, k):
    """61 images at batch 8: 7 full batches and a ragged 5 (at K = 3: two
    graphs' worth of groups, one single full batch, the ragged tail)."""
    jmodel, variables = tiny
    images, labels = _epoch_data()
    state = JaxTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=make_optimizer(1e-3))
    want = jbench.evaluate_one_epoch_logs(
        jax_eval_step(jmodel.apply, normalize=NORM), state,
        JaxLoader(images, labels, batch_size=8), verbose=False,
        eval_superstep=jax_eval_superstep(jmodel.apply, normalize=NORM),
        k=k)
    model = load_flax_variables(build_model(TINY, device="cpu"), variables)
    got = tbench.evaluate_one_epoch_logs(
        make_eval_step(model, normalize=NORM), model,
        ArrayDataLoader(images, labels, batch_size=8), verbose=False,
        eval_superstep=make_eval_superstep(model, normalize=NORM, k=k), k=k)

    assert tuple(got) == tuple(want) == METRIC_KEYS
    assert got["num_images"] == want["num_images"] == 61
    assert got["params"] == want["params"]
    assert got["param_size_mb"] == want["param_size_mb"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4
    x = (images.astype(np.float32) / 255.0 - np.asarray(NORM[0])) \
        / np.asarray(NORM[1])
    logits = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    for kk in (1, 3, 5):
        # a flipped sample moves the mean by 100 / 61; the per-batch
        # percentages are fp32 (1e-4 covers their rounding)
        slack = 100.0 * _ambiguous(logits, labels, kk) / 61 + 1e-4
        assert abs(got[f"top{kk}"] - want[f"top{kk}"]) <= slack, kk
    assert np.isnan(got["mem_gib"]) and np.isnan(got["mem_peak_gib"])
    assert got["epoch_seconds"] > 0 and got["imgs_per_sec"] > 0


def test_k1_and_k3_agree_and_flops_are_counted(tiny):
    _, variables = tiny
    images, labels = _epoch_data()
    model = load_flax_variables(build_model(TINY, device="cpu"), variables)
    plain = build_model(TINY, use_kernels=False, device="meta")
    out = []
    for k in (1, 3):
        out.append(tbench.evaluate_one_epoch_logs(
            make_eval_step(model, normalize=NORM), model,
            ArrayDataLoader(images, labels, batch_size=8), verbose=False,
            model_fn=plain,
            example_batch=torch.zeros(8, IMG, IMG, 3, device="meta"),
            eval_superstep=make_eval_superstep(model, normalize=NORM, k=k),
            k=k))
    for key in ("loss", "top1", "top3", "top5", "num_images", "params",
                "flops_fwd"):
        assert out[0][key] == out[1][key], key
    # the classifier's product alone: 8 x 32 x 10 multiply-adds
    assert out[0]["flops_fwd"] > 2 * 8 * 32 * 10
    assert tbench.format_ops(out[0]["flops_fwd"]).endswith("FLOPs")
    assert tbench.flops_of(lambda x: x.no_such_method(),
                           torch.zeros(2)) is None
    assert tbench.format_ops(None) == jbench.format_ops(None) == "n/a"
    assert tbench.format_ops(1.5e9) == jbench.format_ops(1.5e9)


# ---- the corruption loaders and suites -------------------------------------

@pytest.fixture(scope="module")
def fake_c100c(tmp_path_factory):
    """Two corruptions of 50,000 rows (a tiled 1,000-image block, as
    ``tests/test_corruptions.py`` writes them) and labels."""
    tmp = tmp_path_factory.mktemp("c100c")
    base = tmp / "CIFAR-100-C"
    base.mkdir()
    rng = np.random.default_rng(0)
    np.save(base / "labels.npy",
            rng.integers(0, 100, size=50000).astype(np.int64))
    block = rng.integers(0, 255, size=(1000, 32, 32, 3), dtype=np.uint8)
    for name in ("gaussian_noise", "fog"):
        np.save(base / f"{name}.npy", np.tile(block, (50, 1, 1, 1)))
    return tmp


def _same_batches(a, b, limit=None):
    n = 0
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        n += 1
        if limit and n == limit:
            break
    return n


@pytest.mark.parametrize("device_normalize", [False, True])
def test_cifar100c_loader_bitwise_jax(fake_c100c, device_normalize):
    kw = dict(batch_size=1500, device_normalize=device_normalize,
              num_workers=2)
    jl = jc.get_cifar100c_loader("fog", 3, str(fake_c100c), **kw)
    tl = tc.get_cifar100c_loader("fog", 3, str(fake_c100c), **kw)
    assert len(tl) == len(jl) == 7  # 6 x 1500 and a ragged 1000
    assert tl.device_normalize == jl.device_normalize
    assert _same_batches(jl, tl) == 7
    for bad in (0, 6):
        with pytest.raises(ValueError):
            tc.get_cifar100c_loader("fog", bad, str(fake_c100c))
    with pytest.raises(FileNotFoundError):
        tc.get_cifar100c_loader("nonexistent", 1, str(fake_c100c))


def test_cifar100c_loader_requires_10000_rows(tmp_path):
    base = tmp_path / "CIFAR-100-C"
    base.mkdir()
    np.save(base / "labels.npy", np.zeros(49_000, np.int64))
    np.save(base / "fog.npy", np.zeros((49_000, 2, 2, 3), np.uint8))
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="exactly 10000"):
            mod.get_cifar100c_loader("fog", 5, str(tmp_path))


def _stub_eval(loader):
    """A stub evaluate_one_epoch_fn that depends on the loader's data."""
    x, y = next(iter(loader))
    return float(np.asarray(x, np.float64).mean()), {
        "top1": float(y[:7].sum()), "top5": float(len(loader))}


def test_cifar100c_suite_and_summary_equal_jax(fake_c100c):
    kw = dict(corruptions=None, severities=(1, 4), batch_size=2000,
              verbose=False, device_normalize=True)
    want = jc.evaluate_cifar100c_suite(_stub_eval, str(fake_c100c), **kw)
    got = tc.evaluate_cifar100c_suite(_stub_eval, str(fake_c100c), **kw)
    assert got == want and len(got) == 4
    assert ([r["corruption"] for r in got]
            == ["fog", "fog", "gaussian_noise", "gaussian_noise"])
    assert (tc.summarize_corruption_results(got)
            == jc.summarize_corruption_results(want))
    assert tc.summarize_corruption_results([])["n_settings"] == 0


def _write_clean_cifar(data_dir: Path, test_labels):
    base = data_dir / "cifar-100-python"
    base.mkdir(parents=True)
    for split, labels in (("train", [0, 1]), ("test", list(test_labels))):
        payload = {b"data": np.zeros((len(labels), 3072), np.uint8),
                   b"fine_labels": [int(v) for v in labels]}
        with open(base / split, "wb") as f:
            pickle.dump(payload, f)


def test_crosscheck_cifar100c_labels_equal_jax(fake_c100c, tmp_path, capsys):
    c_labels = np.load(fake_c100c / "CIFAR-100-C" / "labels.npy")[:10000]
    _write_clean_cifar(tmp_path / "ok", c_labels)
    _write_clean_cifar(tmp_path / "bad", (c_labels + 1) % 100)
    for sub, expect in (("ok", True), ("bad", False)):
        got = tc.crosscheck_cifar100c_labels(str(fake_c100c),
                                             str(tmp_path / sub))
        want = jc.crosscheck_cifar100c_labels(str(fake_c100c),
                                              str(tmp_path / sub))
        assert got is want is expect
    out = capsys.readouterr().out
    assert out.count("OK") == 2 and out.count("MISMATCH") == 2


@pytest.fixture(scope="module")
def fake_tinyc(tmp_path_factory):
    """Tiny-ImageNet-C with two corruptions, severities 1 and 3, wnids
    n001, n002 and n999 (the last not in the clean set), 3 JPEGs each."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("tinyc")
    rng = np.random.default_rng(0)
    for corr in ("fog", "contrast"):
        for sev in (1, 3):
            for wnid in ("n001", "n002", "n999"):
                d = tmp / "Tiny-ImageNet-C" / corr / str(sev) / wnid
                d.mkdir(parents=True)
                for i in range(3):
                    arr = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    Image.fromarray(arr).save(d / f"{wnid}_{i}.JPEG")
    return tmp


WNIDS = {"n001": 7, "n002": 42}


@pytest.mark.parametrize("device_normalize", [False, True])
def test_tinyc_loaders_bitwise_jax(fake_tinyc, device_normalize):
    assert (tc.list_tinyc_corruptions(str(fake_tinyc))
            == jc.list_tinyc_corruptions(str(fake_tinyc))
            == ["contrast", "fog"])
    kw = dict(batch_size=4, img_size=32, device_normalize=device_normalize,
              num_workers=2)
    jl, jkept = jc.get_tinyimagenet200c_loader_intersection(
        "fog", 3, str(fake_tinyc), WNIDS, **kw)
    tl, tkept = tc.get_tinyimagenet200c_loader_intersection(
        "fog", 3, str(fake_tinyc), WNIDS, **kw)
    assert tkept == jkept == ["n001", "n002"]
    assert tl.device_normalize == jl.device_normalize
    assert _same_batches(jl, tl) == 2  # 6 images at batch 4
    np.testing.assert_array_equal(tl.labels, [7] * 3 + [42] * 3)
    with pytest.raises(ValueError, match="no overlapping"):
        tc.get_tinyimagenet200c_loader_intersection(
            "fog", 1, str(fake_tinyc), {"n555": 0})

    # the clean-182 row: clean test images filtered to the C-set classes
    rng = np.random.default_rng(3)
    clean = rng.integers(0, 255, (20, 64, 64, 3), dtype=np.uint8)
    clean_labels = np.arange(20) % 50
    jl, jset = jc.get_tiny_clean_intersection_loader(
        clean, clean_labels, {"n001": 7, "n002": 42, "n777": 3},
        str(fake_tinyc), **kw)
    tl, tset = tc.get_tiny_clean_intersection_loader(
        clean, clean_labels, {"n001": 7, "n002": 42, "n777": 3},
        str(fake_tinyc), **kw)
    assert tset == jset == {7, 42}
    assert _same_batches(jl, tl) == 1


def test_tinyc_suite_equal_jax(fake_tinyc):
    kw = dict(severities=(1, 3), batch_size=4, img_size=32, verbose=False,
              device_normalize=True)
    want = jc.evaluate_tinyc_suite(_stub_eval, WNIDS, str(fake_tinyc), **kw)
    got = tc.evaluate_tinyc_suite(_stub_eval, WNIDS, str(fake_tinyc), **kw)
    assert got == want and len(got) == 4
    assert all(r["n_classes"] == 2 for r in got)
    assert (tc.summarize_tinyc_results(got)
            == jc.summarize_tinyc_results(want))


def test_tinyimagenet_wnid_to_label_equal_jax(tmp_path):
    import datasets as hf_datasets

    names = ["n01443537", "n01629819", "n01641577"]
    split = hf_datasets.Dataset.from_dict(
        {"label": [0, 1, 2]}, features=hf_datasets.Features(
            {"label": hf_datasets.ClassLabel(names=names)}))
    hf_datasets.DatasetDict({"train": split}).save_to_disk(
        str(tmp_path / "tiny-imagenet"))
    got = tdatasets.tinyimagenet_wnid_to_label(str(tmp_path))
    assert got == jdatasets.tinyimagenet_wnid_to_label(str(tmp_path))
    assert got == {w: i for i, w in enumerate(names)}


# ---- the CLIs --------------------------------------------------------------

def _run(module, *args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_benchmark_eval_cli_writes_the_jax_metric_keys(tmp_path):
    out = tmp_path / "bench.json"
    res = _run("outgridvit_tpu_torch.benchmark_eval", "--config",
               "configs/smoke_synthetic.yaml", "--device", "cpu",
               "--eval-k", "2", "--json-out", str(out))
    assert res.returncode == 0, res.stderr
    m = json.loads(out.read_text())
    assert tuple(m) == METRIC_KEYS
    assert m["num_images"] == 64 and m["flops_fwd"] > 0
    assert all(np.isfinite(m[k]) for k in ("loss", "top1", "top3", "top5"))
    assert "[bench] params" in res.stdout
    res = _run("outgridvit_tpu_torch.benchmark_eval", "--config",
               "configs/smoke_synthetic.yaml", "--device", "cuda")
    if not torch.cuda.is_available():  # no card: refused, no fallback
        assert res.returncode == 2 and "CUDA" in res.stderr


def test_eval_robustness_cli_writes_rows_and_summary(fake_c100c, tmp_path):
    """The smoke config's data and runtime sections with a one-stage model:
    each CIFAR-100-C setting is 10,000 images at 32 px, ~100 s through the
    smoke config's model on one CPU thread."""
    text = (ROOT / "configs/smoke_synthetic.yaml").read_text()
    model = ("model:\n  type: model_a\n  num_classes: 100\n  stem_dim: 4\n"
             "  stages:\n    - {dim: 4, depth: 1, num_heads: 1, "
             "grid_size: 8, outlook_heads: 1}\n\n")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(model + text[text.index("training:"):])
    out = tmp_path / "rob.json"
    res = _run("outgridvit_tpu_torch.eval_robustness", "--config", str(cfg),
               "--device", "cpu", "--suite", "cifar100c", "--data-dir",
               str(fake_c100c), "--corruptions", "fog", "--severities", "2",
               "--batch-size", "1000", "--eval-k", "3", "--json-out",
               str(out))
    assert res.returncode == 0, res.stderr
    got = json.loads(out.read_text())
    assert [(r["corruption"], r["severity"]) for r in got["rows"]] == [
        ("fog", 2)]
    assert set(got["rows"][0]) == {"corruption", "severity", "loss", "top1",
                                   "top3", "top5"}
    assert got["summary"]["n_settings"] == 1
    assert np.isfinite(got["summary"]["overall_top1"])
    assert "=== Robustness summary ===" in res.stdout
