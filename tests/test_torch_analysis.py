"""Port parity, attention analysis: ``outgridvit_tpu_torch/experiments``
(capture, MAD / entropy, heatmaps) and the CLIs ``run_attention_analysis``
/ ``run_ablations`` against ``outgridvit_tpu/experiments`` and
``scripts/`` on the same weights and numpy inputs (CPU, fp32; the tiny
models of ``tests/test_experiments.py``: two narrow stages, 8 px).

- ``capture_attention`` of Model A and Model B (front keys) in the ``xla``,
  ``fused_agg`` and ``fused_outlook`` modes against the JAX capture with
  the same ``use_pallas`` (its Pallas kernels in interpret mode): the same
  keys, shapes, ``grid_hw`` / ``g`` / ``meta``, values within 1e-5. Capture
  takes JAX's paths: the grid attention off its kernels at every N,
  ``fused_outlook`` off #9, ``fused_agg`` still through #7.
- The MAD / entropy rows of the same models and batches: equal keys,
  values within 1e-5.
- The heatmap helpers equal to JAX's; the plot functions write their
  files, and raise ImportError without matplotlib.
- Both CLIs in subprocesses on ``configs/smoke_synthetic.yaml`` with
  ``--device cpu``: the JAX CLI's row schema and row count.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.experiments import capture as jcapture
from outgridvit_tpu.experiments import heatmaps as jheat
from outgridvit_tpu.experiments import mad_entropy as jmad
from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu_torch.experiments import capture as tcapture
from outgridvit_tpu_torch.experiments import heatmaps as theat
from outgridvit_tpu_torch.experiments import mad_entropy as tmad
from outgridvit_tpu_torch.models import blocks, build_model, layers
from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke_synthetic.yaml"
STAGES = [
    {"dim": 8, "depth": 2, "num_heads": 2, "grid_size": 2,
     "outlook_heads": 2, "mlp_ratio": 2.0, "mbconv_expand_ratio": 2.0},
    {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
     "outlook_heads": 2, "mlp_ratio": 2.0, "mbconv_expand_ratio": 2.0},
]
CFGS = {
    "a": {"type": "model_a", "num_classes": 10, "stem_dim": 8,
          "stages": STAGES},
    "b": {"type": "model_b", "num_classes": 10, "stem_dim": 8,
          "outlooker_front_depth": 2, "stages": STAGES},
}
MODES = {"xla": False, "fused_agg": "fused_agg",
         "fused_outlook": "fused_outlook"}
IMG, BATCH = 8, 4
FIELDS = ("outlook_logits", "grid_attn", "grid_hw", "g", "meta")
# the kernel ops of models/blocks.py
SPIED = ("grid_mhsa_autograd", "grid_mhsa_packed_autograd",
         "attn_branch_autograd", "attn_branch_nhwc_autograd",
         "outlook_agg_proj_autograd", "outlook_branch_autograd",
         "outlook_softmax_autograd")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, IMG, IMG, 3)).astype(np.float32)


def _loader():
    """Two numpy batches, the shape of a loader to the samplers."""
    return [(_images(s), np.arange(BATCH) % 10) for s in (1, 2)]


@pytest.fixture(scope="module", params=[(m, mode) for m in CFGS
                                        for mode in MODES])
def pair(request):
    """(JAX model, variables, port model, model key, mode) on one set of
    weights."""
    key, mode = request.param
    cfg = dict(CFGS[key], use_pallas=MODES[mode])
    jmodel = jax_build_model(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, IMG, IMG, 3)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    port = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jmodel, variables, port, key, mode


def _spies(monkeypatch):
    """Count the calls of each kernel op the blocks reach."""
    calls = {}
    for mod, names in ((blocks, SPIED), (layers, ("mlp_branch_autograd",))):
        for name in names:
            real = getattr(mod, name)
            calls[name] = 0

            def spy(*a, real=real, name=name):
                calls[name] += 1
                return real(*a)

            monkeypatch.setattr(mod, name, spy)
    return calls


def _jax_capture(jmodel, variables, x):
    with pltpu.force_tpu_interpret_mode():
        return jcapture.capture_attention(jmodel, variables, jnp.asarray(x))


def test_capture_matches_jax(pair, monkeypatch):
    jmodel, variables, port, key, mode = pair
    x = _images(0)
    calls = _spies(monkeypatch)
    got = tcapture.capture_attention(port, x)
    want = _jax_capture(jmodel, variables, x)
    stage_keys = {(0, 0), (0, 1), (1, 0)}
    assert set(got) == set(want) == (
        stage_keys | ({("front", 0), ("front", 1)} if key == "b" else set()))
    for k in want:
        for f in FIELDS:
            a, b = got[k][f], want[k][f]
            if isinstance(b, np.ndarray):
                assert a.shape == b.shape and a.dtype == np.float32, (k, f)
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{k} {f}")
            else:
                assert a == b, (k, f, a, b)
    if key == "a":
        assert got[(0, 0)]["outlook_logits"].shape == (BATCH, 8, 8, 2, 9)
        assert got[(0, 0)]["grid_attn"].shape == (BATCH * 4, 2, 16, 16)
        np.testing.assert_allclose(got[(0, 0)]["grid_attn"].sum(-1), 1.0,
                                   atol=1e-5)
    # the paths JAX's capture takes: no grid kernel, no fused softmax; the
    # fused aggregate + projection and the MLP branches stay
    n_outlook = 3 if key == "a" else 2
    assert calls == dict(
        {n: 0 for n in SPIED},
        outlook_agg_proj_autograd=n_outlook if mode == "fused_agg" else 0,
        mlp_branch_autograd=0 if mode == "xla" else n_outlook + 3)


def test_capture_needs_eval_mode_and_restores_the_mode():
    from outgridvit_tpu_torch.models.blocks import recording

    model = build_model(CFGS["a"], device="cpu").train()
    tcapture.capture_attention(model, _images(0))
    assert model.training
    with pytest.raises(RuntimeError, match="eval mode"):
        with torch.no_grad(), recording({}):
            model(torch.from_numpy(_images(0)))


def _assert_rows(got, want):
    assert len(got) == len(want)
    for r, w in zip(got, want):
        assert list(r) == list(w)
        for f, v in w.items():
            assert (r[f] == pytest.approx(v, abs=1e-5, rel=1e-5)
                    if isinstance(v, float) else r[f] == v), f


def test_mad_entropy_rows_match_jax(pair):
    jmodel, variables, port, key, mode = pair
    stages = ((("front",) if key == "b" else ()) + (0, 1))
    kw = dict(block_idx=0, stages=stages, n_images=3, seed=10, grid_n_q=4,
              out_n_xy=8)
    got = tmad.compute_grid_and_outlooker_mad_entropy_by_stage(
        port, _loader(), **kw)
    with pltpu.force_tpu_interpret_mode():
        want = jmad.compute_grid_and_outlooker_mad_entropy_by_stage(
            jmodel, variables, _loader(), **kw)
    assert len(got) == len(stages)
    _assert_rows(got, want)
    if key == "b":
        # the front outlookers have no grid attention
        assert got[0]["stage"] == "front" and got[0]["MAD_grid_mean"] is None
        assert got[0]["MAD_outlook_mean"] is not None


def test_mad_entropy_pipeline_matches_jax():
    cfg = dict(CFGS["a"], use_pallas=False)
    jmodel = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)))))
    port = load_flax_variables(build_model(cfg, device="cpu"), variables)
    kw = dict(seeds=(10, 20), stages=(0, 1), blocks=(0, 1), n_images=2,
              grid_n_q=4, out_n_xy=8)
    got = tmad.run_mad_entropy_pipeline(port, _loader(), **kw)
    want = jmad.run_mad_entropy_pipeline(jmodel, variables, _loader(), **kw)
    # block 1 exists in stage 0 only: the missing (stage 1, block 1) warns
    assert len(got) == 2 * 3
    _assert_rows(got, want)
    # the MAD-only rows (no entropy columns)
    kw = dict(block_idx=1, stages=(0, 1), n_images=4, seed=7, grid_n_q=4,
              out_n_xy=8)
    got = tmad.compute_grid_and_outlooker_mad_by_stage(port, _loader(), **kw)
    _assert_rows(got, jmad.compute_grid_and_outlooker_mad_by_stage(
        jmodel, variables, _loader(), **kw))
    assert len(got) == 1 and "Hn_grid_mean" not in got[0]


def test_mad_printer_matches_jax(capsys):
    rows = json.loads(json.dumps([
        {"stage": s, "MAD_grid_abs_mean": g, "MAD_outlook_abs_mean": o,
         "grid_denom": d}
        for s, g, o, d in (("front", None, 1.2, None), (0, 8.1, 1.3, 30.0),
                           (0, 7.9, 1.1, 30.0), (1, 3.9, None, 14.0))]))
    tmad.print_mad_abs_by_stage_simple(rows)
    got = capsys.readouterr().out
    jmad.print_mad_abs_by_stage_simple(rows)
    assert got == capsys.readouterr().out and "stage front" in got


def test_heatmap_helpers_match_jax():
    rng = np.random.default_rng(0)
    for fm, out in [((4, 4), (8, 8)), ((4, 4), (9, 9)), ((3, 5), (10, 14)),
                    ((8, 8), (8, 8))]:
        m = rng.standard_normal(fm).astype(np.float32)
        assert np.array_equal(theat._upsample_map(m, out),
                              jheat._upsample_map(m, out))
        for k in (1, 3, 5):
            assert np.array_equal(theat._box_smooth(m, k),
                                  jheat._box_smooth(m, k))
    Hg, Wg, g, heads = 4, 3, 2, 2
    attn = rng.random((2 * g * g, heads, Hg * Wg, Hg * Wg)).astype(
        np.float32)
    for b, gy, gx, q in ((0, 0, 0, 5), (1, 1, 0, 0), (1, 1, 1, 11)):
        assert np.array_equal(
            theat._grid_query_heatmap(attn, Hg, Wg, g, b, gy, gx, q),
            jheat._grid_query_heatmap(attn, Hg, Wg, g, b, gy, gx, q))
    for args in ((0, 0, (4, 4), (32, 32)), (3, 1, (8, 6), (64, 48))):
        assert theat._fm_to_img_xy(*args) == jheat._fm_to_img_xy(*args)
    img = rng.random((8, 8, 3)).astype(np.float32)
    assert np.array_equal(theat._unnormalize(img, (0.5,) * 3, (0.2,) * 3),
                          jheat._unnormalize(img, (0.5,) * 3, (0.2,) * 3))
    caps = {(0, 0): {"outlook_logits": 1, "grid_attn": None},
            (0, 1): {"outlook_logits": 1, "grid_attn": 1},
            ("front", 0): {"outlook_logits": 1, "grid_attn": None},
            (1, 0): {"outlook_logits": None, "grid_attn": 1}}
    for field in ("outlook_logits", "grid_attn"):
        for sel in ("all", 0, 1, [0, 1], (2,)):
            assert theat._blocks_to_plot(caps, field, sel) == \
                jheat._blocks_to_plot(caps, field, sel)
    with pytest.raises(ValueError):
        theat._blocks_to_plot(caps, "grid_attn", "some")
    loader = _loader()
    assert np.array_equal(theat._pick_batch(loader, 3, 4),
                          jheat._pick_batch(loader, 3, 4))


def test_plots_write_files_and_need_matplotlib(tmp_path, monkeypatch):
    port = build_model(CFGS["b"], device="cpu")
    kw = dict(n_images=1, seed=0, mean=(0, 0, 0), std=(1, 1, 1),
              out_dir=str(tmp_path), block_idx="all")
    p1 = theat.plot_outlooker_locality_random(port, _loader(), **kw)
    p2 = theat.plot_grid_attention_random(port, _loader(), **kw)
    names = sorted(Path(p).name for p in p1 + p2)
    # Model B's outlookers are its front ("stage front"), its grids the
    # stages' blocks
    assert names == ["grid_stage0.png", "grid_stage0_block1.png",
                     "grid_stage1.png", "outlooker_stagefront.png",
                     "outlooker_stagefront_block1.png"]
    assert all(os.path.getsize(p) > 1000 for p in p1 + p2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        theat.plot_grid_attention_random(port, _loader(), **kw)


# ---- the CLIs, in subprocesses --------------------------------------------

def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_attention_analysis_cli_matches_the_jax_cli(tmp_path):
    common = ["--config", str(SMOKE), "--skip-plots", "--entropy",
              "--block", "all"]
    _run([str(ROOT / "scripts" / "run_attention_analysis.py"), *common,
          "--out-dir", str(tmp_path / "jax")], ROOT)
    out = _run(["-m", "outgridvit_tpu_torch.run_attention_analysis",
                *common, "--device", "cpu", "--out-dir",
                str(tmp_path / "port")], ROOT)
    assert "=== MAD (ABS) by stage" in out
    want = json.loads((tmp_path / "jax" / "mad_metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "mad_metrics.json").read_text())
    assert len(got) == len(want) == 2
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["stage"], r["block"]) for r in got] == \
        [(r["stage"], r["block"]) for r in want]
    for r in got:
        assert 0.0 <= r["MAD_grid_abs_mean"] <= r["grid_denom"]
        assert 0.0 <= r["MAD_outlook_abs_mean"] <= 2.0
        assert 0.0 <= r["Hn_grid_mean"] <= 1.0 + 1e-6
        assert 0.0 <= r["Hn_outlook_mean"] <= 1.0 + 1e-6
    with open(tmp_path / "port" / "mad_metrics.csv") as f:
        header = next(csv.reader(f))
    with open(tmp_path / "jax" / "mad_metrics.csv") as f:
        assert header == next(csv.reader(f))


def test_analysis_cli_refuses_a_missing_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for mod in ("run_attention_analysis", "run_ablations"):
        out = subprocess.run(
            [sys.executable, "-m", f"outgridvit_tpu_torch.{mod}",
             "--config", str(SMOKE)], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 2, (mod, out.stderr)
        assert "--device cpu" in out.stderr


def test_ablation_cli_matches_the_jax_cli(tmp_path):
    from outgridvit_tpu_torch.run_ablations import ABLATIONS

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import run_ablations as jab
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert ABLATIONS == jab.ABLATIONS
    pick = ["no_outlooker", "plain_mbconv"]
    _run([str(ROOT / "scripts" / "run_ablations.py"), "--config",
          str(SMOKE), "--ablations", *pick, "--output-dir",
          str(tmp_path / "jax"), "--json-out", str(tmp_path / "jax.json")],
         ROOT)
    want = json.loads((tmp_path / "jax.json").read_text())
    for names, tag in ((pick, "pick"), (list(ABLATIONS), "all")):
        out = _run(["-m", "outgridvit_tpu_torch.run_ablations", "--config",
                    str(SMOKE), "--device", "cpu", "--ablations", *names,
                    "--output-dir", str(tmp_path / tag), "--json-out",
                    str(tmp_path / f"{tag}.json")], ROOT)
        got = json.loads((tmp_path / f"{tag}.json").read_text())
        assert list(got) == names
        assert all(list(r) == list(want[pick[0]]) for r in got.values())
        assert all(np.isfinite(r["final_train_top1"]) for r in got.values())
        for n in names:
            assert f"##### Ablation: {n} #####" in out
            # the smoke config has no val split, so no best checkpoint
            for f in (f"history_{n}.pkl", f"last_{n}.ckpt"):
                assert (tmp_path / tag / f).exists(), f
    assert list(want) == pick
