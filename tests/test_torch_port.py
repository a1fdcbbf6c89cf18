"""Port plumbing: weights and train state across both ways, strictness,
independence from JAX, kernel dispatch rules, the kernel build's cache key,
and chip_smoke.py's flagship config and its refusal to run without a
card."""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.utils.port_torch import port_torch_state_dict
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
    load_jax_train_state,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "type": "model_a", "num_classes": 10, "stem_dim": 8,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 2, "num_heads": 4, "grid_size": 2,
         "outlook_heads": 4},
    ],
}


@pytest.fixture(scope="module")
def jax_variables():
    model = jax_build_model(SMALL, use_pallas=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))


def test_weights_roundtrip_jax_port_jax(jax_variables):
    port = load_flax_variables(build_model(SMALL, device="cpu"),
                               jax_variables)
    back = port_torch_state_dict(port.state_dict(), jax_variables,
                                 strict=True)
    want = jax.tree_util.tree_leaves_with_path(jax_variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_flax_variables_is_strict(jax_variables, fault):
    v = {c: jax.tree_util.tree_map(lambda a: a, dict(t))
         for c, t in jax_variables.items()}
    if fault == "missing":
        del v["params"]["classifier"]["bias"]
        match = "classifier.bias"
    elif fault == "extra":
        v["params"]["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
        match = "params/extra_head/kernel"
    else:
        v["params"]["proj_in"]["kernel"] = np.zeros((8, 17), np.float32)
        match = "proj_in"
    with pytest.raises(ValueError, match=match):
        load_flax_variables(build_model(SMALL, device="cpu"), v)


def test_port_imports_no_jax():
    code = (
        "import sys, torch, pkgutil, importlib\n"
        "import outgridvit_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              'outgridvit_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'outgridvit_tpu_torch.training.steps' in mods, mods\n"
        "assert 'outgridvit_tpu_torch.ops.augment' in mods, mods\n"
        "for m in ('train', 'training.loop', 'training.checkpoints',\n"
        "          'data.pipeline', 'data.datasets', 'data.transforms',\n"
        "          'data.registry', 'data.data_utils', 'utils.config',\n"
        "          'utils.history', 'training.bench_eval',\n"
        "          'data.corruptions', 'benchmark_eval', 'eval_robustness',\n"
        "          'export_model', 'ops.library', 'ops.attention',\n"
        "          'models.rematerialize', 'experiments',\n"
        "          'experiments.capture', 'experiments.mad_entropy',\n"
        "          'experiments.heatmaps', 'run_attention_analysis',\n"
        "          'run_ablations', 'ops.dropout', 'models.baselines',\n"
        "          'train_cifar32_baselines'):\n"
        "    assert 'outgridvit_tpu_torch.' + m in mods, (m, mods)\n"
        "from outgridvit_tpu_torch.serving import build_predictor\n"
        f"cfg = {SMALL!r}\n"
        "p = build_predictor(cfg, batch_size=2, img_size=16, device='cpu')\n"
        "import numpy as np\n"
        "l, pr = p.predict(np.zeros((1, 16, 16, 3), np.uint8))\n"
        "assert l.shape == (1,) and pr.shape == (1, 10)\n"
        "from outgridvit_tpu_torch.models import build_model\n"
        "from outgridvit_tpu_torch.ops.augment import AugmentConfig\n"
        "from outgridvit_tpu_torch.training.optim import AdamW\n"
        "from outgridvit_tpu_torch.training.steps import (StepConfig,\n"
        "                                                 make_train_step)\n"
        "from outgridvit_tpu_torch.training.train_state import TrainState\n"
        "st = TrainState.create(build_model(cfg, device='cpu'), AdamW(1e-3))\n"
        "step = make_train_step(StepConfig(10, mixup_alpha=0.8, augment=\n"
        "    AugmentConfig((0.5,) * 3, (0.25,) * 3, 2)))\n"
        "st, m = step(st, (torch.zeros(2, 16, 16, 3, dtype=torch.uint8),\n"
        "                  torch.zeros(2, dtype=torch.long)),\n"
        "             generator=torch.Generator().manual_seed(0))\n"
        "assert st.step == 1 and bool(torch.isfinite(m['loss']))\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "assert chip_smoke.MODEL_B_O.model['use_pallas'] == 'fused_outlook'\n"
        "import tempfile\n"
        "from outgridvit_tpu_torch.train import main\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    assert main(['--config', 'configs/smoke_synthetic.yaml',\n"
        "                 '--output-dir', d]) == 0\n"
        "    from outgridvit_tpu_torch import run_attention_analysis as ra\n"
        "    assert ra.main(['--config', 'configs/smoke_synthetic.yaml',\n"
        "                    '--device', 'cpu', '--skip-plots',\n"
        "                    '--entropy', '--out-dir', d]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'yaml', 'outgridvit_tpu',\n"
        "              'PIL', 'datasets', 'matplotlib'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_stage_config_copy_matches_the_jax_schema():
    """The port keeps its own copy of ``outgridvit_tpu/stage_config.py``:
    the same dataclasses, field for field, with the same defaults, and the
    same helpers."""
    import dataclasses

    from outgridvit_tpu import stage_config as jsc
    from outgridvit_tpu_torch import stage_config as tsc

    def classes(mod):
        return {n: c for n, c in vars(mod).items()
                if dataclasses.is_dataclass(c)
                and c.__module__ == mod.__name__}

    want, got = classes(jsc), classes(tsc)
    assert set(got) == set(want) and "StageCfg" in got
    for name, cls in want.items():
        assert cls.__dataclass_params__.frozen == \
            got[name].__dataclass_params__.frozen, name
        assert [(f.name, str(f.type), f.default)
                for f in dataclasses.fields(cls)] == [
            (f.name, str(f.type), f.default)
            for f in dataclasses.fields(got[name])], name
    stages = [{"dim": 16, "depth": 2, "num_heads": 2, "grid_size": 4,
               "ignored": 1}]
    assert [dataclasses.asdict(s) for s in tsc.build_stages(stages)] == \
        [dataclasses.asdict(s) for s in jsc.build_stages(stages)]
    for n in (1, 2, 7):
        assert tsc.make_dpr(n, 0.1) == jsc.make_dpr(n, 0.1)
    assert tsc.DownsampleConfig.from_dict({"kind": "pool"}) == \
        tsc.DownsampleConfig(kind="pool")


def test_kernel_dispatch_rules(monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        build_model(SMALL, use_kernels=True, device="cpu")
    assert not build_model(SMALL, device="cpu").stages[0][0].mlp.use_kernels
    # per-block remat is ported: a policy builds, an unknown name raises
    assert build_model(dict(SMALL, remat="dots"), device="cpu").remat == \
        "dots"
    with pytest.raises(ValueError, match="remat policy"):
        build_model(dict(SMALL, remat="bogus"), device="cpu")
    assert type(build_model(dict(SMALL, type="model_b"), device="cpu")
                ).__name__ == "OutlookerFrontGridNet"
    with pytest.raises(ValueError, match="model.type"):
        build_model(dict(SMALL, type="vit"), device="cpu")
    # the train forward needs explicit drop-path masks (dpr_max defaults to
    # 0.1); dropout runs with its masks, and an active ffn_drop takes every
    # MLP off the fused branch onto the plain unfused path, as JAX does
    # (outgridvit_tpu/models/layers.py:260)
    model = build_model(SMALL, device="cpu").train()
    with pytest.raises(ValueError, match="drop-path masks"):
        model(torch.zeros(1, 16, 16, 3))
    from outgridvit_tpu_torch.models import layers
    from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
    from outgridvit_tpu_torch.ops.dropout import HashedDropout

    fused = []
    monkeypatch.setattr(layers, "mlp_branch_autograd",
                        lambda *a, f=layers.mlp_branch_autograd:
                        fused.append(1) or f(*a))
    stages = [dict(s, ffn_drop=0.1) for s in SMALL["stages"]]
    model = build_model(dict(SMALL, stages=stages, dpr_max=0.0),
                        device="cpu").train()
    with pytest.raises(ValueError, match="dropout"):
        model(torch.zeros(1, 16, 16, 3))
    out = model(torch.zeros(1, 16, 16, 3), DropPathMasks({}, dropout=(
        HashedDropout(0, torch.zeros((), dtype=torch.int32)))))
    assert bool(torch.isfinite(out).all()) and fused == []
    model.eval()(torch.zeros(1, 16, 16, 3))  # eval: the fused branch
    assert len(fused) == 6  # 3 blocks, an outlooker MLP and a block MLP


def test_kernel_library_name_follows_the_sources(tmp_path, monkeypatch):
    for p in kernel_build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    before = kernel_build.library_path()
    assert before == kernel_build.library_path()
    with open(tmp_path / "mlp_branch.cu", "a") as f:
        f.write("\n// edit\n")
    assert kernel_build.library_path() != before
    assert before.parent == kernel_build.BUILD_DIR


def test_flagship_model_cfg_matches_the_config_file():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = yaml.safe_load(
        (ROOT / "configs" / "cifar100_model_a_7m.yaml").read_text())
    assert chip_smoke.FLAGSHIP_MODEL_CFG == cfg["model"]
    model = build_model(chip_smoke.FLAGSHIP_MODEL_CFG, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        chip_smoke.FLAGSHIP_PARAMS
    shapes = chip_smoke.stage_shapes()
    # the kernel shapes the serving batch of 64 gives each stage
    assert [(s["G"], s["N"], s["heads"], s["M"]) for s in shapes] == [
        (4096, 16, 2, 65536), (4096, 4, 3, 16384), (1024, 4, 6, 4096),
        (256, 4, 8, 1024)]


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_jax_train_state_loads_and_the_next_step_matches():
    """A JAX TrainState after 2 steps (params, batch_stats, AdamW mu/nu and
    count, step) becomes the port's TrainState; the third step then matches
    the JAX step (fp32, CPU) to 1e-5."""
    from outgridvit_tpu.training.optim import make_optimizer
    from outgridvit_tpu.training.optim import warmup_cosine_lr as jax_lr
    from outgridvit_tpu.training.steps import StepConfig as JaxStepConfig
    from outgridvit_tpu.training.steps import make_train_step as jax_step
    from outgridvit_tpu.training.train_state import TrainState as JaxState
    from outgridvit_tpu_torch.training.optim import AdamW, warmup_cosine_lr
    from outgridvit_tpu_torch.training.steps import (
        StepConfig,
        StepDraws,
        make_train_step,
    )

    cfg = dict(SMALL, dpr_max=0.0)
    lr = dict(base_lr=1e-3, total_steps=10, warmup_steps=2, min_lr=1e-6)
    jmodel = jax_build_model(cfg, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                jnp.zeros((1, 16, 16, 3)))
    state = JaxState.create(apply_fn=jmodel.apply, params=init["params"],
                            batch_stats=init["batch_stats"],
                            tx=make_optimizer(jax_lr(**lr), 0.05, 1.0))
    step = jax_step(JaxStepConfig(num_classes=10), jax_lr(**lr))
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
                rng.integers(0, 10, 4)) for _ in range(3)]
    key = jax.random.PRNGKey(0)
    for x, y in batches[:2]:
        state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)), key)
    adam = state.opt_state[1][0]
    assert int(state.opt_state[1][2].count) == int(adam.count) == 2
    tx = AdamW(warmup_cosine_lr(**lr), 0.05, 1.0)
    port = load_jax_train_state(
        build_model(cfg, device="cpu"), tx,
        params=jax.tree_util.tree_map(np.asarray, state.params),
        batch_stats=jax.tree_util.tree_map(np.asarray, state.batch_stats),
        mu=jax.tree_util.tree_map(np.asarray, adam.mu),
        nu=jax.tree_util.tree_map(np.asarray, adam.nu),
        count=int(adam.count), step=int(state.step))
    assert port.step == 2 and int(port.opt_state.count) == 2

    x, y = batches[2]
    state, jm = step(state, (jnp.asarray(x), jnp.asarray(y)), key)
    port, tm = make_train_step(StepConfig(num_classes=10),
                               warmup_cosine_lr(**lr))(
        port, (torch.from_numpy(x), torch.from_numpy(y)), StepDraws())
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    want = jax_tree_to_port(jax.tree_util.tree_map(np.asarray, state.params))
    want.update(jax_tree_to_port(jax.tree_util.tree_map(
        np.asarray, state.batch_stats)))
    got = {k: t.numpy() for k, t in port.model.state_dict().items()}
    assert set(got) == set(want)
    # Leaves whose exact gradient is 0 get noise-level grads that Adam
    # scales up to lr-sized steps of either sign, in both frameworks: the
    # key third of each qkv bias (softmax ignores a constant added to every
    # key) and the last MLP's fc2 bias (a per-channel constant that the
    # train-mode head BN subtracts again). They are held to that bound.
    last_fc2 = [k for k in got if k.endswith("mlp.fc2.bias")][-1]
    for k, v in want.items():
        g = got[k]
        if k.endswith("qkv.bias"):
            C = v.shape[0] // 3
            np.testing.assert_array_less(np.abs(g[C:2 * C] - v[C:2 * C]),
                                         3 * lr["base_lr"], err_msg=k)
            g, v = np.delete(g, np.s_[C:2 * C]), np.delete(v, np.s_[C:2 * C])
        elif k == last_fc2:
            np.testing.assert_array_less(np.abs(g - v), 3 * lr["base_lr"],
                                         err_msg=k)
            continue
        np.testing.assert_allclose(g, v, atol=1e-5, rtol=1e-5, err_msg=k)
    mu = jax_tree_to_port(jax.tree_util.tree_map(
        np.asarray, state.opt_state[1][0].mu))
    for k, v in mu.items():
        np.testing.assert_allclose(port.opt_state.mu[k].numpy(), v,
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert port.step == int(state.step) == 3


def _c_entry_points():
    """name -> (return type, parameter types) of every ``extern "C"``
    function in the kernel sources and the layout sources."""
    out = {}
    for src in sorted([*kernel_build.CSRC_DIR.glob("*.cu"),
                       *kernel_build.CSRC_DIR.glob("*.cpp")]):
        text = src.read_text()
        for m in re.finditer(r'extern "C" ([\w ]+?\**)\s*(ogvt_\w+)\(([^)]*)\)',
                             text):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            out[m.group(2)] = (m.group(1).strip(), params)
    return out


_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float, "long long": ctypes.c_longlong,
          "char*": ctypes.c_char_p}


def _ctype(decl: str):
    """The ctypes type a C declaration ``const void* x`` / ``int B`` is
    passed or returned as."""
    decl = decl.replace("const ", "")
    if "*" in decl:
        return _CTYPE["char*" if decl.startswith("char") else "void*"]
    return _CTYPE[" ".join(decl.split()[:2]) if decl.startswith("long long")
                  else decl.split()[0]]


_ALL_SIGNATURES = {**kernel_build._SIGNATURES,
                   **kernel_build._HOST_SIGNATURES}


@pytest.mark.parametrize("name", sorted(_ALL_SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each entry point's ctypes argtypes and restype against its C
    declaration in csrc/ (a call with a parameter too few or too many
    would pass a pointer where an int is read, with no error)."""
    entries = _c_entry_points()
    assert name in entries, f"{name}: no extern \"C\" definition in csrc/"
    ret, params = entries[name]
    argtypes, restype = _ALL_SIGNATURES[name]
    assert [_ctype(p) for p in params] == list(argtypes), (name, params)
    assert _ctype(ret) == restype, (name, ret)
