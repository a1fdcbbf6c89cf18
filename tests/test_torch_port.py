"""Port plumbing: weights across both ways, strictness, independence from
JAX, kernel dispatch rules, the kernel build's cache key, and chip_smoke.py's
flagship config and its refusal to run without a card."""

import os
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
from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

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
        "import sys, torch\n"
        "from outgridvit_tpu_torch.serving import build_predictor\n"
        f"cfg = {SMALL!r}\n"
        "p = build_predictor(cfg, batch_size=2, img_size=16, device='cpu')\n"
        "import numpy as np\n"
        "l, pr = p.predict(np.zeros((1, 16, 16, 3), np.uint8))\n"
        "assert l.shape == (1,) and pr.shape == (1, 10)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_kernel_dispatch_rules():
    with pytest.raises(ValueError, match="CUDA device"):
        build_model(SMALL, use_kernels=True, device="cpu")
    assert not build_model(SMALL, device="cpu").stages[0][0].mlp.use_kernels
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dict(SMALL, type="model_b"), device="cpu")
    with pytest.raises(ValueError, match="model.type"):
        build_model(dict(SMALL, type="vit"), device="cpu")
    model = build_model(SMALL, device="cpu").train()
    with pytest.raises(RuntimeError, match="eval"):
        model(torch.zeros(1, 16, 16, 3))


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
