"""Port parity, model: the port's layers, blocks, Model A and predictor
against ``outgridvit_tpu`` (``use_pallas=False``) with the same weights
(JAX variables -> ``load_flax_variables``) and the same numpy inputs, CPU.

The tiny Model A takes 16px input with stages {dim 16, grid 4} and
{dim 32, grid 4}, so both an N=16 grid (stage 0) and N=4 grids (stage 1)
occur. Tolerances: 1e-5 per fp32 layer, 1e-4 on logits.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.models import blocks as jblocks
from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.serving import build_predictor as jax_build_predictor
from outgridvit_tpu.stage_config import MBConvConfig, StageCfg
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.serving import build_predictor
from outgridvit_tpu_torch.utils.port_jax import load_flax_variables

ROOT = Path(__file__).resolve().parents[1]

TINY = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 4},
    ],
}
IMG = 16


def randomize(variables, seed=0):
    """Init variables with every leaf perturbed from numpy, so scales, biases
    and BN statistics are all exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        def walk(t, col=col):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            a = np.asarray(t, np.float32)
            noise = rng.normal(size=a.shape).astype(np.float32)
            if col == "batch_stats" and a.mean() == 1.0:  # running var
                return (1.0 + 0.5 * rng.random(a.shape)).astype(np.float32)
            return a + 0.1 * noise
        out[col] = walk(dict(tree))
    return out


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, dict(init)))
    port = load_flax_variables(
        build_model(TINY, use_kernels=False, device="cpu"), variables)
    return jmodel, variables, port


def _sub(variables, *path):
    out = {}
    for col, tree in variables.items():
        for p in path:
            tree = tree.get(p) if isinstance(tree, dict) else None
        if tree:
            out[col] = tree
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_tiny_model_logits_match_jax(tiny):
    jmodel, variables, port = tiny
    x = _x((3, IMG, IMG, 3))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    _close(got, want, 1e-4)


# (name, flax module, variables path, port submodule getter, input shape,
#  apply kwargs)
S0 = StageCfg(dim=16, depth=1, num_heads=2, grid_size=4, outlook_heads=2)
LAYERS = {
    "stem": (lambda: jlayers.ConvStem(8), ("stem",),
             lambda m: m.stem, (2, IMG, IMG, 3), {"train": False}),
    "outlook_attention": (
        lambda: jblocks.OutlookAttention2d(dim=16, num_heads=2,
                                           use_pallas=False),
        ("stages_0_0", "outlook", "attn"),
        lambda m: m.stages[0][0].outlook.attn, (2, IMG, IMG, 16), {}),
    "outlooker_block": (
        lambda: jblocks.OutlookerBlock2d(dim=16, num_heads=2,
                                         use_pallas=False),
        ("stages_0_0", "outlook"),
        lambda m: m.stages[0][0].outlook, (2, IMG, IMG, 16), {}),
    "mbconv": (
        lambda: jlayers.MBConv(16, 16, cfg=MBConvConfig()),
        ("stages_0_0", "mbconv"),
        lambda m: m.stages[0][0].mbconv, (2, IMG, IMG, 16), {"train": False}),
    "squeeze_excite": (
        lambda: jlayers.SqueezeExcite(64), ("stages_0_0", "mbconv", "se"),
        lambda m: m.stages[0][0].mbconv.se, (2, IMG, IMG, 64), {}),
    "outgrid_block_n16": (
        lambda: jblocks.OutGridBlock(cfg=S0, use_pallas=False),
        ("stages_0_0",), lambda m: m.stages[0][0], (2, IMG, IMG, 16),
        {"train": False}),
    "outgrid_block_n4": (
        lambda: jblocks.OutGridBlock(cfg=S0.replace(dim=32, outlook_heads=4),
                                     use_pallas=False),
        ("stages_1_0",), lambda m: m.stages[1][0], (2, 8, 8, 32),
        {"train": False}),
    "downsample": (
        lambda: jlayers.Downsample(16, 32), ("downs_0",),
        lambda m: m.downs[0], (2, IMG, IMG, 16), {"train": False}),
    "head_norm": (
        lambda: jlayers.BatchNorm(use_running_average=True), ("head_norm",),
        lambda m: m.head_norm, (2, 8, 8, 32), {}),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(tiny, name):
    _, variables, port = tiny
    make, path, get, shape, kw = LAYERS[name]
    x = _x(shape, seed=list(LAYERS).index(name))
    want = make().apply(_sub(variables, *path), jnp.asarray(x), **kw)
    with torch.no_grad():
        got = get(port)(torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_grid_attention_and_mlp_match_jax(tiny):
    # the grid attention and MLP branches own no LN params in the port
    # (the block's norm2 / norm3 are passed in), so drive them directly
    _, variables, port = tiny
    blk, v = port.stages[0][0], _sub(variables, "stages_0_0")
    x = _x((2, IMG, IMG, 16), seed=5)
    n2, n3 = v["params"]["norm2"]["ln"], v["params"]["norm3"]["ln"]
    ln2 = (jnp.asarray(n2["scale"]), jnp.asarray(n2["bias"]), 1e-5)
    ln3 = (jnp.asarray(n3["scale"]), jnp.asarray(n3["bias"]), 1e-5)
    want_attn = jblocks.GridAttention2D(dim=16, num_heads=2, grid_size=4,
                                        use_pallas=False).apply(
        {"params": v["params"]["grid_attn"]}, jnp.asarray(x), ln=ln2)
    want_mlp = jlayers.ChannelMLP(dim=16, use_pallas=False).apply(
        {"params": v["params"]["mlp"]}, jnp.asarray(x), ln=ln3)
    with torch.no_grad():
        got_attn = blk.grid_attn(torch.from_numpy(x), blk.norm2)
        got_mlp = blk.mlp(torch.from_numpy(x), blk.norm3)
    _close(got_attn, want_attn, 1e-5)
    _close(got_mlp, want_mlp, 1e-5)


def test_predictor_matches_jax(tiny):
    _, variables, _ = tiny
    kw = dict(batch_size=4, img_size=IMG, mean=(0.5, 0.4, 0.3),
              std=(0.2, 0.25, 0.3))
    jpred = jax_build_predictor(TINY, variables=variables,
                                dtype=jnp.float32, use_pallas=False, **kw)
    pred = build_predictor(TINY, variables=variables, dtype=torch.float32,
                           device="cpu", **kw)
    x = np.random.default_rng(2).integers(0, 256, (7, IMG, IMG, 3), np.uint8)
    for req in (x[:3], x[0], x):  # ragged, single image, more than a batch
        want_l, want_p = jpred.predict_many(req)
        got_l, got_p = pred.predict_many(req)
        assert got_l.dtype == np.int32 and got_p.dtype == np.float32
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="uint8"):
        pred.predict(x[:2].astype(np.float32))
    with pytest.raises(ValueError, match="compiled batch size"):
        pred.predict(x[:5])


MODEL_A_CONFIGS = sorted(
    p for p in (ROOT / "configs").glob("*.yaml")
    if yaml.safe_load(p.read_text())["model"].get("type") == "model_a")


@pytest.mark.parametrize("cfg_path", MODEL_A_CONFIGS, ids=lambda p: p.stem)
def test_param_count_matches_jax(cfg_path):
    model_cfg = yaml.safe_load(cfg_path.read_text())["model"]
    shapes = jax.eval_shape(jax_build_model(model_cfg, use_pallas=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    port = build_model(model_cfg, device="meta")
    got = sum(p.numel() for p in port.parameters())
    assert got == want
    if cfg_path.name == "cifar100_model_a_7m.yaml":
        assert got == 7_518_102
