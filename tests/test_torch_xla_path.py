"""Port parity, ``model.use_pallas: false``: the JAX package's XLA-only path
(``outgridvit_tpu/models/build.py:28-32``) against the port's, on the same
numpy inputs (CPU).

On that path JAX runs no Pallas kernel: grid MHSA at every N with the
probabilities cast before P.V (``models/blocks.py:375-398``), the MLP
unfused (``models/layers.py:297-305``), and every dense layer and
activation as XLA ops, each op rounded to the compute dtype when JAX runs
them one by one. The port's ``xla`` switch (set by ``build_model``) takes
the same rounding points.

- The tiny Model A of ``tests/test_torch_model.py`` at batch 64: bf16 logits
  within 2.4e-3 of the largest fp32 logit of JAX's (the port's plain kernel
  path, which keeps the kernels' rounding points, is 4.9e-3 off), fp32
  logits and train-mode gradients at 1e-4.
- No kernel runs on that path, whatever ``use_kernels`` says.
- The op-by-op activations and the dense layer, bit for bit in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.models.layers import ChannelMLP, Dense
from outgridvit_tpu_torch.ops.activations import make_activation
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

from tests.test_torch_model import IMG, TINY, randomize

XLA = dict(TINY, use_pallas=False)
# bf16 logits, as a fraction of the largest fp32 logit: half the 4.9e-3 gap
# of the kernels' rounding points
BF16_BAR = 2.4e-3


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, dict(init)))
    x = np.random.default_rng(1).normal(size=(64, IMG, IMG, 3)).astype(
        np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    return variables, x, ref


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_use_pallas_false_logits_match_the_jax_xla_path(tiny, dtype):
    variables, x, ref = tiny
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    want = np.asarray(jax_build_model(TINY, dtype=jdt, use_pallas=False)
                      .apply(variables, jnp.asarray(x), train=False),
                      np.float32)
    port = load_flax_variables(build_model(XLA, dtype=tdt, device="cpu"),
                               variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = float(np.abs(got - want).max()) / float(np.abs(ref).max())
        assert err <= BF16_BAR, err


def test_use_pallas_false_gradients_match_jax_in_fp32(tiny):
    variables, x, _ = tiny
    x = x[:4]
    w = np.random.default_rng(2).normal(size=(4, 10)).astype(np.float32)
    jmodel = jax_build_model(TINY, use_pallas=False)

    def loss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=False, mutable=["batch_stats"])
        return jnp.sum(logits * w)

    grads = jax_tree_to_port(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(variables["params"])))
    port = load_flax_variables(build_model(XLA, device="cpu"), variables)
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(grads)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=k)


def test_use_pallas_false_runs_no_kernel(monkeypatch):
    calls = []
    for mod, name in ((tblocks, "grid_mhsa_autograd"),
                      (tblocks, "grid_mhsa_packed_autograd"),
                      (tblocks, "attn_branch_autograd"),
                      (tblocks, "attn_branch_nhwc_autograd"),
                      (tlayers, "mlp_branch_autograd")):
        monkeypatch.setattr(mod, name,
                            lambda *a, name=name: calls.append(name))
    # use_kernels=True is overridden (and needs no card), as JAX's YAML
    # value overrides its argument
    model = build_model(dict(TINY, use_pallas=False, stages=[
        dict(s, grid_size=2) for s in TINY["stages"]]), use_kernels=True,
        device="cpu", attn_nhwc=True)
    mods = [m for m in model.modules()
            if isinstance(m, (tblocks.MultiHeadSelfAttention, ChannelMLP))]
    assert mods and all(m.xla and not m.use_kernels for m in mods)
    assert all(m.xla for m in model.modules() if isinstance(m, Dense)
               and m is not model.classifier)
    with torch.no_grad():
        for img in (8, 12, 16):  # stage 0 grids of N = 16, 36, 64
            assert torch.isfinite(model(torch.randn(2, img, img, 3))).all()
    assert calls == []
    for use_pallas in (None, True, "fused_agg"):
        m = build_model(dict(TINY, use_pallas=use_pallas), device="cpu")
        assert not any(getattr(x, "xla", False) for x in m.modules())


@pytest.mark.parametrize("act,jax_act", [
    ("silu", nn.silu), ("gelu", lambda v: nn.gelu(v, approximate=False))])
def test_xla_activations_round_op_by_op_like_jax(act, jax_act):
    x = (np.random.default_rng(0).normal(size=(256, 64)) * 3).astype(
        np.float32)
    got = make_activation(act, xla=True)(torch.from_numpy(x).bfloat16())
    want = np.asarray(jax_act(jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the fused form differs on a share of the values; fp32 agrees to ~1e-6
    assert (make_activation(act)(torch.from_numpy(x).bfloat16()).float()
            .numpy() != want).mean() > 0.05
    np.testing.assert_allclose(
        make_activation(act, xla=True)(torch.from_numpy(x)).numpy(),
        make_activation(act)(torch.from_numpy(x)).numpy(), atol=1e-5,
        rtol=1e-5)


def test_xla_dense_rounds_the_product_and_the_bias_apart():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 96)) * 48 ** -0.5).astype(np.float32)
    b = rng.normal(size=96).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(jnp.asarray(x, bf) @ jnp.asarray(w, bf)
                      + jnp.asarray(b, bf), np.float32)
    dense = Dense(48, 96, dtype=torch.bfloat16, xla=True)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T))
        dense.bias.copy_(torch.from_numpy(b))
        got = dense(torch.from_numpy(x)).float().numpy()
        dense.xla = False
        fused = dense(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert (fused != want).mean() > 0.05  # F.linear rounds once
