"""Port parity, kernel #9: the fused outlook softmax + aggregate
(``outgridvit_tpu_torch/ops/outlook_softmax.py``) against
``outgridvit_tpu/ops/experimental/outlook_pallas.py:outlook_attention_pallas``
in interpret mode on the same numpy inputs (CPU), its autograd backward
against ``jax.vjp`` of ``_xla_forward``, and the port's
``OutlookAttention2d("fused_outlook")`` against the JAX module with
``use_pallas="fused_outlook"``.

Tolerances: the forward 2e-5 in fp32 (``tests/test_outlook_pallas.py:31``);
in bf16 fewer than 1% of the outputs may differ from the JAX kernel, each by
at most one bf16 rounding (an fp32 sum or exp taken in another order or
library can round the other way). dv and dlogits 1e-5 in fp32 (the same
XLA-equivalent forward differentiated by both frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models.blocks import OutlookAttention2d as JaxOutlook
from outgridvit_tpu.ops.experimental import outlook_pallas as op
from outgridvit_tpu_torch.models.blocks import OutlookAttention2d
from outgridvit_tpu_torch.ops import outlook_softmax as osm

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [  # B, H, W, C, heads, K
    (2, 8, 8, 8, 2, 3),     # the JAX test's shape
    (2, 6, 10, 48, 2, 3),   # H != W, hd = 24
    (1, 8, 8, 64, 2, 3),    # Model B's front widths (hd = 32)
    (2, 7, 9, 16, 2, 5),    # K = 5, H != W
]


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, B, H, W, C, heads, k):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, H, W, C)).astype(np.float32)
    logits = (2.0 * rng.normal(size=(B, H, W, heads * k * k))).astype(
        np.float32)
    return v, logits


def _assert_one_rounding(name, got, want):
    """Fewer than 1% of the values differ, each by at most one bf16
    rounding (2^-8 relative, the spacing of bf16 values being 2^-7 of
    their leading power of two)."""
    got, want = _np(got), np.asarray(want, np.float32)
    differ = got != want
    assert differ.mean() < 0.01, (name, differ.mean())
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want)[differ] <= bound[differ]).all(), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,heads,k", SHAPES)
def test_plain_matches_pallas(dtype, B, H, W, C, heads, k):
    tdt, jdt = DTYPES[dtype]
    v, logits = _inputs(B + H + W + C + k, B, H, W, C, heads, k)
    got = osm.outlook_softmax_agg_reference(
        torch.from_numpy(v).to(tdt), torch.from_numpy(logits).to(tdt),
        heads, k)
    with pltpu.force_tpu_interpret_mode():
        want = op.outlook_attention_pallas(jnp.asarray(v, jdt),
                                           jnp.asarray(logits, jdt), heads, k)
    assert got.dtype == tdt and got.shape == (B, H, W, C)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
    else:
        _assert_one_rounding("out", got, want)


@pytest.mark.parametrize("B,H,W,C,heads,k", [SHAPES[1], SHAPES[3]])
def test_autograd_backward_matches_jax_vjp(B, H, W, C, heads, k):
    v, logits = _inputs(7 + k, B, H, W, C, heads, k)
    g = np.random.default_rng(8).normal(size=(B, H, W, C)).astype(np.float32)
    tv, tl = (torch.from_numpy(a).requires_grad_(True) for a in (v, logits))
    out = osm.outlook_softmax_autograd(tv, tl, heads, k, False)
    dv, dl = torch.autograd.grad(out, (tv, tl), torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b: op._xla_forward(a, b, heads, k),
                     jnp.asarray(v), jnp.asarray(logits))
    want_dv, want_dl = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(dv), np.asarray(want_dv), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(dl), np.asarray(want_dl), atol=1e-5,
                               rtol=1e-5)


def test_backward_differentiates_the_xla_forward_in_bf16():
    # bf16: the forward keeps fp32 probabilities, the backward rounds them
    # to bf16 first (_xla_forward), as the JAX package does
    B, H, W, C, heads, k = 2, 6, 10, 48, 2, 3
    v, logits = _inputs(3, B, H, W, C, heads, k)
    g = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(0))
    tv, tl = (torch.from_numpy(a).bfloat16().requires_grad_(True)
              for a in (v, logits))
    got = torch.autograd.grad(
        osm.outlook_softmax_autograd(tv, tl, heads, k), (tv, tl),
        g.bfloat16())
    want = torch.autograd.grad(osm.outlook_softmax_xla(tv, tl, heads, k),
                               (tv, tl), g.bfloat16())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _module_params(rng, C, heads, k):
    """LeCun-normal kernels, as the module's init draws them."""
    return {name: {"kernel": (C ** -0.5 * rng.normal(size=(C, n)))
                   .astype(np.float32),
                   "bias": (0.1 * rng.normal(size=n)).astype(np.float32)}
            for name, n in (("attn", heads * k * k), ("v", C), ("proj", C))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_outlook_attention_fused_outlook_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    B, H, W, C, heads, k = 2, 8, 8, 48, 2, 3
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    params = _module_params(rng, C, heads, k)
    jmod = JaxOutlook(dim=C, num_heads=heads, dtype=jdt,
                      use_pallas="fused_outlook")

    def jloss(x):
        out = jmod.apply({"params": params}, x).astype(jnp.float32)
        return jnp.sum(out ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": params}, jnp.asarray(x, jdt))
        want_dx = jax.grad(jloss)(jnp.asarray(x, jdt))

    port = OutlookAttention2d(C, heads, k, dtype=tdt, mode="fused_outlook")
    with torch.no_grad():
        for name, p in params.items():
            getattr(port, name).weight.copy_(torch.from_numpy(p["kernel"].T))
            getattr(port, name).bias.copy_(torch.from_numpy(p["bias"]))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = port(tx)
    (got.float() ** 2).sum().backward()
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(_np(tx.grad), np.asarray(want_dx),
                                   atol=3e-5, rtol=3e-5)
    else:
        # three bf16 products (logits, v, proj) around the kernel: within
        # a few bf16 roundings of the largest output
        for name, a, b in (("out", got, want), ("dx", tx.grad, want_dx)):
            b = np.asarray(b, np.float32)
            err = np.abs(_np(a) - b).max()
            assert err <= 2.0 ** -6 * np.abs(b).max(), (name, err)


def test_wrapper_on_cpu_takes_the_plain_version_and_checks_shapes():
    v, logits = _inputs(5, 1, 4, 6, 8, 2, 3)
    tv, tl = torch.from_numpy(v), torch.from_numpy(logits)
    n = osm.outlook_softmax_agg.launches
    torch.testing.assert_close(osm.outlook_softmax_agg(tv, tl, 2),
                               osm.outlook_softmax_agg_reference(tv, tl, 2),
                               rtol=0, atol=0)
    assert osm.outlook_softmax_agg.launches == n
    with pytest.raises(ValueError, match="odd"):
        osm.outlook_softmax_agg(tv, tl, 2, 2)
    with pytest.raises(ValueError, match="logits"):
        osm.outlook_softmax_agg(tv, tl[..., :9], 2)
    with pytest.raises(ValueError, match="divisible"):
        osm.outlook_softmax_agg(tv[..., :7], tl, 2)


def test_padding_is_zero_v_and_not_renormalised():
    # equal logits: every tap weighs 1/9, also the taps outside the image,
    # so a corner pixel of a constant map aggregates 4/9 of it
    v = torch.ones(1, 3, 3, 2)
    out = osm.outlook_softmax_agg_reference(v, torch.zeros(1, 3, 3, 9), 1)
    torch.testing.assert_close(out[0, 0, 0], torch.full((2,), 4 / 9))
    torch.testing.assert_close(out[0, 1, 1], torch.ones(2))
