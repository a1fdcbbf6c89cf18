"""Port parity, kernels #7 and #8: the fused outlook value path's plain
versions (``outgridvit_tpu_torch/ops/outlook_agg.py``) against
``outgridvit_tpu/ops/experimental/outlook_agg_pallas.py`` in interpret mode,
forward and every gradient, on the same numpy inputs (CPU); and the port's
``OutlookAttention2d`` in both fused modes against the JAX module.

Tolerances are the JAX kernel tests' (``tests/test_outlook_agg_pallas.py:
63-69, 240-246``): #7 out 2e-5, dv and da 3e-5, dWp and dbp 3e-4; #8 out
3e-5, dx and da 5e-5, weight grads 5e-4; the module 2e-5 forward and 3e-5
dx. In bf16 fewer than 1% of the outputs and of dv / dx may differ from the
JAX kernel, each by at most one bf16 rounding (an fp32 sum taken in another
order can round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models.blocks import OutlookAttention2d as JaxOutlook
from outgridvit_tpu.ops.experimental import outlook_agg_pallas as oap
from outgridvit_tpu_torch.models.blocks import OutlookAttention2d
from outgridvit_tpu_torch.ops import outlook_agg as oa

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
AGG_GRADS = ("dv", "da", "dwp", "dbp")
BRANCH_GRADS = ("dx", "da", "dwv", "dbv", "dwp", "dbp")
AGG_TOL = dict(out=2e-5, dv=3e-5, da=3e-5, dwp=3e-4, dbp=3e-4)
BRANCH_TOL = dict(out=3e-5, dx=5e-5, da=5e-5, dwv=5e-4, dbv=5e-4, dwp=5e-4,
                  dbp=5e-4)


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, B, H, W, Cin, C, heads, fold):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, H, W, heads, 9))
    a = np.exp(logits - logits.max(-1, keepdims=True))
    a = (a / a.sum(-1, keepdims=True)).reshape(B, H, W, heads * 9)
    args = [rng.normal(size=(B, H, W, Cin)), a]
    if fold:
        args += [0.3 * rng.normal(size=(Cin, C)), 0.1 * rng.normal(size=C)]
    args += [0.3 * rng.normal(size=(C, C)), 0.1 * rng.normal(size=C)]
    g = rng.normal(size=(B, H, W, C))
    return [x.astype(np.float32) for x in args], g.astype(np.float32)


def _run(fold, args, g, dtype):
    """(port out, port grads, JAX out, JAX grads) in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    targs = [torch.from_numpy(x).to(tdt) for x in args]
    jargs = [jnp.asarray(x, jdt) for x in args]
    if fold:
        got = oa.outlook_branch_reference(*targs)
        grads = oa.outlook_branch_backward_reference(
            *targs[:-1], torch.from_numpy(g).to(tdt))
        jfn = oap.outlook_branch_pallas
    else:
        got = oa.outlook_agg_proj_reference(*targs)
        grads = oa.outlook_agg_proj_backward_reference(
            *targs[:-1], torch.from_numpy(g).to(tdt))
        jfn = oap.outlook_attention_proj_pallas
    jg = jnp.asarray(g, jdt)

    def loss(*a):
        return jnp.sum((jfn(*a) * jg).astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = jfn(*jargs)
        want_grads = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    return got, grads, want, want_grads


def _assert_f32(names, tol, got, grads, want, want_grads):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol["out"],
                               rtol=tol["out"])
    for name, g, w in zip(names, grads, want_grads):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=tol[name],
                                   rtol=tol[name], err_msg=name)


@pytest.mark.parametrize("B,H,W,C,heads", [(2, 4, 8, 48, 2), (1, 8, 4, 64, 2)])
def test_outlook_agg_plain_matches_pallas(B, H, W, C, heads):
    args, g = _inputs(B + H + C, B, H, W, C, C, heads, fold=False)
    _assert_f32(AGG_GRADS, AGG_TOL, *_run(False, args, g, "f32"))


@pytest.mark.parametrize("B,H,W,Cin,C,heads,kib", [
    (2, 4, 8, 32, 48, 2, None),    # whole image, Cin != C
    (1, 16, 8, 48, 48, 2, "640"),  # the row-chunked Pallas kernels
])
def test_outlook_branch_plain_matches_pallas(B, H, W, Cin, C, heads, kib,
                                             monkeypatch):
    if kib is not None:
        monkeypatch.setenv("OUTGRIDVIT_OUTAGG_KIB", kib)
        assert oap._pick_bh_v(H, W, Cin, C, heads * 9, 4) > 0
    args, g = _inputs(H + Cin, B, H, W, Cin, C, heads, fold=True)
    _assert_f32(BRANCH_GRADS, BRANCH_TOL, *_run(True, args, g, "f32"))


def _assert_one_rounding(name, got, want):
    """Fewer than 1% of the values differ, each by at most one bf16
    rounding (2^-8 relative, the spacing of bf16 values being 2^-7 of
    their leading power of two)."""
    got, want = _np(got), np.asarray(want, np.float32)
    differ = got != want
    assert differ.mean() < 0.01, (name, differ.mean())
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want)[differ] <= bound[differ]).all(), name


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_plain_rounds_like_pallas(fold):
    B, H, W, C, heads = 2, 4, 8, 48, 2
    args, g = _inputs(11, B, H, W, C, C, heads, fold)
    got, grads, want, want_grads = _run(fold, args, g, "bf16")
    assert got.dtype == grads[0].dtype == torch.bfloat16
    _assert_one_rounding("out", got, want)
    _assert_one_rounding("dx" if fold else "dv", grads[0], want_grads[0])
    names = BRANCH_GRADS if fold else AGG_GRADS
    for name, gr, w in zip(names[1:], grads[1:], want_grads[1:]):
        # da and the weight grads: sums, within one bf16 rounding of their
        # largest element
        assert gr.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        assert np.abs(_np(gr) - w).max() <= 2.0 ** -7 * np.abs(w).max(), name


@pytest.mark.parametrize("mode", ["fused_agg", "fused_agg_v"])
def test_outlook_attention_fused_modes_match_jax(mode):
    B, H, W, C, heads = 2, 8, 8, 48, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jmod = JaxOutlook(dim=C, num_heads=heads, dtype=jnp.float32,
                      use_pallas=mode)
    # LeCun-normal kernels, as the module's init draws them
    params = {name: {"kernel": (C ** -0.5 * rng.normal(size=(C, n)))
                     .astype(np.float32),
                     "bias": (0.1 * rng.normal(size=n)).astype(np.float32)}
              for name, n in (("attn", heads * 9), ("v", C), ("proj", C))}

    def jloss(x):
        return jnp.sum(jmod.apply({"params": params}, x) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": params}, jnp.asarray(x))
        want_dx = jax.grad(jloss)(jnp.asarray(x))

    port = OutlookAttention2d(C, heads, 3, mode=mode)
    with torch.no_grad():
        for name, p in params.items():
            getattr(port, name).weight.copy_(torch.from_numpy(p["kernel"].T))
            getattr(port, name).bias.copy_(torch.from_numpy(p["bias"]))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = port(tx)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(want_dx), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("fold", [False, True])
def test_autograd_grads_equal_the_plain_backwards(fold):
    args, g = _inputs(5, 1, 4, 4, 16, 16, 2, fold)
    targs = [torch.from_numpy(x) for x in args]
    leaves = [t.clone().requires_grad_(True) for t in targs]
    fn = oa.outlook_branch_autograd if fold else oa.outlook_agg_proj_autograd
    ref = oa.outlook_branch_backward_reference if fold else \
        oa.outlook_agg_proj_backward_reference
    out = fn(*leaves, False)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = ref(*targs[:-1], torch.from_numpy(g))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_on_cpu_take_the_plain_version():
    args, g = _inputs(6, 1, 4, 8, 24, 24, 1, fold=True)
    t = [torch.from_numpy(x) for x in args]
    tg = torch.from_numpy(g)
    n = (oa.outlook_agg_proj.launches, oa.outlook_agg_proj_backward.launches,
         oa.outlook_branch.launches, oa.outlook_branch_backward.launches)
    v = t[0]
    pairs = [
        (oa.outlook_agg_proj(v, t[1], *t[4:]),
         oa.outlook_agg_proj_reference(v, t[1], *t[4:])),
        (oa.outlook_branch(*t), oa.outlook_branch_reference(*t)),
        *zip(oa.outlook_agg_proj_backward(v, t[1], t[4], tg),
             oa.outlook_agg_proj_backward_reference(v, t[1], t[4], tg)),
        *zip(oa.outlook_branch_backward(*t[:5], tg),
             oa.outlook_branch_backward_reference(*t[:5], tg))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (oa.outlook_agg_proj.launches,
            oa.outlook_agg_proj_backward.launches, oa.outlook_branch.launches,
            oa.outlook_branch_backward.launches) == n
    with pytest.raises(ValueError, match="heads"):
        oa.outlook_agg_proj(v, t[1][..., :8], *t[4:])


def test_bias_does_not_leak_at_the_image_border():
    # a zero input: v = bv everywhere inside the image, zero outside, so a
    # corner pixel aggregates bv over its 4 in-image taps only
    B, H, W, C, heads = 1, 3, 3, 4, 1
    x = torch.zeros(B, H, W, C)
    a = torch.full((B, H, W, 9), 1.0 / 9)
    bv = torch.arange(1.0, C + 1)
    out = oa.outlook_branch_reference(x, a, torch.zeros(C, C), bv,
                                      torch.eye(C), torch.zeros(C))
    torch.testing.assert_close(out[0, 0, 0], bv * 4 / 9)
    torch.testing.assert_close(out[0, 1, 1], bv)


def test_tile_plan_fits_every_shipped_outlooker_shape():
    # the outlooker shapes of Model B's front, Model A-7M and the
    # Tiny-ImageNet model, both ways
    for H, C, heads in ((32, 64, 2), (32, 48, 2), (16, 96, 3), (8, 192, 6),
                        (4, 256, 8), (64, 64, 2), (32, 128, 4), (16, 256, 8),
                        (8, 384, 6)):
        for fold in (False, True):
            rows = oa.tile_rows(H, H, C, C, heads, fold)
            assert 1 <= rows <= H and rows * H <= 128, (H, C, fold)
            assert oa.smem_bytes(rows, H, C, C, heads, fold) <= 227 * 1024
    assert oa.tile_rows(64, 64, 64, 64, 2, True) == 2
    assert oa.tile_rows(4, 4, 256, 256, 8, True) == 4
    assert oa.tile_rows(2, 4096, 64, 64, 2, True) == 0
