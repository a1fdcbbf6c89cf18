"""Port parity, kernel #12 (``outgridvit_tpu/ops/experimental/
attn_branch_nhwc_pallas.py:attn_branch_nhwc_pallas``, the fused grid
attention branch on the NHWC map) and the default Model A path that runs it
(``configs/cifar100_model_a.yaml`` with ``attn_nhwc=True``), against
``outgridvit_tpu`` on the same numpy inputs (CPU).

- The plain forward and backward (partition -> #5's plain versions ->
  unpartition) against ``attn_branch_nhwc_pallas`` in interpret mode, at
  the Tiny-ImageNet stage-0 width (C=64), the default Model A's (C=80) and a
  rectangular map, fp32 and bf16.
- A tiny Model A whose stage 0 has grids of N=64 (16 px, grid 2) built with
  ``attn_nhwc=True``, against JAX with ``OUTGRIDVIT_FUSED_ATTN_NHWC=1`` (and
  ``OUTGRIDVIT_ATTN_T=0``, so stage 1's N=16 grids run #6 rather than the
  slow interpret unroll of #1): eval logits and train-mode gradients.
- The full-width default Model A (``chip_smoke.py``'s ``a_base``): its
  configuration against the yaml, the parameter count against the JAX
  build, the kernels each stage dispatches to and their launch tags.

Tolerances: the bars of ``tests/test_attn_branch_nhwc.py``: 3e-5 forward,
2e-3 gradients in fp32, 5e-2 in bf16 (parameter gradients as a fraction of
their largest element); 1e-4 on logits and gradients (``docs/PARITY.md``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.ops.experimental.attn_branch_nhwc_pallas import (
    attn_branch_nhwc_pallas,
)
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.ops import attn_branch as ab
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

ROOT = Path(__file__).resolve().parents[1]
A_YAML = ROOT / "configs" / "cifar100_model_a.yaml"
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
GRADS = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj", "dbproj")
TINY64 = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.0,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG = 16


def _np(t):
    return t.detach().float().numpy()


def _args(rng, B, H, W, C):
    return [rng.normal(size=(B, H, W, C)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=C)).astype(np.float32),
            (0.1 * rng.normal(size=C)).astype(np.float32),
            (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32),
            (0.02 * rng.normal(size=3 * C)).astype(np.float32),
            (rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32),
            (0.02 * rng.normal(size=C)).astype(np.float32)]


# ---- the branch against attn_branch_nhwc_pallas ----------------------------

@pytest.mark.parametrize("B,H,W,C,heads,g,dtype", [
    (2, 16, 16, 64, 2, 2, "f32"),   # the Tiny-ImageNet stage-0 width
    (2, 16, 16, 80, 2, 2, "f32"),   # the default Model A's stage-0 width
    (2, 8, 16, 48, 2, 4, "f32"),    # rectangular
    (2, 16, 16, 80, 2, 2, "bf16"),
    (2, 8, 16, 48, 2, 4, "bf16"),
])
def test_plain_branch_matches_attn_branch_nhwc_pallas(B, H, W, C, heads, g,
                                                      dtype):
    rng = np.random.default_rng(C + W)
    args = _args(rng, B, H, W, C)
    dy = rng.normal(size=(B, H, W, C)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    targs = [torch.from_numpy(a).to(torch.float32 if i in (1, 2) else tdt)
             for i, a in enumerate(args)]
    jargs = [jnp.asarray(a, jnp.float32 if i in (1, 2) else jdt)
             for i, a in enumerate(args)]
    # CPU tensors: the wrappers take the plain versions
    got = ab.attn_branch_nhwc(*targs, heads, g)
    grads = ab.attn_branch_nhwc_backward(*targs, torch.from_numpy(dy).to(tdt),
                                         heads, g)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda *a: attn_branch_nhwc_pallas(*a, heads, g, 1e-5, True),
            *jargs)
        want_grads = vjp(jnp.asarray(dy, jdt))
    ftol, gtol = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}[dtype]
    assert got.dtype == tdt and got.shape == (B, H, W, C)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ftol, rtol=ftol)
    for name, a, w in zip(GRADS, grads, want_grads):
        w = np.asarray(w, np.float32)
        if dtype == "bf16" and name != "dx":
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(_np(a) - w).max()) <= gtol * scale, name
        else:
            np.testing.assert_allclose(_np(a), w, atol=gtol, rtol=gtol,
                                       err_msg=name)


def test_nhwc_branch_is_the_token_branch_on_the_partition():
    """The plain versions: #12 = unpartition(#5(partition(x))), its
    parameter gradients #5's on the partitioned tokens, and the autograd
    Function runs them both ways on the CPU."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in _args(rng, 2, 8, 12, 24)]
    dy = torch.from_numpy(rng.normal(size=(2, 8, 12, 24)).astype(np.float32))
    tokens, meta = ab._tokens(args[0], 2)
    want = ab._untokens(ab.attn_branch_reference(tokens, *args[1:], 4), meta)
    assert torch.equal(ab.attn_branch_nhwc_reference(*args, 4, 2), want)
    tgrads = ab.attn_branch_backward_reference(tokens, *args[1:],
                                               ab._tokens(dy, 2)[0], 4)
    grads = ab.attn_branch_nhwc_backward_reference(*args, dy, 4, 2)
    assert torch.equal(grads[0], ab._untokens(tgrads[0], meta))
    for a, b in zip(grads[1:], tgrads[1:]):
        assert torch.equal(a, b)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = ab.attn_branch_nhwc_autograd(*leaves, 4, 2, use_kernels=True)
    assert torch.equal(out.detach(), want)
    out.backward(dy)
    for leaf, g in zip(leaves, grads):
        assert torch.equal(leaf.grad, g)
    with pytest.raises(ValueError, match="divisible by grid_size"):
        ab.attn_branch_nhwc_reference(*args, 4, 5)


# ---- the tiny N=64 model against JAX's NHWC path ---------------------------

def test_tiny_64_token_model_with_attn_nhwc_matches_jax(monkeypatch):
    monkeypatch.setenv("OUTGRIDVIT_FUSED_ATTN_NHWC", "1")
    monkeypatch.setenv("OUTGRIDVIT_ATTN_T", "0")
    jmodel = jax_build_model(TINY64, use_pallas=True)
    init = jax.jit(jax_build_model(TINY64, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(4)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), dict(init))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    port = load_flax_variables(build_model(TINY64, device="cpu",
                                           attn_nhwc=True), variables)
    seen = []
    nhwc = tblocks.attn_branch_nhwc_autograd
    monkeypatch.setattr(tblocks, "attn_branch_nhwc_autograd",
                        lambda x, *a: seen.append(x.shape) or nhwc(x, *a))
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    w = rng.normal(size=(2, 10)).astype(np.float32)

    def loss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(logits * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, jnp.asarray(x))
        grads = jax.jit(jax.grad(loss))(variables["params"])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert seen == [(2, IMG, IMG, 16)]  # stage 0 took #12, on the NHWC map
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    port.train()
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    want_g = jax_tree_to_port(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=k)


# ---- the full-width default Model A -----------------------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_default_model_a_config_param_count_and_dispatch(monkeypatch):
    """``configs/cifar100_model_a.yaml`` (the model ``configs/train.yaml``
    and ``scripts/train.py`` use) at one 32 px image with ``attn_nhwc``:
    stage 0 (N=64, C=80) runs #12, stages 1-3 (N=16, C=160/320/448, 5/10/8
    heads) the #1 core tagged "th" (#3), every MLP #2's "t"."""
    chip_smoke = _chip_smoke()
    cfg = yaml.safe_load(A_YAML.read_text())["model"]
    case = chip_smoke.A_BASE
    assert case.model == chip_smoke.A_BASE_MODEL_CFG == cfg
    assert case.attn_nhwc and (case.img, case.crop_pad) == (32, 4)
    shapes = jax.eval_shape(jax_build_model(cfg, use_pallas=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in build_model(cfg, device="meta")
               .parameters()) == want == case.params == 32_974_583
    calls = []

    def spy(kind, fn, shape_of, variant_of):
        def wrapped(*a):
            calls.append((kind, shape_of(a), variant_of(a)))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tblocks, "attn_branch_nhwc_autograd", spy(
        "nhwc", tblocks.attn_branch_nhwc_autograd,
        lambda a: (tuple(a[0].shape), a[8]), lambda a: None))
    monkeypatch.setattr(tblocks, "attn_branch_autograd", spy(
        "branch", tblocks.attn_branch_autograd, lambda a: None,
        lambda a: None))
    monkeypatch.setattr(tblocks, "grid_mhsa_autograd", spy(
        "grid", tblocks.grid_mhsa_autograd, lambda a: tuple(a[0].shape),
        lambda a: (a[1], a[3])))
    monkeypatch.setattr(tlayers, "mlp_branch_autograd", spy(
        "mlp", tlayers.mlp_branch_autograd, lambda a: None,
        lambda a: a[11]))
    model = build_model(cfg, device="cpu", attn_nhwc=True)
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    attn = [c for c in calls if c[0] != "mlp"]
    assert attn == ([("nhwc", ((1, 32, 32, 80), 4), None)] * 2
                    + [("grid", (16, 16, 480), (5, "th"))] * 3
                    + [("grid", (4, 16, 960), (10, "th"))] * 4
                    + [("grid", (1, 16, 1344), (8, "th"))] * 2)
    assert {c[2] for c in calls if c[0] == "mlp"} == {"t"}
    got = [(s["attn"], s["G"], s["N"], s["C"], s["heads"], s["grid_variant"])
           for s in chip_smoke.stage_shapes(case)]
    assert got == [("nhwc", 1024, 64, 80, 2, "t"),
                   ("grid", 1024, 16, 160, 5, "th"),
                   ("grid", 256, 16, 320, 10, "th"),
                   ("grid", 64, 16, 448, 8, "th")]
