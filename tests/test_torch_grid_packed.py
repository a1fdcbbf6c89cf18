"""Port parity, kernel #6 (``outgridvit_tpu/ops/grid_attention_pallas.py:
grid_mhsa_pallas``, the block-packed grid MHSA core for grids of
16 < N < 64 tokens) and the 48 px Model A-7M path that runs it, against
``outgridvit_tpu`` on the same numpy inputs (CPU).

- The plain forward and backward (``grid_mhsa_reference(...,
  round_probs=True)``, :func:`grid_mhsa_packed_backward_reference`) against
  ``grid_mhsa_pallas`` in interpret mode: N = 25, 36, 49 in fp32 and bf16,
  and N = 4, 9, where JAX packs ``32 // N`` grids under its mask.
- A tiny Model A whose stage 0 has grids of N=36 (12 px, grid 2): fp32
  logits and the train-mode gradients against JAX ``use_pallas=True`` in
  interpret mode with ``OUTGRIDVIT_ATTN_T=0``, so that every JAX stage runs
  #6 (stage 1, N=9, packed 3 grids to a block).
- The full-width 48 px Model A-7M (``chip_smoke.py``'s ``a7m_48``): the
  kernels each stage dispatches to, and the parameter count.

Tolerances: 3e-5 forward and 2e-3 gradients in fp32 (``tests/
test_grid_attention_pallas_t.py``), bf16 against JAX in bf16 within 5e-2
(one bf16 rounding of an O(1) value); 1e-4 on logits and gradients
(``docs/PARITY.md``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.ops.grid_attention_pallas import grid_mhsa_pallas
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models import layers as tlayers
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}
TINY36 = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.0,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG = 12


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


# ---- the core against grid_mhsa_pallas -------------------------------------

@pytest.mark.parametrize("G,N,C,heads,dtype", [
    (4, 25, 48, 2, "f32"), (4, 36, 48, 2, "f32"), (3, 49, 64, 4, "f32"),
    (4, 36, 48, 2, "bf16"), (3, 49, 64, 4, "bf16"),
    (16, 4, 32, 2, "f32"), (9, 9, 48, 3, "f32"), (9, 9, 48, 3, "bf16"),
])
def test_plain_core_matches_grid_mhsa_pallas(G, N, C, heads, dtype):
    rng = np.random.default_rng(N * 100 + C)
    qkv = rng.normal(size=(G, N, 3 * C)).astype(np.float32)
    dout = rng.normal(size=(G, N, C)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    got = ga.grid_mhsa_packed(_t(qkv, tdt), heads)  # CPU: the plain version
    dqkv = ga.grid_mhsa_packed_backward(_t(qkv, tdt), _t(dout, tdt), heads)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q: grid_mhsa_pallas(q, heads),
                            jnp.asarray(qkv, jdt))
        (want_dqkv,) = vjp(jnp.asarray(dout, jdt))
    ftol, gtol = TOL[dtype]
    assert got.dtype == dqkv.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ftol, rtol=ftol)
    np.testing.assert_allclose(_np(dqkv), np.asarray(want_dqkv, np.float32),
                               atol=gtol, rtol=gtol)


def test_backward_keeps_the_probabilities_in_fp32():
    """#6's backward differs from autograd of its forward in bf16: dv sees
    the fp32 probabilities, not the ones rounded before P.V."""
    rng = np.random.default_rng(0)
    qkv = _t(rng.normal(size=(4, 36, 96)) * 2, torch.bfloat16)
    dout = _t(rng.normal(size=(4, 36, 32)), torch.bfloat16)
    got = ga.grid_mhsa_packed_backward_reference(qkv, dout, 2)
    q = qkv.clone().requires_grad_(True)
    ga.grid_mhsa_reference(q, 2, round_probs=True).backward(dout)
    want = ga.grid_mhsa_backward_reference(qkv, dout, 2, divide=True)
    assert torch.equal(got, want)
    assert not torch.equal(got[..., 64:], q.grad[..., 64:])  # dv differs
    # the autograd Function runs the plain versions both ways on the CPU
    q = qkv.clone().requires_grad_(True)
    out = ga.grid_mhsa_packed_autograd(q, 2, True)
    assert torch.equal(out, ga.grid_mhsa_reference(qkv, 2, round_probs=True))
    out.backward(dout)
    assert torch.equal(q.grad, got)


# ---- the tiny N=36 model against JAX's #6 ----------------------------------

@pytest.fixture(scope="module")
def tiny36():
    jmodel = jax_build_model(TINY36, use_pallas=True)
    init = jax.jit(jax_build_model(TINY36, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), dict(init))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    return jmodel, variables


def test_tiny_36_token_model_matches_jax_grid_mhsa_pallas(tiny36,
                                                         monkeypatch):
    """Eval logits and the train-mode gradients of a loss on them: JAX with
    use_pallas=True in interpret mode and OUTGRIDVIT_ATTN_T=0 runs #6 at
    both stages (N=36, and N=9 packed); the port runs #6 at N=36 and #1 at
    N=9 (the same function up to fp32 rounding)."""
    monkeypatch.setenv("OUTGRIDVIT_ATTN_T", "0")
    jmodel, variables = tiny36
    port = load_flax_variables(build_model(TINY36, device="cpu"), variables)
    seen = []
    packed = tblocks.grid_mhsa_packed_autograd
    monkeypatch.setattr(tblocks, "grid_mhsa_packed_autograd",
                        lambda q, *a: seen.append(q.shape) or packed(q, *a))
    rng = np.random.default_rng(1)
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
        got = port(_t(x))
    assert seen == [(2 * 4, 36, 48)]  # stage 0 took #6
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    port.train()
    (port(_t(x)) * _t(w)).sum().backward()
    want_g = jax_tree_to_port(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=k)


# ---- the full-width 48 px Model A-7M ---------------------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_a7m_48px_dispatch_and_param_count(monkeypatch):
    """One 48 px image through the full-width 7M model: stage 0 (N=36) runs
    #6, stages 1-3 (N=9) the #1 core tagged "t", every MLP #2's "t"."""
    chip_smoke = _chip_smoke()
    case = chip_smoke.A7M_48
    assert case.model == chip_smoke.FLAGSHIP_MODEL_CFG
    assert (case.img, case.crop_pad) == (48, 6)  # bench_config.py:75-76
    calls = []

    def spy(kind, fn, variant_of):
        def wrapped(*a):
            calls.append((kind, tuple(a[0].shape), variant_of(a)))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tblocks, "grid_mhsa_packed_autograd", spy(
        "packed", tblocks.grid_mhsa_packed_autograd, lambda a: None))
    monkeypatch.setattr(tblocks, "grid_mhsa_autograd", spy(
        "grid", tblocks.grid_mhsa_autograd, lambda a: a[3]))
    monkeypatch.setattr(tlayers, "mlp_branch_autograd", spy(
        "mlp", tlayers.mlp_branch_autograd, lambda a: a[11]))
    model = build_model(case.model, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == case.params \
        == 7_518_102
    with torch.no_grad():
        model(torch.zeros(1, 48, 48, 3))
    attn = [c for c in calls if c[0] != "mlp"]
    assert attn == ([("packed", (64, 36, 144), None)]
                    + [("grid", (64, 9, 288), "t")] * 2
                    + [("grid", (16, 9, 576), "t")] * 3
                    + [("grid", (4, 9, 768), "t")])
    assert {c[2] for c in calls if c[0] == "mlp"} == {"t"}
    got = [(s["attn"], s["G"], s["N"], s["C"], s["heads"])
           for s in chip_smoke.stage_shapes(case)]
    assert got == [("packed", 4096, 36, 48, 2), ("grid", 4096, 9, 96, 3),
                   ("grid", 1024, 9, 192, 6), ("grid", 256, 9, 256, 8)]
