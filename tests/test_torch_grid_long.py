"""Port parity, kernel #6 (``outgridvit_tpu/ops/grid_attention_pallas.py:
grid_mhsa_pallas``) at grids of N >= 64 tokens, where the JAX model falls
back to it from the fused branch (#5) (``outgridvit_tpu/models/blocks.py:
283-291, 359-373``), and the 96 px Model A-7M path that runs it, against
``outgridvit_tpu`` on the same numpy inputs (CPU).

- The plain forward and backward (:func:`grid_mhsa_packed_reference`,
  :func:`grid_mhsa_packed_backward_reference`, what ``grid_mhsa_packed``
  computes on a CPU tensor) against ``grid_mhsa_pallas`` in interpret mode
  at N = 64, 100 and 144, hd 8 and 24, and at N = 257 and 576, hd 8, fp32
  and bf16.
- ``attn_branch_fits`` at the N >= 64 shapes of the configs, and the route
  :class:`MultiHeadSelfAttention` takes for each: #5 (or #12 with
  ``attn_nhwc``) where the branch's kernels hold the grid, #6 where not.
- A tiny Model A whose stage 0 has grids of N = 144 (24 px, dim 16, grid 2:
  #5's backward would need 249,984 shared bytes): fp32 logits and the
  train-mode gradients against JAX ``use_pallas=True`` in interpret mode
  with ``OUTGRIDVIT_FUSED_ATTN_N=0`` (off the TPU ``attn_branch_feasible``
  always says yes; the variable is what puts JAX on #6 there).
- The launch plan of ``csrc/grid_mhsa_long.cu``
  (``ops/grid_attention.py:grid_mhsa_long_plan``) at the 96 px 7M model's
  stage 0 (batch 64 and 128) and the card tests' edge shapes, and its
  refusals.
- The full-width 96 px Model A-7M (``chip_smoke.py``'s ``a7m_96``): the
  kernel each stage dispatches to, and the parameter count, the JAX
  build's too.

Tolerances: 3e-5 forward and 2e-3 gradients in fp32 (``tests/
test_grid_attention_pallas_t.py``), bf16 against JAX in bf16 within 5e-2
(one bf16 rounding of an O(1) value); 1e-4 on logits and gradients
(``docs/PARITY.md``).
"""

import dataclasses
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
from outgridvit_tpu_torch.models.layers import LayerNorm
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops.attn_branch import attn_branch_fits, smem_bytes
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
TINY144 = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.0,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG = 24


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---- the core against grid_mhsa_pallas -------------------------------------

# (N, hd): the long kernel's grids at two head widths, and past 256 tokens
# (csrc/grid_mhsa_tiles.cu's and the fp32 long kernel's) at hd 8
CORE = [(N, hd) for N in (64, 100, 144) for hd in (8, 24)] + [(257, 8),
                                                              (576, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,hd", CORE)
def test_plain_core_matches_grid_mhsa_pallas(N, hd, dtype):
    G, heads = 2, 2
    C = heads * hd
    rng = np.random.default_rng(N * 100 + hd)
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


# ---- where #5 fits, and the route -------------------------------------------

# (N, C, heads): TIN's stage 0, the default Model A's, a wider N = 64 grid,
# the 7M model's stage 0 at 96 px and the tiny model's below
FITS = [(64, 64, 2, True), (64, 80, 2, True), (64, 96, 3, False),
        (144, 48, 2, False), (144, 16, 2, False)]


@pytest.mark.parametrize("N,C,heads,fits", FITS)
def test_attn_branch_fits_checks_forward_and_backward(N, C, heads, fits):
    fwd, bwd = (smem_bytes(N, C, heads, b) for b in (False, True))
    assert attn_branch_fits(N, C, heads) is fits
    assert fits == (max(fwd, bwd) <= BLOCK_SMEM)
    assert fwd <= BLOCK_SMEM  # each of these fails, if at all, backward


def test_the_backward_decides_at_the_issue_shapes():
    assert smem_bytes(64, 96, 3, True) == 240_128
    assert smem_bytes(144, 48, 2, False) == 195_264
    assert smem_bytes(144, 48, 2, True) == 406_656
    assert smem_bytes(144, 16, 2, True) == 249_984


def _route(monkeypatch, N, C, heads, attn_nhwc, train=False):
    """The attention cores one MultiHeadSelfAttention call takes for grids
    of N tokens (grid size 2 on a 2 sqrt(N) map), in eval mode or, with
    ``train``, forward and backward."""
    seen = []
    for kind, name in (("branch", "attn_branch_autograd"),
                       ("nhwc", "attn_branch_nhwc_autograd"),
                       ("packed", "grid_mhsa_packed_autograd"),
                       ("grid", "grid_mhsa_autograd")):
        fn = getattr(tblocks, name)
        monkeypatch.setattr(tblocks, name, lambda *a, _f=fn, _k=kind: (
            seen.append((_k, tuple(a[0].shape))) or _f(*a)))
    mhsa = tblocks.MultiHeadSelfAttention(C, heads, attn_nhwc=attn_nhwc)
    gen = torch.Generator().manual_seed(N)
    with torch.no_grad():
        for p in mhsa.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    side = 2 * int(round(N ** 0.5))
    x = torch.randn(1, side, side, C, generator=gen)
    with torch.set_grad_enabled(train):
        y = mhsa.train(train)(x.requires_grad_(train), LayerNorm(C, 1e-5), 2)
    if train:
        y.square().sum().backward()
        assert torch.isfinite(x.grad).all()
    assert y.shape == x.shape and torch.isfinite(y).all()
    return seen


@pytest.mark.parametrize("attn_nhwc", [False, True])
@pytest.mark.parametrize("N,C,heads,fits", FITS)
def test_mhsa_routes_past_the_fused_branch_where_it_does_not_fit(
        monkeypatch, N, C, heads, fits, attn_nhwc):
    seen = _route(monkeypatch, N, C, heads, attn_nhwc)
    side = 2 * int(N ** 0.5)
    if fits:
        want = [("nhwc", (1, side, side, C)) if attn_nhwc
                else ("branch", (4, N, C))]
    else:  # LN, qkv, #6, proj on the partitioned tokens
        want = [("packed", (4, N, 3 * C))]
    assert seen == want


@pytest.mark.parametrize("N,C,heads,fits", FITS)
def test_eval_and_train_route_alike(monkeypatch, N, C, heads, fits):
    """The route depends on the shape only: a forward alone and a forward
    with its backward take the same core (#5's fit counts its backward)."""
    first = list(_route(monkeypatch, N, C, heads, False))
    assert _route(monkeypatch, N, C, heads, False, train=True) == first


# ---- the tiny N=144 model against JAX's #6 ---------------------------------

@pytest.fixture(scope="module")
def tiny144():
    jmodel = jax_build_model(TINY144, use_pallas=True)
    init = jax.jit(jax_build_model(TINY144, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), dict(init))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    return jmodel, variables


def test_tiny_144_token_model_matches_jax_grid_mhsa_pallas(tiny144,
                                                           monkeypatch):
    """Eval logits and the train-mode gradients of a loss on them: JAX with
    use_pallas=True in interpret mode and OUTGRIDVIT_FUSED_ATTN_N=0 runs #6
    at both stages (N = 144, then N = 36); the port runs #6 at both, stage 0
    because #5 does not fit it."""
    monkeypatch.setenv("OUTGRIDVIT_FUSED_ATTN_N", "0")
    jmodel, variables = tiny144
    port = load_flax_variables(build_model(TINY144, device="cpu"), variables)
    assert not attn_branch_fits(144, 16, 2)
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
    assert seen == [(2 * 4, 144, 48), (2 * 4, 36, 96)]
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


# ---- the launch plan of csrc/grid_mhsa_long.cu -----------------------------

def _a7m_96(batch):
    """(G, N, C, heads) of the 7M model's stage 0 at 96 px."""
    s = _chip_smoke().FLAGSHIP_MODEL_CFG["stages"][0]
    g = s["grid_size"]
    return batch * g * g, (96 // g) ** 2, s["dim"], s["num_heads"]


SHAPES = [pytest.param(*_a7m_96(64), id="a7m_96-b64"),
          pytest.param(*_a7m_96(128), id="a7m_96-b128"),
          (3, 64, 16, 2), (3, 65, 48, 2), (3, 100, 64, 2), (3, 200, 128, 2),
          (3, 256, 128, 2), (1, 256, 64, 8)]


def test_the_7m_at_96px_gives_n144():
    assert _a7m_96(64) == (4096, 144, 48, 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("G,N,C,heads", SHAPES)
def test_long_plan_at_every_shape(G, N, C, heads, backward, dtype):
    p = ga.grid_mhsa_long_plan(G, N, C, heads, backward, dtype)
    hd = C // heads
    where = (G, N, C, heads, backward, dtype, p)
    assert p.blocks == G * heads, where  # one block per (grid, head)
    assert p.smem_bytes <= BLOCK_SMEM, where
    if dtype == "bfloat16":
        # one warp per m16 tile of query rows; the staged rows cover N
        assert p.warps == -(-N // 16) <= 16 and p.rows == 16 * p.warps
        assert 0 <= p.rows - N < 16, where
        # rows an odd number of 16-byte units, at most 16 bytes of padding
        assert (p.row_bytes // 16) % 2 == 1 and 0 <= p.row_bytes - 2 * hd \
            <= 16, where
        tiles = 5 if backward else 3  # q, k, v (and dO, dq)
        assert p.smem_bytes == tiles * p.rows * p.row_bytes \
            + (16 * p.rows if backward else 0), where
        assert p.regs == (64 if hd <= (16 if backward else 32) else 128)
    else:
        assert p.warps == ga.LONG_F32_WARPS and p.regs == 255
        assert p.smem_bytes == (12 * N if backward else 0), where
    # what one SM holds at the register cap fits it
    assert p.blocks_per_sm >= 1, where
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SMEM, where
    assert p.blocks_per_sm * 32 * p.warps * p.regs <= 65536, where
    assert p.blocks_per_sm * 32 * p.warps <= 2048, where
    assert ga.grid_mhsa_long_plan(G, N, C, heads, backward, dtype) is p


def test_long_plan_keeps_several_blocks_at_the_96px_shape():
    """At the 7M model's stage 0 (9 warps a block, hd 24) the forward
    keeps three blocks an SM; the backward, whose cap is 128 registers at
    hd 24, at least one."""
    G, N, C, heads = _a7m_96(64)
    fwd = ga.grid_mhsa_long_plan(G, N, C, heads, False)
    bwd = ga.grid_mhsa_long_plan(2 * G, N, C, heads, True)
    assert (fwd.warps, fwd.blocks_per_sm, fwd.smem_bytes) == (9, 3, 20_736)
    assert (bwd.warps, bwd.blocks, bwd.smem_bytes) == (9, 16_384, 36_864)


@pytest.mark.parametrize("G,N,C,heads,dtype,what", [
    (2, 63, 48, 2, "bfloat16", "N=63"), (2, 257, 48, 2, "bfloat16", "N=257"),
    (2, 4097, 48, 2, "float32", "N=4097"),
    (2, 144, 24, 2, "bfloat16", "hd=12"),
    (2, 144, 144, 2, "float32", "hd=72"), (2, 144, 8, 2, "bfloat16", "hd=4"),
    (2, 144, 48, 5, "bfloat16", "heads=5")])
def test_long_plan_refuses_what_the_kernel_does_not_take(G, N, C, heads,
                                                         dtype, what):
    with pytest.raises(ValueError, match=what):
        ga.grid_mhsa_long_plan(G, N, C, heads, False, dtype)
    if "heads" not in what:
        with pytest.raises(ValueError, match="ROADMAP.md §2"):
            ga.grid_mhsa_long_plan(G, N, C, heads, True, dtype)


def test_long_plan_refuses_another_dtype():
    with pytest.raises(ValueError, match="float16"):
        ga.grid_mhsa_long_plan(2, 144, 48, 2, False, "float16")


# ---- the full-width 96 px Model A-7M ---------------------------------------

def test_a7m_96px_dispatch_and_param_count(monkeypatch):
    """One 96 px image through the full-width 7M model: stage 0 (N = 144,
    which #5 cannot hold) and stages 1-3 (N = 36) all run #6; every MLP
    #2's or #4's kernel; the JAX build has the same parameters."""
    chip_smoke = _chip_smoke()
    case = chip_smoke.A7M_96
    assert case == dataclasses.replace(chip_smoke.FLAGSHIP, tag="a7m_96",
                                       img=96, crop_pad=12)
    assert case.crop_pad == max(4, 96 // 8)  # bench_config.py:75-76
    calls = []
    for kind, name in (("branch", "attn_branch_autograd"),
                       ("packed", "grid_mhsa_packed_autograd"),
                       ("grid", "grid_mhsa_autograd")):
        fn = getattr(tblocks, name)
        monkeypatch.setattr(tblocks, name, lambda *a, _f=fn, _k=kind: (
            calls.append((_k, tuple(a[0].shape))) or _f(*a)))
    model = build_model(case.model, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == case.params \
        == 7_518_102
    with torch.no_grad():
        model(torch.zeros(1, 96, 96, 3))
    assert calls == ([("packed", (64, 144, 144))]
                     + [("packed", (64, 36, 288))] * 2
                     + [("packed", (16, 36, 576))] * 3
                     + [("packed", (4, 36, 768))])
    got = [(s["attn"], s["G"], s["N"], s["C"], s["heads"])
           for s in chip_smoke.stage_shapes(case)]
    assert got == [("long", 4096, 144, 48, 2), ("packed", 4096, 36, 96, 3),
                   ("packed", 1024, 36, 192, 6), ("packed", 256, 36, 256, 8)]
    plan, _ = chip_smoke.launch_plan(case, chip_smoke.stage_shapes(case))
    assert (plan["grid_mhsa_long"], plan["grid_mhsa_packed"],
            plan["attn_branch"]) == (1, 6, 0)
    shapes = jax.eval_shape(
        jax_build_model(case.model, use_pallas=False).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 96, 96, 3),
                                                    jnp.float32))
    assert sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes["params"])) == 7_518_102
