"""Port parity, kernel #6 (``outgridvit_tpu/ops/grid_attention_pallas.py:
grid_mhsa_pallas``) at grids of N > 256 tokens, where the JAX model runs it
for every grid the fused branch (#5) cannot hold
(``outgridvit_tpu/models/blocks.py:283-290, 361-373``), and the 192 px Model
A-7M path that reaches it, against ``outgridvit_tpu`` on the same numpy
inputs (CPU). The plain core at N = 257 and 576 is held against
``grid_mhsa_pallas`` in ``tests/test_torch_grid_long.py``.

- The launch plans past 256 tokens: bf16 ``csrc/grid_mhsa_tiles.cu``'s
  (``ops/grid_attention.py:grid_mhsa_tiles_plan``, asked of
  ``csrc/grid_mhsa_tiles_layout.h``), fp32 ``csrc/grid_mhsa_long.cu``'s, at
  N = 257, 400, 576 and 784, both directions: every query row and key row
  covered exactly once by the launch's blocks and chunks, the shared bytes
  and registers within one SM; their refusals (hd % 8, hd > 64, N >
  4096); the entry point each N and dtype takes.
- A tiny Model A whose stage 0 has grids of N = 576 (48 px, dim 16, grid
  2) and stage 1 of N = 144: eval logits and train-mode gradients against
  JAX ``use_pallas=True`` in interpret mode with
  ``OUTGRIDVIT_FUSED_ATTN_N=0`` (which puts JAX on #6 at N >= 64).
- The full-width 192 px Model A-7M (``chip_smoke.py``'s ``a7m_192``): the
  kernel each stage dispatches to, and the parameter count, the JAX
  build's too.

Tolerances: 1e-4 on logits and gradients (``docs/PARITY.md``), as for the
N = 144 model.
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
from outgridvit_tpu_torch.models import blocks as tblocks
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops.attn_branch import attn_branch_fits
from outgridvit_tpu_torch.utils.port_jax import (
    jax_tree_to_port,
    load_flax_variables,
)

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
F32_ROWS = 64              # rows an fp32 long block takes a pass (two a row)
TINY576 = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "dpr_max": 0.0,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
         "outlook_heads": 4},
    ],
}
IMG = 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _fits_one_sm(smem, warps, regs, per_sm):
    assert smem <= BLOCK_SMEM
    assert per_sm >= 1
    assert per_sm * (smem + 1024) <= SM_SMEM
    assert per_sm * 32 * warps * regs <= 65536
    assert per_sm * 32 * warps <= 2048


# ---- the launch plans past 256 tokens ---------------------------------------

@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hd", [8, 24, 64])
@pytest.mark.parametrize("N", [257, 400, 576, 784])
def test_tiles_plan_covers_every_row_once(N, hd, backward):
    G, heads = 3, 2
    C = heads * hd
    p = ga.grid_mhsa_tiles_plan(G, N, C, heads, backward)
    where = (N, hd, backward, p)
    assert 1 <= p.warps <= 16 and p.rows == 16 * p.warps, where
    assert p.blocks == G * heads * p.parts, where
    # a unit's blocks: rows [b * rows, (b + 1) * rows) below N, each row
    # once, no block without one
    own = [r for b in range(p.parts)
           for r in range(b * p.rows, min(N, (b + 1) * p.rows))]
    assert own == list(range(N)), where
    assert (p.parts - 1) * p.rows < N <= p.covered == p.parts * p.rows
    # the other side streams in chunks: each row once, a ring of buffers
    chunks = -(-N // p.chunk)
    streamed = [r for c in range(chunks)
                for r in range(c * p.chunk, min(N, (c + 1) * p.chunk))]
    assert streamed == list(range(N)) and p.chunk % 16 == 0, where
    assert p.stages >= 2, where
    # staged rows an odd number of 16-byte units, at most 16 bytes padding
    assert (p.row_bytes // 16) % 2 == 1 and 0 <= p.row_bytes - 2 * hd <= 16
    tile = p.chunk * p.row_bytes
    # own rows (q; q and dO), then the ring of k and v chunks
    assert p.smem_bytes == (2 if backward else 1) * p.rows * p.row_bytes \
        + p.stages * 2 * tile, where
    _fits_one_sm(p.smem_bytes, p.warps, p.regs, p.blocks_per_sm)
    if backward:
        # the key kernel: k and v rows, then chunks of q, dO and the four
        # fp32 statistics a query row; the scratch: D, one a covered row
        assert p.smem_key == 2 * p.rows * p.row_bytes \
            + p.stages * (2 * tile + 4 * 4 * p.chunk), where
        _fits_one_sm(p.smem_key, p.warps, p.regs_key, p.blocks_per_sm_key)
        assert p.scratch_floats == G * heads * p.covered, where
    else:
        assert p.smem_key == p.regs_key == p.scratch_floats == 0, where
    # the forward's saved statistics: three a covered row
    assert p.saved_floats == G * heads * 3 * p.covered, where
    assert ga.grid_mhsa_tiles_plan(G, N, C, heads, backward) is p


def test_tiles_plan_at_the_192px_shape():
    """The 7M model's stage 0 at 192 px: 36 m16 tiles of rows a head, three
    blocks of 12 warps; hd 24 keeps two blocks an SM, forward and
    backward."""
    fwd = ga.grid_mhsa_tiles_plan(4096, 576, 48, 2, False)
    bwd = ga.grid_mhsa_tiles_plan(2048, 576, 48, 2, True)
    assert (fwd.parts, fwd.warps, fwd.blocks, fwd.smem_bytes) == (
        3, 12, 24_576, 21_504)
    assert fwd.regs == 64 and fwd.blocks_per_sm == 2
    assert (bwd.blocks, bwd.smem_bytes, bwd.smem_key) == (12_288, 30_720,
                                                          32_768)
    assert bwd.scratch_floats == 2048 * 2 * 576
    assert bwd.saved_floats == fwd.saved_floats * 2048 // 4096 \
        == 2048 * 2 * 3 * 576


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N", [257, 400, 576, 784])
def test_fp32_long_plan_past_256_tokens(N, backward):
    """fp32 stays on csrc/grid_mhsa_long.cu: one block a (grid, head) unit
    that walks all N rows in passes of 64, each row once, and keeps only
    the backward's three statistics a row in shared memory."""
    p = ga.grid_mhsa_long_plan(3, N, 48, 2, backward, "float32")
    assert p.blocks == 3 * 2 and p.warps == ga.LONG_F32_WARPS
    assert 32 * p.warps // 2 == F32_ROWS
    rows = [r0 + t for r0 in range(0, N, F32_ROWS) for t in range(F32_ROWS)
            if r0 + t < N]
    assert rows == list(range(N))
    assert p.smem_bytes == (12 * N if backward else 0) <= 48 * 1024
    _fits_one_sm(p.smem_bytes, p.warps, p.regs, p.blocks_per_sm)


@pytest.mark.parametrize("N,C,heads,what", [
    (576, 24, 2, "hd=12"), (576, 144, 2, "hd=72"), (300, 40, 4, "hd=10"),
    (4097, 48, 2, "N=4097"), (256, 48, 2, "N=256")])
def test_tiles_plan_refuses_what_the_kernels_do_not_take(N, C, heads, what):
    for backward in (False, True):
        with pytest.raises(ValueError, match=what) as e:
            ga.grid_mhsa_tiles_plan(2, N, C, heads, backward)
        assert "ROADMAP.md §2" in str(e.value)
        if N > 256:  # and fp32, on the long kernel
            with pytest.raises(ValueError, match=what):
                ga.grid_mhsa_long_plan(2, N, C, heads, backward, "float32")


@pytest.mark.parametrize("N,bf16,fp32", [
    (36, "ogvt_grid_mhsa_packed_mma", "ogvt_grid_mhsa_packed"),
    (144, "ogvt_grid_mhsa_long", "ogvt_grid_mhsa_long"),
    (256, "ogvt_grid_mhsa_long", "ogvt_grid_mhsa_long"),
    (257, "ogvt_grid_mhsa_tiles", "ogvt_grid_mhsa_long"),
    (576, "ogvt_grid_mhsa_tiles", "ogvt_grid_mhsa_long"),
    (784, "ogvt_grid_mhsa_tiles", "ogvt_grid_mhsa_long")])
def test_packed_entry_by_n_and_dtype(N, bf16, fp32):
    for dtype, entry in ((torch.bfloat16, bf16), (torch.float32, fp32)):
        assert ga.grid_mhsa_packed_entry(N, dtype) == entry
        assert ga.grid_mhsa_packed_entry(N, dtype, True) == entry + "_bwd"


def test_packed_on_a_cpu_tensor_is_the_plain_version_past_256():
    qkv = torch.randn(2, 300, 48, generator=torch.Generator().manual_seed(0))
    dout = torch.randn(2, 300, 16, generator=torch.Generator().manual_seed(1))
    n = (ga.grid_mhsa_packed.launches, ga.grid_mhsa_packed_backward.launches)
    assert torch.equal(ga.grid_mhsa_packed(qkv, 2),
                       ga.grid_mhsa_packed_reference(qkv, 2))
    assert torch.equal(ga.grid_mhsa_packed_backward(qkv, dout, 2),
                       ga.grid_mhsa_packed_backward_reference(qkv, dout, 2))
    assert (ga.grid_mhsa_packed.launches,
            ga.grid_mhsa_packed_backward.launches) == n


# ---- the tiny N=576 model against JAX's #6 ---------------------------------

def test_tiny_576_token_model_matches_jax_grid_mhsa_pallas(monkeypatch):
    """Eval logits and the train-mode gradients of a loss on them: JAX with
    use_pallas=True in interpret mode and OUTGRIDVIT_FUSED_ATTN_N=0 runs #6
    at both stages (N = 576, then N = 144); the port runs #6 at both, since
    #5 holds neither."""
    monkeypatch.setenv("OUTGRIDVIT_FUSED_ATTN_N", "0")
    jmodel = jax_build_model(TINY576, use_pallas=True)
    init = jax.jit(jax_build_model(TINY576, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), dict(init))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    port = load_flax_variables(build_model(TINY576, device="cpu"), variables)
    assert not attn_branch_fits(576, 16, 2)
    assert not attn_branch_fits(144, 32, 2)
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
    assert seen == [(2 * 4, 576, 48), (2 * 4, 144, 96)]
    assert [ga.grid_mhsa_packed_entry(s[1], torch.bfloat16) for s in seen] \
        == ["ogvt_grid_mhsa_tiles", "ogvt_grid_mhsa_long"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
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


# ---- the full-width 192 px Model A-7M --------------------------------------

def test_a7m_192px_dispatch_and_param_count(monkeypatch):
    """One 192 px image through the full-width 7M model: stage 0 (N = 576)
    runs #6 on the entries past 256 tokens, stages 1-3 (N = 144, which #5
    cannot hold) on the long kernel's; the JAX build has the same
    parameters."""
    chip_smoke = _chip_smoke()
    case = chip_smoke.A7M_192
    assert case == dataclasses.replace(
        chip_smoke.FLAGSHIP, tag="a7m_192", img=192, crop_pad=24,
        loss_steps=6, fixed_draws_loss=True, train_batch=32, compare_batch=8)
    assert case.crop_pad == max(4, 192 // 8)  # bench_config.py:75-76
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
        model(torch.zeros(1, 192, 192, 3))
    assert calls == ([("packed", (64, 576, 144))]
                     + [("packed", (64, 144, 288))] * 2
                     + [("packed", (16, 144, 576))] * 3
                     + [("packed", (4, 144, 768))])
    assert [ga.grid_mhsa_packed_entry(shape[1], torch.bfloat16)
            for _, shape in calls] == (["ogvt_grid_mhsa_tiles"]
                                       + ["ogvt_grid_mhsa_long"] * 6)
    got = [(s["attn"], s["G"], s["N"], s["C"], s["heads"])
           for s in chip_smoke.stage_shapes(case)]
    assert got == [("tiles", 4096, 576, 48, 2), ("long", 4096, 144, 96, 3),
                   ("long", 1024, 144, 192, 6), ("long", 256, 144, 256, 8)]
    plan, _ = chip_smoke.launch_plan(case, chip_smoke.stage_shapes(case))
    assert (plan["grid_mhsa_tiles"], plan["grid_mhsa_long"],
            plan["grid_mhsa_packed"], plan["attn_branch"]) == (1, 6, 0, 0)
    # 224 px: stage 0 at N = 784, the compare's extra shape
    sh = chip_smoke.stage_shapes(dataclasses.replace(case, img=224), 8)[0]
    assert (sh["attn"], sh["G"], sh["N"]) == ("tiles", 512, 784)
    shapes = jax.eval_shape(
        jax_build_model(case.model, use_pallas=False).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 192, 192, 3),
                                                    jnp.float32))
    assert sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes["params"])) == 7_518_102
