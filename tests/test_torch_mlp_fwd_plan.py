"""The fused MLP branch's bf16 tensor-core forward, ``csrc/mlp_branch_mma.cu``
(TPU kernels #2 ``mlp_branch_pallas_t`` and #4 ``mlp_branch_pallas``,
forward half), checked on the CPU where it can be:

- Its launch plan (``ops/mlp_branch.py:mlp_branch_forward_plan``) at every
  MLP shape of the shipped configs at their own batch, at the serving batch
  64 and at the train batch 128 (the 7M model also at 48 and 96 px, the
  shapes ``chip_smoke.py`` drives), and at the card tests' edge shapes:
  the tiles cover M, C and H, the blocks walk every tile in about one wave,
  shared memory fits an H100 block, what one SM holds fits its shared
  memory, registers and threads, and the cache hands back the same plan.
  Its refusals (fp32, C or H not a multiple of 16, M < 1) send the launch
  to the FMA kernel's entry.
- A PyTorch emulation of the kernel's arithmetic: bf16 operands, both
  products summed in fp32 in k16 steps in ascending k (fc1 over C, fc2 over
  the hidden units chunk by chunk: one order), the LN statistics in the
  kernel's lane order and shuffle tree, the rounding points of the plain
  version. At C = 48, 64 and 448, H = 2C and 4C, with and without LN and
  for all three activations, against ``mlp_branch_reference``: y within 1
  bf16 ulp of the largest |y| of its row (where y cancels, one h rounding
  that the other order flips moves it by a fraction of a term), and at
  least 99% of y bitwise equal (``chip_smoke.py`` fails the kernel below
  90%). Against JAX ``mlp_branch_pallas_t`` (#2) and ``mlp_branch_pallas``
  (#4) in interpret mode at the bf16 tolerances of ``tests/test_torch_ops.py``
  (2e-2) and ``tests/test_torch_64px.py`` (5e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.mlp_branch_pallas import mlp_branch_pallas
from outgridvit_tpu.ops.mlp_branch_pallas_t import mlp_branch_pallas_t
from outgridvit_tpu_torch.ops import mlp_branch as mb
from outgridvit_tpu_torch.ops.activations import make_activation
from test_torch_mlp_bwd_plan import (
    BLOCK_SMEM,
    CONFIGS,
    EDGE,
    SHAPES,
    SM_SMEM,
    _bf,
    _config_shapes,
    _inputs,
    _ln_rows,
    _mm16,
    _ulp,
)

# the backward's shapes, and the same models at the serving batch
FWD_SHAPES = sorted(set(SHAPES) | {
    sh for path, img in CONFIGS.values()
    for sh in _config_shapes(path, img, 64)})


# ---- the launch plan --------------------------------------------------------

def _row(cols):
    """Bytes between two staged rows of ``cols`` bf16: an odd number of
    16-byte units."""
    return 16 * ((cols // 8) | 1)


def _fwd_bytes(C, H, split, buffers):
    """The kernel's shared memory, counted from its layout: two x tiles of
    128 / split tokens, then w1 [C, H] and w2 [H, C] (buffers 0) or
    ``buffers`` chunks of w1 [C, chunk] and w2 [chunk, C], then the a
    exchange tile [rows, chunk] where split > 1."""
    rows = 128 // split
    chunk = split * (32 if split <= 2 else 16)
    weights = (C * _row(H) + H * _row(C) if buffers == 0
               else buffers * (C * _row(chunk) + chunk * _row(C)))
    return (2 * rows * _row(C) + weights
            + (rows * _row(chunk) if split > 1 else 0))


@pytest.mark.parametrize("M,C,H", FWD_SHAPES + EDGE)
def test_forward_plan_at_every_shape(M, C, H):
    p = mb.mlp_branch_forward_plan(M, C, H)
    where = (M, C, H, p)
    # y columns split over the warps of a row tile; tiles over M
    assert p.split in (1, 2, 4, 8), where
    assert C % (16 * p.split) == 0 and C // p.split <= 128, where
    assert p.rows == 16 * 8 // p.split, where
    assert p.chunk == p.split * (32 if p.split <= 2 else 16), where
    assert (p.tiles - 1) * p.rows < M <= p.tiles * p.rows, where
    # every block walks a non-empty contiguous run; about one wave
    assert (p.blocks - 1) * p.tiles_per_block < p.tiles, where
    assert p.tiles <= p.blocks * p.tiles_per_block, where
    assert p.blocks <= 132 * p.blocks_per_sm, where
    # shared memory: the layout, within one block's and one SM's
    assert p.buffers in (0, 1, 2), where
    assert p.smem == _fwd_bytes(C, H, p.split, p.buffers), where
    assert p.smem <= BLOCK_SMEM, where
    assert p.blocks_per_sm >= 1, where
    assert p.blocks_per_sm * (p.smem + 1024) <= SM_SMEM, where
    assert p.blocks_per_sm * 256 * p.regs <= 65536, where
    assert p.blocks_per_sm * 256 <= 2048, where
    assert mb.forward_entry(M, C, H, torch.bfloat16) == "ogvt_mlp_branch_mma"
    # cached: the wrapper asks at every launch
    assert mb.mlp_branch_forward_plan(M, C, H) is p


@pytest.mark.parametrize("M,C,H", [
    (262_144, 64, 256),    # Tiny-ImageNet stage 0, batch 64 (#4's shapes)
    (262_144, 64, 128),
    (589_824, 48, 192),    # the 7M at 96 px, stage 0, batch 64
    (1_179_648, 48, 96)])
def test_forward_plan_keeps_the_weights_resident_at_stage0(M, C, H):
    # the launches with by far the most tokens: one row tile a warp, w1 and
    # w2 staged once a block, two blocks an SM, one wave of blocks
    p = mb.mlp_branch_forward_plan(M, C, H)
    assert (p.split, p.buffers, p.blocks_per_sm) == (1, 0, 2)
    assert p.blocks <= 2 * 132 and p.tiles_per_block >= 8


def test_forward_plan_cuts_small_launches_into_more_tiles():
    # the 7M's stage 3 at batch 64: 1,024 tokens would be 8 tiles of 128
    p = mb.mlp_branch_forward_plan(1024, 256, 1024)
    assert p.blocks >= 32 and p.rows <= 32


@pytest.mark.parametrize("act,regs,per_sm", [
    ("gelu", 128, 2), ("relu", 128, 2), ("silu", 255, 1)])
def test_forward_plan_register_cap_by_activation(act, regs, per_sm):
    # a 64-column y tile fits 128 registers, two blocks an SM, except under
    # SiLU, whose division's slow path spilled there
    p = mb.mlp_branch_forward_plan(65_536, 64, 256, torch.bfloat16, act)
    assert (p.regs, p.blocks_per_sm) == (regs, per_sm)
    assert mb.mlp_branch_forward_plan(65_536, 64, 256, torch.bfloat16,
                                      act) is p


@pytest.mark.parametrize("M,C,H,dtype", [
    (64, 48, 96, torch.float32),       # fp32: the FMA kernel's
    (64, 40, 160, torch.bfloat16),     # C not a multiple of 16
    (64, 48, 100, torch.bfloat16),     # H not a multiple of 16
    (0, 48, 96, torch.bfloat16)])
def test_forward_plan_refuses_what_the_kernel_does_not_take(M, C, H, dtype):
    with pytest.raises(ValueError, match=f"M={M}, C={C}, H={H}"):
        mb.mlp_branch_forward_plan(M, C, H, dtype)
    assert mb.forward_entry(M, C, H, dtype) == "ogvt_mlp_branch"


# ---- the kernel's arithmetic, emulated --------------------------------------

def emulate(x, ls, lb, w1, b1, w2, b2, act, eps, apply_ln):
    """y of ``ogvt_mlp_branch_mma``, emulated in fp32 (bf16 values as fp32):
    xn = round(LN(x)) from the staged bf16 (the kernel's LN order); h summed
    over C in k16 steps; a = round(act(round(h + b1))); y summed over H in
    k16 steps, + b2, rounded. The chunks and the warps' split change no
    order: every accumulator runs over its k in ascending k16 steps."""
    x, w1, b1, w2, b2 = (t.float() for t in (x, w1, b1, w2, b2))
    xn = _ln_rows(x, ls, lb, eps)[0] if apply_ln else x
    a = _bf(make_activation(act)(_bf(_mm16(xn, w1) + b1)))
    return (_mm16(a, w2) + b2).to(torch.bfloat16)


def _run(inp, act, apply_ln):
    return emulate(inp["x"], inp["ls"], inp["lb"], inp["w1"], inp["b1"],
                   inp["w2"], inp["b2"], act, 1e-5, apply_ln)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,mult", [(48, 2), (48, 4), (64, 2), (64, 4),
                                    (448, 2), (448, 4)])
def test_emulated_mma_forward_matches_the_plain_version(C, mult, apply_ln,
                                                        act):
    M, H = 300, mult * C
    inp = _inputs(M, C, H, 3 * C + H)
    got = _run(inp, act, apply_ln)
    want = mb.mlp_branch_reference(
        inp["x"], inp["ls"], inp["lb"], inp["w1"], inp["b1"], inp["w2"],
        inp["b2"], act, 1e-5, apply_ln)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    ulp = _ulp(torch.maximum(g.abs(), w.abs()).amax(-1, keepdim=True))
    assert bool(((g - w).abs() <= ulp).all()), \
        f"{((g - w).abs() / ulp).max().item()} ulp"
    same = (g == w).float().mean().item()
    assert same >= 0.99, same


def _jax_forward(inp, act, apply_ln, fn):
    j = lambda t, dt=jnp.bfloat16: jnp.asarray(t.float().numpy(), dt)
    args = [j(inp["x"]), j(inp["ls"], jnp.float32), j(inp["lb"], jnp.float32),
            j(inp["w1"]), j(inp["b1"]), j(inp["w2"]), j(inp["b2"])]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, act, 1e-5, apply_ln), np.float32)


@pytest.mark.parametrize("C,H,apply_ln,act,fn,tol", [
    # tests/test_torch_ops.py's bf16 tolerance for #2 (2e-2 abs + rel)
    (48, 192, True, "gelu", mlp_branch_pallas_t, 2e-2),
    (64, 128, False, "silu", mlp_branch_pallas_t, 2e-2),
    (448, 1792, True, "relu", mlp_branch_pallas_t, 2e-2),
    # tests/test_torch_64px.py's for #4 (5e-2)
    (64, 256, True, "gelu", mlp_branch_pallas, 5e-2),
    (48, 96, True, "gelu", mlp_branch_pallas, 5e-2)])
def test_emulated_mma_forward_matches_jax(C, H, apply_ln, act, fn, tol):
    M = 256
    inp = _inputs(M, C, H, C + 13)
    got = _run(inp, act, apply_ln).float().numpy()
    np.testing.assert_allclose(got, _jax_forward(inp, act, apply_ln, fn),
                               atol=tol, rtol=tol)
