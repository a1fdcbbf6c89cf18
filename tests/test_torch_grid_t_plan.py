"""The grid core's tensor-core kernel at 1 <= N <= 16, ``csrc/grid_mhsa_th.cu``,
for TPU kernel #1 (``grid_mhsa_pallas_t``, tag "t"), checked on the CPU
where it can be:

- Its launch plan (``ops/grid_attention.py:grid_mhsa_th_plan``, asked of
  ``csrc/grid_mhsa_th_layout.h`` through the host layout library) at every
  "t" shape of the shipped configs (the grids of N <= 16 tokens that
  ``models/blocks.py`` sends to the grid core: the 7M model, Model A's 14M
  and SVHN configs, Model B; and the 7M model at 48 px, N = 9), forward and
  backward, at batch 128, 64 and 1, and at a G that does not fill its last
  unit: 16 // N grids a unit, every (unit, head) once, a block's shared
  memory within an H100 block and what an SM holds within its shared
  memory, registers and threads.
- The refusals of the plan and of the layout query (N = 0, 17; hd 12, 72)
  and the route, decided without a device from dtype, shape and tag
  (``grid_mhsa_entry``): bf16 takes the tensor-core kernel, fp32 and a head
  width it refuses the FMA kernel ``csrc/grid_mhsa.cu``.
- A PyTorch emulation of the kernel's packed, masked arithmetic (the th
  emulation of ``tests/test_torch_grid_th_plan.py`` with 16 // N grids a
  unit, rows past them zero-filled, the logits masked block-diagonally, a
  row without keys given probabilities of 0), held against the plain
  versions at N in {1, 2, 4, 5, 7, 9, 16}: NaN-free; before the cast within
  2^-14 of the largest fp32 value; after it within 5e-2 (the bf16 tolerance
  of ``tests/test_torch_64px.py``) with at least 98% of the outputs bitwise
  the plain version's (a flipped final rounding now and then); at N = 16
  bitwise th's emulation. And against the JAX ``grid_mhsa_pallas_t``,
  forward and vjp in interpret mode, at N = 4 and 9 (5e-2, bf16).

About 10 s.
"""

import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.grid_attention_pallas_t import grid_mhsa_pallas_t
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops import kernel_build
from test_torch_grid_th_plan import (
    _inputs,
    _rel,
    _times,
    th_backward_emulated,
    th_forward_emulated,
)

CONFIGS = sorted(p for p in (Path(__file__).resolve().parents[1]
                             / "configs").glob("*.yaml")
                 if "model" in yaml.safe_load(p.read_text()))
SMS_SMEM = 228 * 1024      # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for


def _t_shapes():
    """(grids an image, N, C, heads) of every grid-core stage tagged "t",
    from the configs' ``model:`` and ``data.img_size`` (and the 7M model at
    48 px), with the config and stage as the id."""
    out = []
    sizes = [(p, yaml.safe_load(p.read_text())) for p in CONFIGS]
    sizes = [(p.stem, cfg, cfg["data"]["img_size"]) for p, cfg in sizes]
    sizes += [(f"{stem}_48", cfg, 48) for stem, cfg, _ in sizes
              if stem == "cifar100_model_a_7m"]
    for stem, cfg, img in sizes:
        for si, s in enumerate(cfg["model"]["stages"]):
            g, C = s["grid_size"], s["dim"]
            N = ((img >> si) // g) ** 2
            if N <= ga.MAX_TOKENS and ga.grid_mhsa_variant(N, C) == "t":
                out.append(pytest.param(g * g, N, C, s["num_heads"],
                                        id=f"{stem}-stage{si}"))
    return out


def test_the_configs_give_the_t_shapes():
    shapes = {p.values[1:] for p in _t_shapes()}
    # the 7M model's and Model B's stage 0 (N = 16), their stages 1-3
    # (N = 4), the 7M model's at 48 px (N = 9)
    assert {(16, 48, 2), (16, 64, 2), (4, 96, 3), (4, 384, 6),
            (9, 256, 8)} <= shapes, shapes
    assert {C // heads for _, C, heads in shapes} >= {24, 32, 64}
    # the tensor-core kernel takes every one of them
    assert all(ga.th_takes(N, C, heads) for N, C, heads in shapes), shapes


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [128, 64, 1])
@pytest.mark.parametrize("grids,N,C,heads", _t_shapes())
def test_t_plan_at_every_shipped_shape(grids, N, C, heads, batch, backward):
    G = batch * grids
    p = ga.grid_mhsa_th_plan(G, N, C, heads, backward)
    hd = C // heads
    where = (G, N, C, heads, backward, p)
    # one head of 16 // N adjacent grids a warp, four warps a block
    assert p.grids_per_unit == 16 // N and p.warps == 4, where
    assert p.tiles == (4 if backward else 3), where
    units = -(-G // p.grids_per_unit) * heads
    assert (p.blocks - 1) * p.warps < units <= p.blocks * p.warps, where
    assert p.grids_per_block == p.warps * p.grids_per_unit / heads
    # rows an odd number of 16-byte units (ldmatrix without bank conflicts)
    assert p.row_bytes >= 2 * hd and (p.row_bytes // 16) % 2 == 1, where
    assert p.smem_bytes == p.warps * p.tiles * 16 * p.row_bytes, where
    assert p.smem_bytes <= BLOCK_SMEM, where
    # what one SM holds: shared memory, registers, threads
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SMS_SMEM, where
    assert p.blocks_per_sm * p.warps * 32 * p.regs <= 65536, where
    assert p.blocks_per_sm >= 6, where
    assert p.grids_in_flight == p.blocks_per_sm * p.grids_per_block
    assert ga.grid_mhsa_th_plan(G, N, C, heads, backward) is p


@pytest.mark.parametrize("G,N", [(7, 5), (1, 4), (13, 3), (9, 2)])
def test_t_plan_covers_a_last_unit_part_empty(G, N):
    # G % (16 // N) != 0: the last unit holds fewer grids, none is dropped
    p = ga.grid_mhsa_th_plan(G, N, 64, 2, True)
    per = 16 // N
    assert G % per and p.grids_per_unit == per
    assert p.blocks == -(-(-(-G // per) * 2) // 4)


@pytest.mark.parametrize("N,C,heads", [(0, 64, 2), (17, 64, 2),
                                       (16, 36, 3), (4, 144, 2)])
def test_t_plan_and_layout_refuse_what_the_kernel_does_not_take(N, C, heads):
    # N outside 1..16, hd 12 and 72
    with pytest.raises(ValueError, match=f"N={N}, C={C}"):
        ga.grid_mhsa_th_plan(4, N, C, heads, False)
    out = (ctypes.c_int * 6)()
    lib = kernel_build.load_layouts()
    for backward in (0, 1):
        assert lib.ogvt_grid_mhsa_th_layout(N, C, heads, backward, out) == 1
    assert list(out) == [0] * 6  # nothing written
    assert not ga.th_takes(N, C, heads)


@pytest.mark.parametrize("dtype,N,C,heads,variant,want", [
    (torch.bfloat16, 16, 64, 2, "t", "ogvt_grid_mhsa_th"),
    (torch.bfloat16, 4, 96, 3, "t", "ogvt_grid_mhsa_th"),
    (torch.bfloat16, 9, 256, 8, "t", "ogvt_grid_mhsa_th"),
    (torch.bfloat16, 1, 8, 1, "t", "ogvt_grid_mhsa_th"),
    (torch.bfloat16, 16, 448, 8, "th", "ogvt_grid_mhsa_th"),
    (torch.bfloat16, 9, 36, 3, "t", "ogvt_grid_mhsa"),      # hd 12
    (torch.bfloat16, 16, 144, 2, "t", "ogvt_grid_mhsa"),    # hd 72
    (torch.bfloat16, 16, 144, 2, "th", "ogvt_grid_mhsa_th"),  # raises
    (torch.float32, 16, 64, 2, "t", "ogvt_grid_mhsa"),
    (torch.float32, 4, 96, 3, "t", "ogvt_grid_mhsa"),
    (torch.float32, 16, 384, 6, "th", "ogvt_grid_mhsa")])
def test_route_by_dtype_shape_and_tag(dtype, N, C, heads, variant, want):
    for backward, sfx in ((False, ""), (True, "_bwd")):
        assert ga.grid_mhsa_entry(N, C, heads, dtype, variant,
                                  backward) == want + sfx


def test_launch_refuses_an_entry_of_the_other_direction():
    qkv = torch.zeros(2, 4, 3 * 64)
    with pytest.raises(ValueError, match="entry"):
        ga._launch("ogvt_grid_mhsa_th_bwd", qkv, 2)
    with pytest.raises(ValueError, match="entry"):
        ga._launch("ogvt_grid_mhsa", qkv, 2, "t", torch.zeros(2, 4, 64))


# ---- the kernel's packed, masked arithmetic, emulated ----------------------

def _units(x, N):
    """x [G, N, W] -> [units, 16, W]: 16 // N adjacent grids a unit, rows
    past them and the grids past G zero-filled; and each unit's real rows."""
    G, _, W = x.shape
    per = 16 // N
    U = -(-G // per)
    packed = torch.zeros(U * per, N, x.shape[-1], dtype=x.dtype)
    packed[:G] = x
    packed = packed.reshape(U, per * N, W)
    out = torch.zeros(U, 16, W, dtype=x.dtype)
    out[:, :per * N] = packed
    rows = torch.tensor([min(per, G - u * per) * N for u in range(U)])
    return out, rows


def _ununits(y, G, N):
    per = 16 // N
    return y[:, :per * N].reshape(-1, N, y.shape[-1])[:G]


def _mask(rows, N):
    """[units, 16, 16]: column c is a key of row r where both are real rows
    of the same grid, the kernel's (x * ceil(256 / N)) >> 8 = x // N."""
    x = torch.arange(16)
    grid = (x * (-(-256 // N))) >> 8
    assert torch.equal(grid, x // N)
    live = x[None] < rows[:, None]
    row = torch.where(live, grid, -1)
    col = torch.where(live, grid, -2)
    return row[:, :, None] == col[:, None, :]


def _masked_probs(q, k, hd, mask):
    logits = torch.einsum("gnhd,gmhd->ghnm", q, k) * hd**-0.5
    logits = torch.where(mask[:, None], logits, -torch.inf)
    mx = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - torch.where(mx == -torch.inf, 0.0, mx))
    s = e.sum(-1, keepdim=True)
    return e * torch.where(s == 0, 0.0, 1.0 / s)


def _split_units(qkv, heads):
    G, N, C3 = qkv.shape
    hd = C3 // 3 // heads
    x, rows = _units(qkv.float(), N)
    q, k, v = x.reshape(-1, 16, 3, heads, hd).unbind(2)
    return q, k, v, hd, _mask(rows, N)


def unit_forward_emulated(qkv, heads, terms=2, cast=True):
    G, N = qkv.shape[:2]
    q, k, v, hd, mask = _split_units(qkv, heads)
    a = _masked_probs(q, k, hd, mask)
    out = _times("ghnm,gmhd->gnhd", a, v, terms)
    out = _ununits(out.reshape(out.shape[0], 16, -1), G, N)
    return out.to(qkv.dtype) if cast else out


def unit_backward_emulated(qkv, dout, heads, terms=2, cast=True):
    G, N = qkv.shape[:2]
    q, k, v, hd, mask = _split_units(qkv, heads)
    g = _units(dout.float(), N)[0].reshape(-1, 16, heads, hd)
    scale = hd ** -0.5
    a = _masked_probs(q, k, hd, mask)
    dp = torch.einsum("gnhd,gmhd->ghnm", g, v)
    ds = a * (dp - (dp * a).sum(-1, keepdim=True))
    dq = _times("ghnm,gmhd->gnhd", ds, k, terms) * scale
    dk = _times("ghnm,gnhd->gmhd", ds, q, terms) * scale
    dv = _times("ghnm,gnhd->gmhd", a, g, terms)
    out = torch.stack([dq, dk, dv], 2).reshape(dq.shape[0], 16, -1)
    out = _ununits(out, G, N)
    return out.to(qkv.dtype) if cast else out


def _tokens_inputs(G, N, C, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(G, N, 3 * C)).astype(
        np.float32)).bfloat16(),
        torch.from_numpy(rng.normal(size=(G, N, C)).astype(
            np.float32)).bfloat16())


@pytest.mark.parametrize("N", [1, 2, 4, 5, 7, 9, 16])
def test_emulated_unit_arithmetic_matches_the_plain_versions(N):
    # G = 23: the last unit part empty wherever 16 // N does not divide it
    C, heads = 96, 3
    qkv, dout = _tokens_inputs(23, N, C, N)
    ref = ga.grid_mhsa_reference(qkv.float(), heads)  # fp32, before the cast
    dref = ga.grid_mhsa_backward_reference(qkv.float(), dout.float(), heads)
    for name, emulate, want, args in (
            ("forward", unit_forward_emulated, ref, (qkv, heads)),
            ("backward", unit_backward_emulated, dref, (qkv, dout, heads))):
        exact = emulate(*args, cast=False)
        assert bool(torch.isfinite(exact).all()), name
        assert _rel(exact, want) <= 2.0 ** -14, (name, _rel(exact, want))
        got = emulate(*args)
        plain = want.to(torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                                   atol=5e-2, rtol=5e-2, err_msg=name)
        assert (got == plain).float().mean().item() >= 0.98, name


@pytest.mark.parametrize("C,heads", [(64, 2), (48, 2)])
def test_emulated_unit_arithmetic_is_th_at_16_tokens(C, heads):
    # at N = 16 a unit is one grid and nothing is masked: th's arithmetic
    qkv, dout = _inputs(9, C, C)
    assert torch.equal(unit_forward_emulated(qkv, heads),
                       th_forward_emulated(qkv, heads))
    assert torch.equal(unit_backward_emulated(qkv, dout, heads),
                       th_backward_emulated(qkv, dout, heads))


def test_padding_rows_take_no_probability():
    # N = 5: 3 grids a unit, row 15 a padding row; G = 4: the second unit
    # holds one grid, rows 5-15 padding. A padding row's probabilities are
    # exactly 0, and no row attends outside its grid.
    qkv, _ = _tokens_inputs(4, 5, 32, 0)
    q, k, _, hd, mask = _split_units(qkv, 1)
    a = _masked_probs(q, k, hd, mask)[:, 0]
    assert torch.equal(a[0, 15], torch.zeros(16))
    assert torch.equal(a[1, 5:], torch.zeros(11, 16))
    assert torch.equal(a[0, :5, 5:], torch.zeros(5, 11))
    sums = a.sum(-1)
    assert torch.allclose(sums[0, :15], torch.ones(15))
    assert torch.allclose(sums[1, :5], torch.ones(5))


@pytest.mark.parametrize("G,N,C,heads", [(8, 4, 64, 2), (5, 9, 48, 2)])
def test_emulated_unit_arithmetic_matches_pallas_t(G, N, C, heads):
    # as tests/test_grid_attention_pallas_t.py, forward and vjp in bf16
    qkv, dout = _tokens_inputs(G, N, C, G + N)
    got = unit_forward_emulated(qkv, heads)
    dqkv = unit_backward_emulated(qkv, dout, heads)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q: grid_mhsa_pallas_t(q, heads),
                            jnp.asarray(qkv.float().numpy(), jnp.bfloat16))
        (want_dqkv,) = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(dqkv.float().numpy(),
                               np.asarray(want_dqkv, np.float32),
                               atol=5e-2, rtol=5e-2)
