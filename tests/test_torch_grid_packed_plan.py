"""The block-packed grid core's bf16 CUDA kernel,
``csrc/grid_mhsa_packed_mma.cu`` (TPU kernel #6, ``grid_mhsa_pallas``),
checked on the CPU where it can be:

- Its launch plan (``ops/grid_attention.py:grid_mhsa_packed_plan``) at every
  shape #6 is given: the 48 px Model A-7M's stage 0 (from
  ``configs/cifar100_model_a_7m.yaml`` at 48 px) at batch 64 and 128, and
  the edge shapes ``tests/test_torch_cuda.py`` holds on the card, forward
  and backward: the staged rows cover the grid, a block's shared memory
  fits an H100 block, what one SM holds fits its shared memory, registers
  and threads, and the cache hands back the same plan; its refusals (hd not
  a multiple of 8, hd > 64, N = 0, N = 64).
- A PyTorch emulation of the kernel's arithmetic on its staged tiles (query
  rows padded to m16 tiles, keys to n8 tiles): q.k^T and dO.v^T are bf16
  products summed in fp32; the softmax divides; the forward casts P to bf16
  for one bf16 P.v; the backward keeps a in fp32, and ds.k, a^T.dO and
  ds^T.q take their fp32 left operand as two bf16 terms, hi = bf16(x) and
  lo = bf16(x - hi), dv and dk summed over the row tiles in order. At N =
  25, 36 and 49: the forward within 1 bf16 ulp of the plain version; the
  backward before its cast within 2^-14 of the largest value of the fp32
  plain backward, and one term at least 16x further off; both against JAX
  #6 in interpret mode within ``tests/test_torch_grid_packed.py``'s bf16
  tolerance (5e-2 abs + rel: one bf16 rounding of an O(1) value).
- The padding rules, on an emulated unit whose padded staging rows hold
  large finite garbage (1e4): key columns past N set to -inf before the row
  max, v and dO rows past N zero, a and ds rows past N set to 0. With all
  four the result is bitwise that of zero padding; without each one it is
  not (v and dO then with inf padding, as uninitialised shared memory may
  hold: 0 * inf is NaN).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.grid_attention_pallas import grid_mhsa_pallas
from outgridvit_tpu_torch.ops import grid_attention as ga

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for


def _a7m_48(batch):
    """(G, N, C, heads) of the 7M model's stage 0 at 48 px."""
    cfg = yaml.safe_load(
        (ROOT / "configs/cifar100_model_a_7m.yaml").read_text())
    s = cfg["model"]["stages"][0]
    g = s["grid_size"]
    return batch * g * g, (48 // g) ** 2, s["dim"], s["num_heads"]


SHAPES = [pytest.param(*_a7m_48(64), id="a7m_48-b64"),
          pytest.param(*_a7m_48(128), id="a7m_48-b128"),
          (4, 1, 8, 1), (7, 17, 40, 5), (3, 63, 64, 1), (5, 25, 448, 8)]


def test_the_7m_at_48px_gives_n36():
    assert _a7m_48(64) == (4096, 36, 48, 2)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("G,N,C,heads", SHAPES)
def test_packed_plan_at_every_shape(G, N, C, heads, backward):
    p = ga.grid_mhsa_packed_plan(G, N, C, heads, backward)
    hd = C // heads
    where = (G, N, C, heads, backward, p)
    # the staged rows: query rows to m16 tiles, keys to n8 tiles
    assert 0 <= 16 * p.row_tiles - N < 16 and 0 <= 8 * p.key_tiles - N < 8
    # rows an odd number of 16-byte units (ldmatrix without bank
    # conflicts), at most 16 bytes of padding
    assert (p.row_bytes // 16) % 2 == 1, where
    assert 0 <= p.row_bytes - 2 * hd <= 16, where
    assert 1 <= p.warps <= ga.PACKED_WARPS and p.smem_bytes <= BLOCK_SMEM
    # a warp's bf16 staging: q (and dO) rows, k and v rows; the backward's
    # dv and dk accumulators in fp32 on top
    tiles = (2 if backward else 1) * 16 * p.row_tiles + 16 * p.key_tiles
    acc = 2 * p.row_tiles * 16 * hd * 4 if backward else 0
    assert p.smem_bytes == p.warps * (tiles * p.row_bytes + acc), where
    # every (grid, head) unit once, the last block part empty at most
    units = G * heads
    assert (p.blocks - 1) * p.warps < units <= p.blocks * p.warps, where
    # what one SM holds: shared memory, registers, threads
    assert p.blocks_per_sm >= 1
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SMEM, where
    assert p.blocks_per_sm * p.warps * 32 * p.regs <= 65536, where
    assert p.units_per_sm == p.blocks_per_sm * p.warps
    assert p.waves == pytest.approx(units / (p.units_per_sm * 132))
    # cached: the wrapper asks at every launch
    assert ga.grid_mhsa_packed_plan(G, N, C, heads, backward) is p


def test_packed_plan_at_a7m_48():
    # forward: 4 units a block, 8 blocks an SM, under 2 waves at batch 64
    fwd = ga.grid_mhsa_packed_plan(*_a7m_48(64), False)
    assert (fwd.warps, fwd.units_per_sm, fwd.regs) == (4, 32, 64)
    assert fwd.waves < 2
    # backward: shared memory (staging and the accumulators) holds 3 blocks
    # an SM; the register cap is what that leaves, no less
    bwd = ga.grid_mhsa_packed_plan(*_a7m_48(128), True)
    assert (bwd.warps, bwd.units_per_sm, bwd.regs) == (4, 12, 168)


@pytest.mark.parametrize("N,C,heads", [(36, 36, 3), (36, 144, 2),
                                       (0, 48, 2), (64, 48, 2)])
def test_packed_plan_refuses_what_the_kernel_does_not_take(N, C, heads):
    for backward in (False, True):
        with pytest.raises(ValueError, match=f"N={N}, C={C}"):
            ga.grid_mhsa_packed_plan(4, N, C, heads, backward)


# ---- the kernel's arithmetic, emulated -------------------------------------

RULES = frozenset({"mask_keys", "zero_v", "zero_do", "zero_rows"})


def _times(eq, x, y, terms):
    """einsum(eq, x, y) with x as ``terms`` bf16 terms (1: x rounded to
    bf16, 2: hi + lo), summed in fp32."""
    hi = x.bfloat16().float()
    out = torch.einsum(eq, hi, y)
    return out if terms == 1 else out + torch.einsum(
        eq, (x - hi).bfloat16().float(), y)


def _staged(x, rows, fill):
    """x [G, heads, N, hd] as its staged tile of ``rows`` rows: rows past N
    hold ``fill``."""
    pad = torch.full((*x.shape[:2], rows - x.shape[2], x.shape[3]), fill)
    return torch.cat([x, pad], 2)


def _heads(t, G, N, heads):
    return t.float().reshape(G, N, heads, -1).transpose(1, 2)


def packed_emulated(qkv, heads, dout=None, terms=2, fills=None,
                    rules=RULES, cast=True):
    """The kernel's forward (``dout`` None) or backward on one unit per
    (grid, head), on staged tiles whose padded rows hold ``fills`` (by
    tile: q, k, v, do) unless a rule zeroes them."""
    G, N, C3 = qkv.shape
    q, k, v = (_heads(t, G, N, heads) for t in qkv.split(C3 // 3, -1))
    hd = q.shape[-1]
    scale = hd ** -0.5
    mt, kt8 = -(-N // 16), -(-N // 8)
    f = {"q": 0.0, "k": 0.0, "v": 0.0, "do": 0.0, **(fills or {})}
    if "zero_v" in rules:
        f["v"] = 0.0
    if "zero_do" in rules:
        f["do"] = 0.0
    qs, ks, vs = (_staged(q, 16 * mt, f["q"]), _staged(k, 8 * kt8, f["k"]),
                  _staged(v, 8 * kt8, f["v"]))
    s = torch.einsum("ghnd,ghmd->ghnm", qs, ks) * scale
    if "mask_keys" in rules:
        s[..., N:] = -torch.inf
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = e / e.sum(-1, keepdim=True)
    if dout is None:
        out = torch.einsum("ghnm,ghmd->ghnd", a.bfloat16().float(), vs)
        out = out[:, :, :N].transpose(1, 2).reshape(G, N, -1)
        return out.to(qkv.dtype) if cast else out
    g = _staged(_heads(dout, G, N, heads), 16 * mt, f["do"])
    dp = torch.einsum("ghnd,ghmd->ghnm", g, vs)
    ds = a * (dp - (dp * a).sum(-1, keepdim=True))
    if "zero_rows" in rules:
        live = (torch.arange(16 * mt) < N)[:, None]
        a, ds = torch.where(live, a, 0.0), torch.where(live, ds, 0.0)
    dq = _times("ghnm,ghmd->ghnd", ds, ks, terms) * scale
    dv = dk = 0.0
    for i in range(mt):  # the row tiles, in order
        r = slice(16 * i, 16 * i + 16)
        dv = dv + _times("ghnm,ghnd->ghmd", a[..., r, :], g[..., r, :], terms)
        dk = dk + _times("ghnm,ghnd->ghmd", ds[..., r, :], qs[..., r, :],
                         terms)
    out = torch.stack([dq[:, :, :N], dk[:, :, :N] * scale, dv[:, :, :N]], 2)
    out = out.permute(0, 3, 2, 1, 4).reshape(G, N, -1)
    return out.to(qkv.dtype) if cast else out


def _inputs(G, N, C, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(G, N, 3 * C)).astype(
        np.float32)).bfloat16(),
        torch.from_numpy(rng.normal(size=(G, N, C)).astype(
            np.float32)).bfloat16())


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (fp32)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x.float()), e - 8)


@pytest.mark.parametrize("N", [25, 36, 49])
def test_emulated_packed_arithmetic_matches_the_plain_versions(N):
    qkv, dout = _inputs(32, N, 48, N)
    heads = 2
    # forward: P cast to bf16 before one bf16 P.v: the plain version's
    # rounding points, summed in another order
    got = packed_emulated(qkv, heads).float()
    want = ga.grid_mhsa_packed_reference(qkv, heads).float()
    ulp = torch.maximum(_bf16_ulp(got), _bf16_ulp(want))
    assert bool(((got - want).abs() <= ulp).all())
    # backward: a and ds in fp32 as two bf16 terms
    ref = ga.grid_mhsa_packed_backward_reference(qkv.float(), dout.float(),
                                                 heads)
    split = _rel(packed_emulated(qkv, heads, dout, cast=False), ref)
    rounded = _rel(packed_emulated(qkv, heads, dout, terms=1, cast=False),
                   ref)
    assert split <= 2.0 ** -14, split
    assert split * 16 <= rounded, (split, rounded)


@pytest.mark.parametrize("N", [25, 36, 49])
def test_emulated_packed_arithmetic_matches_grid_mhsa_pallas(N):
    # as tests/test_torch_grid_packed.py:test_plain_core_matches_grid_mhsa_pallas
    qkv, dout = _inputs(2, N, 48, N + 1)
    got = packed_emulated(qkv, 2)
    dqkv = packed_emulated(qkv, 2, dout)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q: grid_mhsa_pallas(q, 2),
                            jnp.asarray(qkv.float().numpy(), jnp.bfloat16))
        (want_dqkv,) = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(dqkv.float().numpy(),
                               np.asarray(want_dqkv, np.float32),
                               atol=5e-2, rtol=5e-2)


GARBAGE = {"q": 1e4, "k": 1e4, "v": 1e4, "do": 1e4}


@pytest.mark.parametrize("dropped", [None, "mask_keys", "zero_v", "zero_do",
                                     "zero_rows"])
def test_padding_rules(dropped):
    qkv, dout = _inputs(4, 36, 48, 7)
    clean = (packed_emulated(qkv, 2), packed_emulated(qkv, 2, dout))

    def run(fills, rules):
        return (packed_emulated(qkv, 2, fills=fills, rules=rules),
                packed_emulated(qkv, 2, dout, fills=fills, rules=rules))

    if dropped is None:  # garbage in every padded row changes nothing
        got = run(GARBAGE, RULES)
        assert all(torch.equal(g, c) for g, c in zip(got, clean))
    elif dropped == "mask_keys":  # the garbage keys get probability
        fwd, _ = run(GARBAGE, RULES - {dropped})
        assert _rel(fwd.float(), clean[0].float()) > 0.1
    elif dropped in ("zero_v", "zero_do"):  # 0 * inf
        fwd, bwd = run(dict(GARBAGE, **{dropped[5:]: torch.inf}),
                       RULES - {dropped})
        assert not torch.isfinite((fwd if dropped == "zero_v" else bwd)
                                  .float()).all()
    else:  # covers for dO's padded rows, which hold garbage without zero_do
        kept = run(GARBAGE, RULES - {"zero_do"})
        got = run(GARBAGE, RULES - {"zero_do", dropped})
        assert torch.equal(kept[1], clean[1])
        assert _rel(got[1].float(), clean[1].float()) > 0.1
