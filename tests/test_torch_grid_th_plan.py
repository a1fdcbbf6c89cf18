"""The head-chunked grid core's CUDA kernel, ``csrc/grid_mhsa_th.cu`` (TPU
kernel #3, ``grid_mhsa_pallas_th``), checked on the CPU where it can be:

- Its launch plan (``ops/grid_attention.py:grid_mhsa_th_plan``) at every
  "th" shape of every shipped config (``configs/*.yaml`` with a ``model:``
  section: the grids of N = 16 tokens and C >= 128 that ``models/blocks.py``
  sends to the head-chunked core), forward and backward, at train batch 128:
  a block's shared memory fits an H100 block, a grid's staging is half of
  ``csrc/grid_mhsa.cu``'s but for the row padding, at least 3 grids' worth
  of (grid, head) units are in flight on an SM, and the cache hands back the
  same plan.
- A PyTorch emulation of the kernel's arithmetic: q.k^T and dO.v^T are bf16
  products summed in fp32; a.v, ds.k, ds^T.q and a^T.dO take their fp32
  left operand as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), summed
  in fp32. Held against the plain versions (``grid_mhsa_reference`` /
  ``grid_mhsa_backward_reference``) and against the JAX
  ``grid_mhsa_pallas_th`` in interpret mode, at hd 32 and 56, within
  ``tests/test_torch_64px.py``'s bf16 tolerance (5e-2); before the cast
  within 2^-14 of the largest fp32 value, far closer than with the
  probabilities rounded to bf16 (#6's rounding point).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.grid_attention_pallas_t import grid_mhsa_pallas_th
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops.attn_branch import MIN_TOKENS

CONFIGS = sorted(p for p in (Path(__file__).resolve().parents[1]
                             / "configs").glob("*.yaml")
                 if "model" in yaml.safe_load(p.read_text()))
BATCH = 128
SMS_SMEM = 228 * 1024      # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for


def _th_shapes():
    """(G, N, C, heads) of every grid-core launch tagged "th" at batch 128,
    from the configs' ``model:`` and ``data.img_size``, with the config and
    stage as the id."""
    out = []
    for path in CONFIGS:
        cfg = yaml.safe_load(path.read_text())
        img = cfg["data"]["img_size"]
        for si, s in enumerate(cfg["model"]["stages"]):
            g, C = s["grid_size"], s["dim"]
            N = ((img >> si) // g) ** 2
            if (N < MIN_TOKENS and N <= ga.MAX_TOKENS
                    and ga.grid_mhsa_variant(N, C) == "th"):
                out.append(pytest.param(
                    BATCH * g * g, N, C, s["num_heads"],
                    id=f"{path.stem}-stage{si}"))
    return out


def test_the_configs_give_the_th_shapes():
    shapes = {p.values[2:] for p in _th_shapes()}
    # Tiny-ImageNet's and the default Model A's stages 1-3: six (C, heads)
    assert len(shapes) >= 6, shapes
    assert {C // heads for C, heads in shapes} >= {32, 56, 64}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("G,N,C,heads", _th_shapes())
def test_th_plan_at_every_shipped_shape(G, N, C, heads, backward):
    p = ga.grid_mhsa_th_plan(G, N, C, heads, backward)
    hd = C // heads
    where = (G, N, C, heads, backward, p)
    # what csrc/grid_mhsa_th.cu takes: four warps, 3 or 4 tiles a warp,
    # rows an odd number of 16-byte units (ldmatrix without bank conflicts)
    assert p.warps == 4 and p.tiles == (4 if backward else 3)
    assert p.row_bytes >= 2 * hd and (p.row_bytes // 16) % 2 == 1, where
    assert p.smem_bytes == p.warps * p.tiles * N * p.row_bytes, where
    assert p.smem_bytes <= BLOCK_SMEM, where
    # every (grid, head) unit once, the last block part empty at most
    assert (p.blocks - 1) * p.warps < G * heads <= p.blocks * p.warps, where
    # a grid's bf16 staging: half the fp32 one of csrc/grid_mhsa.cu (which
    # also stages the probabilities) but for at most 16 bytes of row padding
    fp32 = 4 * (N * (4 if backward else 3) * C
                + (2 if backward else 1) * heads * N * N)
    assert heads * p.tiles * N * 2 * hd <= fp32 / 2, where
    assert p.row_bytes - 2 * hd <= 16, where
    # what one SM holds: shared memory, registers, threads
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SMS_SMEM, where
    assert p.blocks_per_sm * p.warps * 32 * p.regs <= 65536, where
    assert p.grids_in_flight == p.blocks_per_sm * p.warps / heads
    assert p.grids_in_flight >= 3, where
    # cached: the wrapper asks at every launch
    assert ga.grid_mhsa_th_plan(G, N, C, heads, backward) is p


@pytest.mark.parametrize("N,C,heads", [(9, 384, 4), (16, 100, 5),
                                       (16, 144, 2), (16, 128, 3)])
def test_th_plan_refuses_what_the_kernel_does_not_take(N, C, heads):
    with pytest.raises(ValueError, match=f"N={N}, C={C}"):
        ga.grid_mhsa_th_plan(4, N, C, heads, False)


# ---- the kernel's arithmetic, emulated -------------------------------------

def _split(x):
    """x as hi + lo, two bf16 terms (as fp32 values)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _times(eq, x, y, terms):
    """einsum(eq, x, y) with x as ``terms`` bf16 terms (1: x rounded to
    bf16, 2: the split), summed in fp32."""
    if terms == 1:
        return torch.einsum(eq, x.bfloat16().float(), y)
    hi, lo = _split(x)
    return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)


def _qkv(qkv, heads):
    G, N, C3 = qkv.shape
    hd = C3 // 3 // heads
    return (*qkv.float().reshape(G, N, 3, heads, hd).unbind(2), hd)


def th_forward_emulated(qkv, heads, terms=2, cast=True):
    q, k, v, hd = _qkv(qkv, heads)
    a = ga._probs(q, k, hd)  # fp32 logits of bf16 products, 1/sum softmax
    out = _times("ghnm,gmhd->gnhd", a, v, terms)
    G, N = qkv.shape[:2]
    out = out.reshape(G, N, -1)
    return out.to(qkv.dtype) if cast else out


def th_backward_emulated(qkv, dout, heads, terms=2, cast=True):
    q, k, v, hd = _qkv(qkv, heads)
    G, N = qkv.shape[:2]
    g = dout.float().reshape(G, N, heads, hd)
    scale = hd ** -0.5
    a = ga._probs(q, k, hd)
    dp = torch.einsum("gnhd,gmhd->ghnm", g, v)
    ds = a * (dp - (dp * a).sum(-1, keepdim=True))
    dq = _times("ghnm,gmhd->gnhd", ds, k, terms) * scale
    dk = _times("ghnm,gnhd->gmhd", ds, q, terms) * scale
    dv = _times("ghnm,gnhd->gmhd", a, g, terms)
    out = torch.stack([dq, dk, dv], 2).reshape(G, N, -1)
    return out.to(qkv.dtype) if cast else out


def _inputs(G, C, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(G, 16, 3 * C)).astype(
        np.float32)).bfloat16(),
        torch.from_numpy(rng.normal(size=(G, 16, C)).astype(
            np.float32)).bfloat16())


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("C,heads", [(160, 5), (448, 8)])  # hd 32, 56
def test_emulated_th_arithmetic_matches_the_plain_versions(C, heads):
    qkv, dout = _inputs(64, C, C)
    ref = ga.grid_mhsa_reference(qkv.float(), heads)  # fp32, before the cast
    dref = ga.grid_mhsa_backward_reference(qkv.float(), dout.float(), heads)
    for name, emulate, want, args in (
            ("forward", th_forward_emulated, ref, (qkv, heads)),
            ("backward", th_backward_emulated, dref, (qkv, dout, heads))):
        split = _rel(emulate(*args, cast=False), want)
        rounded = _rel(emulate(*args, terms=1, cast=False), want)
        assert split <= 2.0 ** -14, (name, split)
        assert split * 16 <= rounded, (name, split, rounded)
        got = emulate(*args)
        plain = want.to(torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                                   atol=5e-2, rtol=5e-2, err_msg=name)
        # a flipped final rounding now and then, nothing more
        assert (got == plain).float().mean().item() >= 0.98, name


@pytest.mark.parametrize("C,heads", [(160, 5), (448, 8)])  # hd 32, 56
def test_emulated_th_arithmetic_matches_pallas_th(C, heads):
    # as tests/test_torch_64px.py:test_grid_mhsa_plain_matches_pallas_th
    qkv, dout = _inputs(2, C, C + 1)
    got = th_forward_emulated(qkv, heads)
    dqkv = th_backward_emulated(qkv, dout, heads)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda q: grid_mhsa_pallas_th(q, heads),
                            jnp.asarray(qkv.float().numpy(), jnp.bfloat16))
        (want_dqkv,) = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(dqkv.float().numpy(),
                               np.asarray(want_dqkv, np.float32),
                               atol=5e-2, rtol=5e-2)
