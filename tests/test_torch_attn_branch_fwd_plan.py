"""The fused attention branch's bf16 tensor-core forward,
``csrc/attn_branch_mma.cu`` (TPU kernels #5 ``attn_branch_pallas`` and #12
``attn_branch_nhwc_pallas``, forward half), checked on the CPU where it can
be:

- Its launch plan (``ops/attn_branch.py:attn_branch_forward_plan``) at every
  shape of the shipped configs that runs the fused branch (N = 64; C = 64
  with heads of 32, C = 80 with heads of 40), at batch 128, 64 and 1, on
  tokens and on the NHWC map: its shared memory (counted here from the
  layout) fits an H100 block, two blocks fit an SM's shared memory,
  registers and threads, the blocks cover every grid exactly once in about
  one wave, and #5 and #12 split the grids alike. Its refusals (fp32, C not
  a multiple of 16, N other than 64, a head width it is not instantiated
  at) send the launch to the FMA kernel's entry without raising; the layout
  query refuses the same shapes. The phase cuts of ``ops/attn_ablation.py``
  still find their code in the kernel's source.
- A PyTorch emulation of the kernel's arithmetic: bf16 operands at the
  rounding points of the plain version; qkv, q.k^T, round(a).v and out.Wp
  summed in fp32 in k16 steps in ascending k (a k8 step for the tail of a
  head of 40); LN's statistics four lanes a row
  (``tests/test_torch_attn_branch_bwd_plan.py:_ln_rows``, the backward's
  recompute); the softmax's row sum in the kernel's order (a lane's 16
  values in column order, then the quad's xor tree) and its IEEE division;
  the bias added after the k steps. At G = 2-3 grids, C = 64 (2 heads of
  32) and C = 80 (2 heads of 40), with and without LN, against
  ``attn_branch_reference``: y within 1 bf16 ulp of the largest |y| of its
  row, as ``tests/test_torch_mlp_fwd_plan.py`` holds the MLP's (one qkv or
  out rounding that the other fp32 order flips moves y by a fraction of a
  term), and at least 95% of y bitwise equal (measured here: 99.7-100%).
  The exponential is torch's on both sides here; the card's ``expf`` may
  differ from it by an ulp, which ``chip_smoke.py`` reports as the share
  of y bitwise the plain version's. Against JAX ``attn_branch_pallas``
  (#5) and, through the partition, ``attn_branch_nhwc_pallas`` (#12) in
  interpret mode at the bf16 tolerance of ``tests/test_torch_attn_branch.py``
  (5e-2).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.attn_branch_pallas import attn_branch_pallas
from outgridvit_tpu.ops.experimental.attn_branch_nhwc_pallas import (
    attn_branch_nhwc_pallas,
)
from outgridvit_tpu_torch.ops import attn_branch as ab
from test_torch_attn_branch_bwd_plan import (
    BLOCK_SMEM,
    FUSED,
    SM_SMEM,
    _args,
    _bf,
    _inputs,
    _ln_rows,
    _mm,
    _mm_k,
    _ulp,
)

MMA = "ogvt_attn_branch_mma"
FMA = "ogvt_attn_branch"


# ---- the launch plan --------------------------------------------------------

def _fwd_bytes(C):
    """The forward's shared memory, counted from its layout: Wqkv [C, 3C]
    and Wp [C, C]; one x tile, the xn / out tile and the qkv / y tile of 64
    rows; rows padded to an odd number of 16-byte units."""
    def row(cols):
        return 16 * ((cols // 8) | 1)
    return C * row(3 * C) + C * row(C) + 2 * 64 * row(C) + 64 * row(3 * C)


def _check_plan(p, G, C):
    where = (G, C, p)
    assert p.smem == _fwd_bytes(C) and p.smem <= BLOCK_SMEM, where
    # two blocks an SM: shared memory, registers, threads
    assert p.blocks_per_sm == 2, where
    assert p.blocks_per_sm * (p.smem + 1024) <= SM_SMEM, where
    assert p.blocks_per_sm * 256 * p.regs <= 65536, where
    assert p.blocks_per_sm * 256 <= 2048, where
    # every grid in exactly one block, each a contiguous run; one wave
    assert (p.blocks - 1) * p.grids < G <= p.blocks * p.grids, where
    assert p.blocks <= 132 * p.blocks_per_sm, where
    seen = [w for b in range(p.blocks)
            for w in range(b * p.grids, min(G, (b + 1) * p.grids))]
    assert seen == list(range(G)), where


@pytest.mark.parametrize("batch", [128, 64, 1])
@pytest.mark.parametrize("shape", FUSED, ids=lambda s: s[0])
def test_forward_plan_at_every_fused_shape(shape, batch):
    name, per_image, N, C, heads, g, hw = shape
    G = batch * per_image
    p = ab.attn_branch_forward_plan(G, N, C, heads)
    _check_plan(p, G, C)
    assert ab.forward_entry(G, N, C, heads, torch.bfloat16) == MMA
    # cached: the wrapper asks at every launch
    assert ab.attn_branch_forward_plan(G, N, C, heads) is p
    # #12 on the map [batch, hw, hw, C] has the same windows, so the same
    # plan
    assert ab._windows(torch.empty(batch, hw, hw, C, device="meta"), heads,
                       g) == (G, N, C)


def test_forward_plan_at_tin_stage0():
    # Tiny-ImageNet stage 0 at serving batch 64: two blocks an SM (77 KB
    # each, 128 registers), 256 blocks of 16 grids
    p = ab.attn_branch_forward_plan(4096, 64, 64, 2)
    assert (p.blocks, p.grids, p.blocks_per_sm, p.regs) == (256, 16, 2, 128)
    assert p.smem == 78_848
    assert ab.attn_branch_forward_plan(1024, 64, 80, 2).smem == 108_032


def test_the_forward_layout_query_refuses_what_the_kernel_does_not_take():
    lib = ab.kernel_build.load_layouts()
    out = (ctypes.c_int * 3)()
    for C in (64, 80):
        assert lib.ogvt_attn_branch_mma_fwd_layout(64, C, 2, out) == 0
        assert tuple(out) == (256, _fwd_bytes(C), 128)
    for bad in ((72, 80, 2), (64, 64, 4), (64, 96, 2), (64, 80, 3),
                (64, 24, 2), (64, 48, 4)):
        assert lib.ogvt_attn_branch_mma_fwd_layout(*bad, out), bad


@pytest.mark.parametrize("G,N,C,heads,dtype,why", [
    (64, 64, 64, 2, torch.float32, "bf16 only"),       # the FMA kernel's
    (64, 64, 24, 2, torch.bfloat16, "built for grids"),  # C = 24
    (64, 64, 48, 4, torch.bfloat16, "C = 80 with heads of 40"),  # hd 12
    (64, 72, 48, 3, torch.bfloat16, "64 tokens"),       # N = 72
    (64, 64, 64, 4, torch.bfloat16, "C = 64 with heads of 32"),  # hd 16
    (0, 64, 64, 2, torch.bfloat16, "G >= 1")])
def test_forward_plan_refuses_what_the_kernel_does_not_take(G, N, C, heads,
                                                           dtype, why):
    with pytest.raises(ValueError, match=f"G={G}, N={N}, C={C}, "
                                         f"heads={heads}.*{why}"):
        ab.attn_branch_forward_plan(G, N, C, heads, dtype)
    assert ab.forward_entry(G, N, C, heads, dtype) == FMA


def test_the_ablation_cuts_match_the_kernel_source():
    # ops/attn_ablation.py switches phases off by editing the kernel's
    # source: each edit must still find its text, once
    from outgridvit_tpu_torch.ops import attn_ablation

    text = attn_ablation.SOURCE.read_text()
    for phase, edits in attn_ablation.CUTS.items():
        for old, _ in edits:
            assert text.count(old) == 1, phase


def test_the_entry_lists_name_both_kernels_of_each_layout():
    assert ab.FORWARD_ENTRIES == (MMA, FMA)
    assert ab.NHWC_FORWARD_ENTRIES == tuple(
        ab._nhwc_entry(e) for e in ab.FORWARD_ENTRIES)


# ---- the kernel's arithmetic, emulated --------------------------------------

def _softmax(s):
    """The kernel's softmax of the fp32 logits s [64, 64] (already scaled):
    the row max subtracted, exp, the row sum as the quad forms it (lane t
    holds columns 8j + 2t + e and sums them in order j, e; then the xor
    tree (t0 + t1) + (t2 + t3)), each value divided by it (IEEE)."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    cols = e.reshape(s.shape[0], 8, 4, 2)   # [row, j, t, e]
    lane = torch.zeros(s.shape[0], 4)
    for j in range(8):
        for k in range(2):
            lane = lane + cols[:, j, :, k]
    den = (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])
    return e / den[:, None]


def emulate(x, ls, lb, wqkv, bqkv, wp, bp, heads, eps, apply_ln):
    """y of ``ogvt_attn_branch_mma``, emulated in fp32 (bf16 values as
    fp32), x [G, 64, C] bf16 -> y [G, 64, C] bf16."""
    G, N, C = x.shape
    hd = C // heads
    step = 16 if hd % 16 == 0 else 8   # the k8 tail of a head of 40
    scale = ctypes.c_float(hd ** -0.5).value
    w, bq = wqkv.float(), bqkv.float()
    wpf, bpf = wp.float(), bp.float()
    y = torch.zeros(G, N, C)
    for gi in range(G):
        xg = x[gi].float()
        xn = _ln_rows(xg, ls, lb, eps)[0] if apply_ln else xg
        qkv = _bf(_mm(xn, w) + bq)
        out = torch.zeros(N, C)
        for h in range(heads):
            c = slice(h * hd, (h + 1) * hd)
            q, k = qkv[:, c], qkv[:, C + h * hd:C + (h + 1) * hd]
            v = qkv[:, 2 * C + h * hd:2 * C + (h + 1) * hd]
            a = _softmax(_mm_k(q, k.t(), hd, step) * scale)
            out[:, c] = _bf(_mm(_bf(a), v))
        y[gi] = _bf(_mm(out, wpf) + bpf)
    return y.to(torch.bfloat16)


def _run(inp, apply_ln):
    return emulate(inp["x"], inp["ls"], inp["lb"], inp["wqkv"], inp["bqkv"],
                   inp["wp"], inp["bp"], 2, 1e-5, apply_ln)


@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("G,C", [(2, 64), (3, 80)])
def test_emulated_mma_forward_matches_the_plain_version(G, C, apply_ln):
    inp = _inputs(G, C, 7 * G + C)
    got = _run(inp, apply_ln)
    want = ab.attn_branch_reference(*_args(inp), 2, 1e-5, apply_ln)
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    # one bf16 ulp of the row's largest |y|
    ulp = _ulp(torch.maximum(g.abs(), w.abs()).amax(-1, keepdim=True))
    assert bool(((g - w).abs() <= ulp).all()), \
        f"{((g - w).abs() / ulp).max().item()} ulp"
    share = (got == want).float().mean().item()
    assert share >= 0.95, share


def _jax(t, dt=jnp.bfloat16):
    return jnp.asarray(t.float().numpy(), dt)


def _jax_args(inp):
    return [_jax(inp["x"]), _jax(inp["ls"], jnp.float32),
            _jax(inp["lb"], jnp.float32), _jax(inp["wqkv"]),
            _jax(inp["bqkv"]), _jax(inp["wp"]), _jax(inp["bp"])]


@pytest.mark.parametrize("G,C,apply_ln", [(2, 64, True), (2, 80, False)])
def test_emulated_mma_forward_matches_attn_branch_pallas(G, C, apply_ln):
    # tests/test_torch_attn_branch.py's bf16 tolerance for #5 (5e-2)
    inp = _inputs(G, C, 5 * G + C)
    got = _run(inp, apply_ln)
    with pltpu.force_tpu_interpret_mode():
        want = attn_branch_pallas(*_jax_args(inp), 2, 1e-5, apply_ln)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("C", [64, 80])
def test_emulated_nhwc_forward_matches_attn_branch_nhwc_pallas(C):
    # #12 on a map [1, 16, 16, C] with grid size 2: 4 windows of 64
    # tokens, partitioned in the port's order, through the emulated kernel
    # (the windows' addresses change, not their arithmetic), then back:
    # against the plain #12 (1 ulp of the row's largest |y|) and JAX #12
    inp = _inputs(4, C, 11 + C)
    xm = inp["x"].reshape(1, 16, 16, C)
    tokens, meta = ab._tokens(xm, 2)
    got = ab._untokens(emulate(tokens, inp["ls"], inp["lb"], inp["wqkv"],
                               inp["bqkv"], inp["wp"], inp["bp"], 2, 1e-5,
                               True), meta)
    plain = ab.attn_branch_nhwc_reference(xm, *_args(inp)[1:], 2, 2).float()
    ulp = _ulp(torch.maximum(got.float().abs(), plain.abs()).amax(
        -1, keepdim=True))
    assert bool(((got.float() - plain).abs() <= ulp).all())
    args = _jax_args(dict(inp, x=xm))
    with pltpu.force_tpu_interpret_mode():
        want = attn_branch_nhwc_pallas(*args, 2, 2, 1e-5, True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
