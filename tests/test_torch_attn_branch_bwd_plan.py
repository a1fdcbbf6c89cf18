"""The fused attention branch's bf16 tensor-core backward,
``csrc/attn_branch_bwd_mma.cu`` (TPU kernels #5 ``attn_branch_pallas`` and
#12 ``attn_branch_nhwc_pallas``, backward half), checked on the CPU where it
can be:

- Its launch plan (``ops/attn_branch.py:attn_branch_backward_plan``) at every
  shape of the shipped configs that runs the fused branch (N = 64; C = 64
  with heads of 32, C = 80 with heads of 40), at batch 128, 64 and 1, on
  tokens and on the NHWC map: each kernel's shared memory fits an H100
  block (and is counted here from the layout), what one SM holds fits its
  shared memory, registers and threads, the blocks cover every grid exactly
  once, and #5 and #12 split the grids alike (the plan depends on G alone).
  Its refusals (fp32, C not a multiple of 16, a head width of 12, N other
  than 64, a head width it is not instantiated at) send the launch to the
  FMA kernel's entry without raising.
- A PyTorch emulation of the kernels' arithmetic: bf16 operands at the
  rounding points of the plain version; every product summed in fp32 in
  k16 steps in the kernels' order (a k8 step for the tail of a head of
  40); LN's statistics four lanes a row; the softmax in fp32 with the IEEE
  division; the fp32 a and ds of dv, dq and dk as two bf16 terms (hi =
  bf16(x), lo = bf16(x - hi), hi first in each step); dbqkv, dbp and the
  LN backward's sums in the kernels' shuffle trees and orders (dbp a row
  tile at a time); each block's grids in order, then the blocks'
  partials in order. At G = 2-4 grids, C = 64 (2 heads of 32) and C = 80
  (2 heads of 40), with and without LN, with the plan's one grid a block
  and with runs of two grids, against ``attn_branch_backward_reference``:
  dx and the bf16 parameter grads within 1 bf16 ulp of the largest value of
  their row (dbqkv, dbproj: of the vector), as
  ``tests/test_torch_mlp_bwd_plan.py`` holds the MLP's (measured: exactly 1
  ulp for dx and dwqkv, 0.5 for dwproj); dln_scale and dln_bias within
  2^-13 of each channel's sum of the magnitudes of its terms, twice the
  MLP test's 2^-14: measured up to 1.03 * 2^-14 (dln_scale, G = 3, C = 80).
  Where the other order of the fp32 sums, or the split's 2^-17 residue,
  flips the bf16 rounding of one dqkv value, dxn moves by a fraction of one
  term, and dln_scale sums dxn * xhat over every token. Against JAX
  ``attn_branch_pallas``'s vjp in interpret mode at the bf16 tolerance of
  ``tests/test_torch_attn_branch.py`` (5e-2; the parameter grads relative
  to their largest value).
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

from outgridvit_tpu.ops.attn_branch_pallas import attn_branch_pallas
from outgridvit_tpu_torch.ops import attn_branch as ab

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
GRADS = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj",
         "dbproj")
MMA = "ogvt_attn_branch_bwd_mma"
FMA = "ogvt_attn_branch_bwd"


# ---- the launch plan --------------------------------------------------------

CONFIGS = ("cifar100_model_a_7m", "tinyimagenet200_model_a",
           "cifar100_model_b", "cifar100_model_a", "cifar100_model_a_14m",
           "svhn_model_a", "cifar100_64_model_a")


def _fused_shapes():
    """(config, B-free shape (grids an image, N, C, heads, g, map side)) of
    every stage of the shipped configs whose grids take the fused branch:
    N >= 64 tokens that ``attn_branch_fits`` holds (as
    ``chip_smoke.py:stage_shapes`` routes them)."""
    out = set()
    for name in CONFIGS:
        cfg = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
        img = cfg["data"]["img_size"]
        for si, s in enumerate(cfg["model"]["stages"]):
            hw, g = img >> si, s["grid_size"]
            N, C, heads = (hw // g) ** 2, s["dim"], s["num_heads"]
            if N >= ab.MIN_TOKENS and ab.attn_branch_fits(N, C, heads):
                out.add((name, g * g, N, C, heads, g, hw))
    return sorted(out)


FUSED = _fused_shapes()


def test_the_fused_shapes_are_the_instantiated_ones():
    assert {(N, C, heads) for _, _, N, C, heads, _, _ in FUSED} == \
        {(64, 64, 2), (64, 80, 2)}
    names = {name for name, *_ in FUSED}
    assert {"tinyimagenet200_model_a", "cifar100_64_model_a",
            "cifar100_model_a"} <= names


def _tokens_bytes(C):
    """The tokens kernel's shared memory, counted from its layout: Wqkv
    [C, 3C] and Wp [C, C]; two x and two dy tiles, the xn / out tile and
    the qkv / dqkv tile of 64 rows; two head slots of four [64, 64] bf16
    tiles (a and ds, hi and lo); mu and rstd; the block's 6C running sums,
    dbqkv's [4][3C] row-tile sums, the LN backward's [2][4][C] column sums
    and [2][64][2] row sums; rows padded to an odd number of 16-byte
    units."""
    def row(cols):
        return 16 * ((cols // 8) | 1)
    return (C * row(3 * C) + C * row(C) + 5 * 64 * row(C) + 64 * row(3 * C)
            + 8 * 64 * row(64) + 4 * (2 * 64 + 6 * C + 12 * C + 8 * C
                                      + 4 * 64))


def _weights_bytes(C):
    """The weights kernel's: two buffers, each a grid's x, dy, dqkv and
    out."""
    def row(cols):
        return 16 * ((cols // 8) | 1)
    return 2 * 64 * (3 * row(C) + row(3 * C))


def _check_plan(p, G, C):
    where = (G, C, p)
    assert p.t_smem == _tokens_bytes(C) and p.t_smem <= BLOCK_SMEM, where
    assert p.w_smem == _weights_bytes(C), where
    assert p.w_smem <= BLOCK_SMEM, where
    # what one SM holds: shared memory, registers, threads
    for per_sm, smem, regs in ((p.t_blocks_per_sm, p.t_smem, p.t_regs),
                               (p.w_blocks_per_sm, p.w_smem, p.w_regs)):
        assert per_sm >= 1, where
        assert per_sm * (smem + 1024) <= SM_SMEM, where
        assert per_sm * 256 * regs <= 65536, where
        assert per_sm * 256 <= 2048, where
    # every grid in exactly one block, each a contiguous run; about one wave
    for blocks, per, slots in ((p.t_blocks, p.t_grids, p.t_blocks_per_sm),
                               (p.w_splits, p.w_grids, p.w_blocks_per_sm)):
        assert (blocks - 1) * per < G <= blocks * per, where
        assert blocks <= 132 * slots, where
        if G <= 4096:
            seen = [w for b in range(blocks)
                    for w in range(b * per, min(G, (b + 1) * per))]
            assert seen == list(range(G)), where


@pytest.mark.parametrize("batch", [128, 64, 1])
@pytest.mark.parametrize("shape", FUSED, ids=lambda s: s[0])
def test_mma_plan_at_every_fused_shape(shape, batch):
    name, per_image, N, C, heads, g, hw = shape
    G = batch * per_image
    p = ab.attn_branch_backward_plan(G, N, C, heads)
    _check_plan(p, G, C)
    assert ab.backward_entry(G, N, C, heads, torch.bfloat16) == MMA
    # cached: the wrapper asks at every launch
    assert ab.attn_branch_backward_plan(G, N, C, heads) is p
    # #12 on the map [batch, hw, hw, C] has the same windows, so the same
    # plan: the blocks take the same grids on both layouts
    assert ab._windows(torch.empty(batch, hw, hw, C, device="meta"), heads,
                       g) == (G, N, C)


def test_mma_plan_at_tin_stage0():
    # Tiny-ImageNet stage 0 at train batch 128: one block an SM (the
    # tokens kernel's 184 KB), one wave of 131 blocks of 63 grids (the last
    # 2), in both kernels
    p = ab.attn_branch_backward_plan(8192, 64, 64, 2)
    assert (p.t_blocks, p.t_grids, p.t_blocks_per_sm) == (131, 63, 1)
    assert (p.w_splits, p.w_grids) == (131, 63)
    assert p.t_smem == 188_416 and p.w_smem == 106_496


def test_the_layout_queries_refuse_what_the_kernels_do_not_take():
    lib = ab.kernel_build.load_layouts()
    out = (ctypes.c_int * 3)()
    assert lib.ogvt_attn_branch_bwd_mma_tokens_layout(64, 80, 2, out) == 0
    assert tuple(out) == (256, _tokens_bytes(80), 255)
    for bad in ((72, 80, 2), (64, 64, 4), (64, 96, 2), (64, 80, 3)):
        assert lib.ogvt_attn_branch_bwd_mma_tokens_layout(*bad, out), bad
    assert lib.ogvt_attn_branch_bwd_mma_weights_layout(64, 64, 2, out) == 0
    assert tuple(out) == (256, _weights_bytes(64), 255)
    for bad in ((72, 80, 2), (64, 64, 4), (64, 96, 2), (64, 80, 3)):
        assert lib.ogvt_attn_branch_bwd_mma_weights_layout(*bad, out), bad


@pytest.mark.parametrize("G,N,C,heads,dtype,why", [
    (64, 64, 64, 2, torch.float32, "bf16 only"),       # the FMA kernel's
    (64, 64, 24, 2, torch.bfloat16, "built for grids"),  # C = 24
    (64, 64, 48, 4, torch.bfloat16, "C = 80 with heads of 40"),  # hd 12
    (64, 72, 48, 3, torch.bfloat16, "64 tokens"),       # N = 72
    (64, 64, 64, 4, torch.bfloat16, "C = 64 with heads of 32")])  # hd 16
def test_mma_plan_refuses_what_the_kernel_does_not_take(G, N, C, heads,
                                                        dtype, why):
    with pytest.raises(ValueError, match=f"G={G}, N={N}, C={C}, "
                                         f"heads={heads}.*{why}"):
        ab.attn_branch_backward_plan(G, N, C, heads, dtype)
    assert ab.backward_entry(G, N, C, heads, dtype) == FMA


# ---- the kernels' arithmetic, emulated --------------------------------------

def _bf(t):
    """Round to bf16 (nearest even) and back to fp32: a rounding point."""
    return t.to(torch.bfloat16).float()


def _mm(a, b, step=16):
    """a [m, K] @ b [K, n], bf16 values summed in fp32 in k steps of 16
    (one mma.sync m16n8k16 each, into one accumulator), the last of 8 where
    K is an odd multiple of 8 (m16n8k8)."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], step):
        out = out + a[:, k:k + step] @ b[k:k + step]
    return out


def _split(t):
    """The two bf16 terms of fp32 values: hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def _mm_split(a, b):
    """a [m, K] @ b [K, n] with a fp32 taken as hi + lo bf16 terms: per k16
    step the hi term's product, then the lo term's, into one accumulator."""
    hi, lo = _split(a)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        out = out + hi[:, k:k + 16] @ b[k:k + 16]
        out = out + lo[:, k:k + 16] @ b[k:k + 16]
    return out


def _fma(a, b, c):
    """fmaf(a, b, c): one rounding of the exact a * b + c."""
    return (a.double() * b.double() + c.double()).float()


def _tree16(v):
    """Sum of the 16 rows of v [16, ...] in the kernels' shuffle order: rows
    g and g + 8 in a lane, then xor 4, 8, 16 over g."""
    s = v[:8] + v[8:]
    s = s[0::2] + s[1::2]
    s = s[0::2] + s[1::2]
    return s[0] + s[1]


def _tree16_pairs(d, xhat):
    """The dxn * xhat column sums of one warp: each lane's two rows as
    fmaf(dxn[g + 8], xhat[g + 8], dxn[g] * xhat[g]), then the xor tree."""
    s = _fma(d[8:], xhat[8:], d[:8] * xhat[:8])
    s = s[0::2] + s[1::2]
    s = s[0::2] + s[1::2]
    return s[0] + s[1]


def _in_order(parts):
    """((p0 + p1) + p2) + p3 ...: the row tiles' sums in order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _ln_rows(x, ls, lb, eps):
    """ln_rows from the staged bf16 x [64, C]: four lanes a row, lane q
    sums its 8-column units q, q + 4, ... in column order, the quad's xor
    tree sums the lanes ((q0 + q1) + (q2 + q3)); returns (round(LN(x)), mu,
    rstd)."""
    R, C = x.shape
    s = torch.zeros(R, 4)
    ss = torch.zeros(R, 4)
    for q in range(4):
        for u in range(q, C // 8, 4):
            for c in range(8 * u, 8 * u + 8):
                s[:, q] = s[:, q] + x[:, c]
                ss[:, q] = _fma(x[:, c], x[:, c], ss[:, q])
    s = (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])
    ss = (ss[:, 0] + ss[:, 1]) + (ss[:, 2] + ss[:, 3])
    mu = s[:, None] / C
    rstd = torch.rsqrt(torch.clamp(ss[:, None] / C - mu * mu, min=0.0) + eps)
    return _bf((x - mu) * (rstd * ls) + lb), mu, rstd


def _grid(xn, x, mu, rstd, dy, w, bq, wp, ls, heads, scale, apply_ln):
    """One grid of 64 tokens through the tokens kernel: (dx, round(dqkv),
    out, dbqkv, dbp, dls, dlb) of the grid, its sums as the kernel forms
    them."""
    C = x.shape[1]
    hd = C // heads
    step = 16 if hd % 16 == 0 else 8   # the k8 tail of a head of 40
    qkv = _bf(_mm(xn, w) + bq)
    dout = _bf(_mm(dy, wp.t()))
    dqkv = torch.zeros(64, 3 * C)
    out = torch.zeros(64, C)
    for h in range(heads):
        c = slice(h * hd, (h + 1) * hd)
        q, k = qkv[:, c], qkv[:, C + h * hd:C + (h + 1) * hd]
        v = qkv[:, 2 * C + h * hd:2 * C + (h + 1) * hd]
        g = dout[:, c]
        s = _mm_k(q, k.t(), hd, step) * scale
        e = torch.exp(s - s.amax(-1, keepdim=True))
        a = e / e.sum(-1, keepdim=True)
        out[:, c] = _bf(_mm(_bf(a), v))
        dp = _mm_k(g, v.t(), hd, step)
        ds = a * (dp - (dp * a).sum(-1, keepdim=True))
        dqkv[:, c] = _mm_split(ds, k) * scale
        dqkv[:, C + h * hd:C + (h + 1) * hd] = _mm_split(ds.t(), q) * scale
        dqkv[:, 2 * C + h * hd:2 * C + (h + 1) * hd] = _mm_split(a.t(), g)
    dbqkv = _in_order([_tree16(dqkv[16 * r:16 * r + 16]) for r in range(4)])
    parts = []
    for rt in range(4):   # a thread's column pair over a row tile in order
        acc = torch.zeros(C)
        for r in range(16 * rt, 16 * rt + 16):
            acc = acc + dy[r]
        parts.append(acc)
    dbp = _in_order(parts)
    dqkvb = _bf(dqkv)
    dxn = _mm(dqkvb, w.t())
    if not apply_ln:
        z = torch.zeros(C)
        return _bf(dxn), dqkvb, out, dbqkv, dbp, z, z
    xhat = (x - mu) * rstd
    dls = _in_order([_tree16_pairs(dxn[16 * r:16 * r + 16],
                                   xhat[16 * r:16 * r + 16])
                     for r in range(4)])
    dlb = _in_order([_tree16(dxn[16 * r:16 * r + 16]) for r in range(4)])
    # row sums: a lane's column pairs in order, the quad's xor tree, the
    # two column halves in order
    dxhat = dxn * ls
    q = dxhat.reshape(64, 2, C // 16, 4, 2)
    xq = xhat.reshape(64, 2, C // 16, 4, 2)
    s1 = torch.zeros(64, 2, 4)
    s2 = torch.zeros(64, 2, 4)
    for n in range(C // 16):
        s1 = s1 + (q[:, :, n, :, 0] + q[:, :, n, :, 1])
        s2 = _fma(q[:, :, n, :, 1], xq[:, :, n, :, 1],
                  _fma(q[:, :, n, :, 0], xq[:, :, n, :, 0], s2))
    s1 = (s1[..., 0] + s1[..., 1]) + (s1[..., 2] + s1[..., 3])
    s2 = (s2[..., 0] + s2[..., 1]) + (s2[..., 2] + s2[..., 3])
    m1 = (s1[:, :1] + s1[:, 1:]) / C
    m2 = (s2[:, :1] + s2[:, 1:]) / C
    dx = rstd * (dxhat - m1 - xhat * m2)
    return _bf(dx), dqkvb, out, dbqkv, dbp, dls, dlb


def _mm_k(a, b, K, step):
    """a [m, K] @ b [K, n] in k16 steps, the last of 8 where K % 16 == 8."""
    out = torch.zeros(a.shape[0], b.shape[1])
    k = 0
    while k < K:
        st = 16 if k + 16 <= K else 8
        out = out + a[:, k:k + st] @ b[k:k + st]
        k += st
    return out


def _runs(parts, blocks, per):
    """Each block's run of grids summed in order, then the blocks in
    order."""
    total = torch.zeros(parts.shape[1:])
    for b in range(blocks):
        acc = torch.zeros(parts.shape[1:])
        for w in range(b * per, min(parts.shape[0], (b + 1) * per)):
            acc = acc + parts[w]
        total = total + acc
    return total


def emulate(x, ls, lb, wqkv, bqkv, wp, dy, heads, eps, apply_ln, plan):
    """The grads ``(dx, dln_scale, dln_bias, dwqkv, dbqkv, dwproj,
    dbproj)`` of ``ogvt_attn_branch_bwd_mma`` under ``plan``, emulated in
    fp32 (bf16 values as fp32), x and dy [G, 64, C]."""
    G, N, C = x.shape
    scale = ctypes.c_float((C // heads) ** -0.5).value
    x, dy = x.float(), dy.float()
    w, bq, wp = wqkv.float(), bqkv.float(), wp.float()
    dx = torch.zeros(G, N, C)
    dqkvb = torch.zeros(G, N, 3 * C)
    outs = torch.zeros(G, N, C)
    xns = torch.zeros(G, N, C)
    sums = [torch.zeros(G, n) for n in (3 * C, C, C, C)]
    for gi in range(G):
        if apply_ln:
            xn, mu, rstd = _ln_rows(x[gi], ls, lb, eps)
        else:
            xn, mu, rstd = x[gi], None, None
        xns[gi] = xn
        dx[gi], dqkvb[gi], outs[gi], *s = _grid(
            xn, x[gi], mu, rstd, dy[gi], w, bq, wp, ls, heads, scale,
            apply_ln)
        for acc, v in zip(sums, s):
            acc[gi] = v
    dbqkv, dbp, dls, dlb = (_runs(t, plan.t_blocks, plan.t_grids)
                            for t in sums)
    # the weights kernel: per block its grids in order, 16-token steps
    dw = torch.zeros(C, 3 * C)
    dwp = torch.zeros(C, C)
    for b in range(plan.w_splits):
        a1 = torch.zeros(C, 3 * C)
        a2 = torch.zeros(C, C)
        for gi in range(b * plan.w_grids, min(G, (b + 1) * plan.w_grids)):
            for k in range(0, N, 16):
                r = slice(k, k + 16)
                a1 = a1 + xns[gi, r].t() @ dqkvb[gi, r]
                a2 = a2 + outs[gi, r].t() @ dy[gi, r]
        dw, dwp = dw + a1, dwp + a2
    bf = torch.bfloat16
    return (dx.to(bf), dls, dlb, dw.to(bf), dbqkv.to(bf), dwp.to(bf),
            dbp.to(bf))


def _inputs(G, C, seed):
    """bf16 x, wqkv, bqkv, wp, bp, dy and fp32 ln_scale, ln_bias (torch),
    as the card tests draw them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bf = torch.bfloat16
    return dict(x=n(G, 64, C).to(bf), ls=1 + 0.1 * n(C), lb=0.1 * n(C),
                wqkv=(n(C, 3 * C) * C ** -0.5).to(bf),
                bqkv=(0.02 * n(3 * C)).to(bf),
                wp=(n(C, C) * C ** -0.5).to(bf), bp=(0.02 * n(C)).to(bf),
                dy=n(G, 64, C).to(bf))


def _ulp(t):
    """One bf16 ulp of each value (of the smallest normal at 0)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _args(inp):
    return (inp["x"], inp["ls"], inp["lb"], inp["wqkv"], inp["bqkv"],
            inp["wp"], inp["bp"])


def _dln_terms(inp, heads, apply_ln):
    """Per channel, the sums of |dxn * xhat| and |dxn| over the tokens that
    dln_scale and dln_bias add up, from the plain version's grads (dxn
    recomputed without LN's backward): the scale their fp32 sums are held
    at."""
    x = inp["x"].float().reshape(-1, inp["x"].shape[-1])
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    xhat = (x - mu) * torch.rsqrt(var + 1e-5)
    # dxn = round(dqkv).wqkv^T: the plain backward without LN gives dx = dxn
    # at xn = round(LN(x)) fed as the input
    xn = ((x - mu) * (torch.rsqrt(var + 1e-5) * inp["ls"])
          + inp["lb"]).to(torch.bfloat16).reshape(inp["x"].shape)
    dxn = ab.attn_branch_backward_reference(
        xn, *_args(inp)[1:], inp["dy"], heads, 1e-5, False)[0].float()
    dxn = dxn.reshape(x.shape)
    return {"dln_scale": (dxn * xhat).abs().sum(0),
            "dln_bias": dxn.abs().sum(0)}


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("G,C", [(2, 64), (4, 80), (3, 80)])
def test_emulated_mma_arithmetic_matches_the_plain_version(G, C, apply_ln,
                                                           runs):
    inp = _inputs(G, C, G + C)
    plan = ab.attn_branch_backward_plan(G, 64, C, 2)
    if runs:   # blocks of two grids each, in both kernels
        b = -(-G // 2)
        plan = plan._replace(t_blocks=b, t_grids=2, w_splits=b, w_grids=2)
    got = emulate(inp["x"], inp["ls"], inp["lb"], inp["wqkv"], inp["bqkv"],
                  inp["wp"], inp["dy"], 2, 1e-5, apply_ln, plan)
    want = ab.attn_branch_backward_reference(*_args(inp), inp["dy"], 2, 1e-5,
                                             apply_ln)
    terms = _dln_terms(inp, 2, apply_ln) if apply_ln else None
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        if name.startswith("dln"):
            if not apply_ln:
                assert not g.any() and not w.any(), name
                continue
            # fp32 sums over the tokens: 2^-13 of each channel's sum of
            # magnitudes
            scale = terms[name]
            assert bool(((g - w).abs() <= 2.0 ** -13 * scale).all()), \
                f"{name}: {((g - w).abs() / scale).max().item()}"
        else:   # bf16: one ulp at the scale of the row
            top = torch.maximum(g.abs(), w.abs())
            ulp = _ulp(top.amax(-1, keepdim=True) if top.dim() >= 2
                       else top.max())
            assert bool(((g - w).abs() <= ulp).all()), \
                f"{name}: {((g - w).abs() / ulp).max().item()} ulp"


@pytest.mark.parametrize("G,C,apply_ln", [(2, 64, True), (2, 80, False)])
def test_emulated_mma_arithmetic_matches_attn_branch_pallas(G, C, apply_ln):
    # tests/test_torch_attn_branch.py's bf16 tolerance for #5 (5e-2; the
    # parameter grads relative to their largest value)
    inp = _inputs(G, C, 3 * G + C)
    plan = ab.attn_branch_backward_plan(G, 64, C, 2)
    got = emulate(inp["x"], inp["ls"], inp["lb"], inp["wqkv"], inp["bqkv"],
                  inp["wp"], inp["dy"], 2, 1e-5, apply_ln, plan)
    j = lambda t, dt=jnp.bfloat16: jnp.asarray(t.float().numpy(), dt)
    args = [j(inp["x"]), j(inp["ls"], jnp.float32), j(inp["lb"], jnp.float32),
            j(inp["wqkv"]), j(inp["bqkv"]), j(inp["wp"]), j(inp["bp"])]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda *a: attn_branch_pallas(*a, 2, 1e-5, apply_ln), *args)
        want = vjp(j(inp["dy"]))
    for name, g, w in zip(GRADS, got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if name == "dx" or name.startswith("dln"):
            np.testing.assert_allclose(g, w, atol=5e-2, rtol=5e-2,
                                       err_msg=name)
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 5e-2 * scale, name
