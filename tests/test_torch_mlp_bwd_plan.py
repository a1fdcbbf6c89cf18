"""The fused MLP branch's bf16 tensor-core backward,
``csrc/mlp_branch_bwd_mma.cu`` (TPU kernels #2 ``mlp_branch_pallas_t`` and
#4 ``mlp_branch_pallas``, backward half), checked on the CPU where it can
be:

- Its launch plan (``ops/mlp_branch.py:mlp_branch_backward_plan``) at every
  MLP shape of the shipped configs at their own batch and at the train
  batch 128 (the 7M model also at 48 and 96 px, the shapes
  ``chip_smoke.py`` drives) and at the card tests' edge shapes: the tiles
  cover M, C and H, each kernel's shared memory fits an H100 block, what
  one SM holds fits its shared memory, registers and threads, the
  workspace holds both kernels' partials, and the cache hands back the
  same plan. Its refusals (fp32, C or H not a multiple of 16, C whose dxn
  columns do not split evenly) send the launch to the FMA kernel's entry.
- A PyTorch emulation of the kernels' arithmetic: bf16 operands; every
  product summed in fp32 in k16 steps in the kernels' order (h and da over
  C, dxn over the hidden units chunk by chunk, dW1 and dW2 over the tokens
  of each split in tile order); the rounding points of the plain version;
  db1 and the LN backward's column and row sums in the kernels' shuffle
  trees; the token blocks' and the splits' fp32 partials summed in order.
  At C = 48, 64 and 448, H = 2C and 4C, with and without LN and for all
  three activations, against ``mlp_branch_backward_reference``: dx and the
  bf16 grads within 1 bf16 ulp of the largest value of their row, the fp32
  grads (dln_scale, dln_bias) within 2^-14 of each channel's sum of the
  magnitudes of its terms. Those scales, not each value's own: where a sum
  cancels, one intermediate bf16 rounding that the other order flips (h or
  dh, a few in 10^5) moves the result by a fraction of one term, which is
  several ulps of a small result (up to ~200 at C = 448) and, for
  dln_scale, up to 1.7 * 2^-14 of its largest value (C = 64, H = 128,
  GELU). Against JAX ``mlp_branch_pallas_t``
  (#2) and ``mlp_branch_pallas`` (#4) in interpret mode at the bf16
  tolerances of ``tests/test_torch_ops.py`` (2e-2) and
  ``tests/test_torch_64px.py`` (5e-2), the bf16 parameter grads relative
  to their largest value as the latter holds them (at C = 448 a few of the
  800K dW2 sums that cancel to near 0 are off by 0.035 elementwise).
- The padding rule: with M not a multiple of the tile and rows past M
  holding large finite garbage in x and dy, zero-filled x and dy (and dh
  forced to 0 on those rows) give bitwise the result of exact zero
  padding; without the zero fill they do not, whether dh is forced or not.
"""

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.mlp_branch_pallas import mlp_branch_pallas
from outgridvit_tpu.ops.mlp_branch_pallas_t import mlp_branch_pallas_t
from outgridvit_tpu_torch.ops import mlp_branch as mb
from outgridvit_tpu_torch.ops.activations import (
    activation_grad,
    make_activation,
)

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
GRADS = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


# ---- the launch plan --------------------------------------------------------

def _config_shapes(path, img=None, batch=None):
    """(M, C, H) of every MLP of a config's model at ``img`` px and
    ``batch`` (default: the yaml's own): per stage, the outlooker MLPs
    (H = 2C) and the block MLPs (H = 4C)."""
    cfg = yaml.safe_load((ROOT / path).read_text())
    img = img or cfg["data"]["img_size"]
    batch = batch or cfg["data"]["batch_size"]
    out = set()
    for si, s in enumerate(cfg["model"]["stages"]):
        C = s["dim"]
        for H in (2 * C, 4 * C):
            out.add((batch * (img >> si) ** 2, C, H))
    return out


CONFIGS = {
    "a7m": ("configs/cifar100_model_a_7m.yaml", 32),
    "a7m_48": ("configs/cifar100_model_a_7m.yaml", 48),
    "a7m_96": ("configs/cifar100_model_a_7m.yaml", 96),
    "tin200": ("configs/tinyimagenet200_model_a.yaml", None),
    "model_b": ("configs/cifar100_model_b.yaml", None),
    "a_base": ("configs/cifar100_model_a.yaml", None),
    "a14m": ("configs/cifar100_model_a_14m.yaml", None),
    "svhn": ("configs/svhn_model_a.yaml", None),
    "c100_64": ("configs/cifar100_64_model_a.yaml", None),
}
SHAPES = sorted({sh for path, img in CONFIGS.values()
                 for batch in (None, 128)
                 for sh in _config_shapes(path, img, batch)})
# the card tests' edge shapes (tests/test_torch_cuda.py)
EDGE = [(37, 48, 96), (1000, 64, 256), (300, 448, 1792), (5, 320, 640),
        (1, 16, 32), (129, 16, 64)]


def test_the_shapes_reach_every_shipped_width():
    widths = {C for _, C, _ in SHAPES}
    assert widths == {48, 64, 80, 96, 128, 160, 192, 256, 320, 384, 448}
    assert (524_288, 64, 256) in SHAPES      # Tiny-ImageNet stage 0, B 128
    assert (1_179_648, 48, 192) in SHAPES    # the 7M at 96 px, B 128


def _tokens_bytes(C, split, buffers):
    """The tokens kernel's shared memory, counted from its layout: the x/xn
    and dy tiles of 16 * 8 / split tokens, ``buffers`` w1 [C, chunk] and w2
    [chunk, C] chunks, the dh exchange tile (split > 1), mu and rstd, the
    dln_scale, dln_bias and db2 sums (to 16 bytes) and the db2 sums of
    each group of rows (2 per thread); rows padded to an odd number of
    16-byte units."""
    def row(cols):
        return 16 * ((cols // 8) | 1)
    rows = 128 // split
    chunk = 64 if split > 1 else 32
    return (2 * rows * row(C) + buffers * (C * row(chunk) + chunk * row(C))
            + (rows * row(chunk) if split > 1 else 0) + 2 * 4 * rows
            + 16 * -(-3 * 4 * C // 16) + 4 * 2 * 256)


@pytest.mark.parametrize("M,C,H", SHAPES + EDGE)
def test_mma_plan_at_every_shape(M, C, H):
    p = mb.mlp_branch_backward_plan(M, C, H)
    where = (M, C, H, p)
    # tokens kernel: the split's dxn columns, its tiles over M and chunks
    # over H
    assert p.t_split in (1, 2, 4), where
    assert C % (16 * p.t_split) == 0 and C // p.t_split <= 128, where
    assert p.t_rows == 16 * 8 // p.t_split, where
    assert p.t_chunk == (64 if p.t_split > 1 else 32), where
    assert (p.t_tiles - 1) * p.t_rows < M <= p.t_tiles * p.t_rows, where
    assert 1 <= p.t_blocks <= min(p.t_tiles, mb.MMA_MAX_TOKEN_BLOCKS)
    assert p.t_smem == _tokens_bytes(C, p.t_split, p.t_buffers), where
    assert p.t_smem <= BLOCK_SMEM, where
    # two weight buffers wherever they fit
    if p.t_buffers == 1:
        assert _tokens_bytes(C, p.t_split, 2) > BLOCK_SMEM, where
    # weights kernel: slabs over H, splits of tiles over M, m16 tiles over C
    assert p.w_units in mb.MMA_UNITS and p.w_rows in mb.MMA_ROWS, where
    assert (p.w_slabs - 1) * p.w_units < H <= p.w_slabs * p.w_units, where
    tiles = -(-M // p.w_rows)
    assert (p.w_splits - 1) * p.w_tiles_per_split < tiles, where
    assert tiles <= p.w_splits * p.w_tiles_per_split, where
    warp_m_groups = 8 // (p.w_units // 32)
    assert p.w_mt in (2, 4), where
    assert (p.w_mt - 2) * warp_m_groups * 16 < C, where  # 4 only if needed
    assert p.w_mt * warp_m_groups * 16 >= C, where
    assert p.w_smem <= BLOCK_SMEM, where
    # what one SM holds: shared memory, registers, threads
    for per_sm, smem, regs in ((p.t_blocks_per_sm, p.t_smem, p.t_regs),
                               (p.w_blocks_per_sm, p.w_smem, p.w_regs)):
        assert per_sm >= 1, where
        assert per_sm * (smem + 1024) <= SM_SMEM, where
        assert per_sm * 256 * regs <= 65536, where
        assert per_sm * 256 <= 2048, where
    # the workspace: one [3, C] partial a token block, one dW1 + dW2 + db1
    # partial a split
    assert p.ws_floats == 3 * C * p.t_blocks + (2 * C * H + H) * p.w_splits
    assert (2 * C * H + H) * p.w_splits <= mb.MMA_MAX_WORKSPACE, where
    assert mb.backward_entry(M, C, H, torch.bfloat16) == \
        "ogvt_mlp_branch_bwd_mma"
    # cached: the wrapper asks at every launch
    assert mb.mlp_branch_backward_plan(M, C, H) is p


def test_mma_plan_at_tin_stage0():
    # Tiny-ImageNet stage 0 at train batch 128: one row tile a warp, two
    # blocks an SM (the dxn tile fits 128 registers), both weight chunks
    # staged at once, two waves of tokens blocks; the weights kernel's
    # widest slab that holds 4 m16 tiles a warp (H = 256: one slab), one
    # wave of splits
    p = mb.mlp_branch_backward_plan(524_288, 64, 256)
    assert (p.t_split, p.t_rows, p.t_buffers, p.t_blocks_per_sm) == \
        (1, 128, 2, 2)
    assert p.t_blocks == 2 * 132 * 2
    assert (p.w_units, p.w_rows, p.w_mt, p.w_slabs) == (256, 64, 4, 1)
    assert p.w_splits * p.w_slabs <= 132 * p.w_blocks_per_sm


@pytest.mark.parametrize("M,C,H,dtype", [
    (64, 48, 96, torch.float32),       # fp32: the FMA kernel's
    (64, 40, 160, torch.bfloat16),     # C not a multiple of 16
    (64, 48, 100, torch.bfloat16),     # H not a multiple of 16
    (64, 144, 576, torch.bfloat16),    # C / 2 not a multiple of 16
    (64, 576, 2304, torch.bfloat16),   # C / 4 past 128
    (0, 48, 96, torch.bfloat16)])
def test_mma_plan_refuses_what_the_kernel_does_not_take(M, C, H, dtype):
    with pytest.raises(ValueError, match=f"M={M}, C={C}, H={H}"):
        mb.mlp_branch_backward_plan(M, C, H, dtype)
    assert mb.backward_entry(M, C, H, dtype) == "ogvt_mlp_branch_bwd"


# ---- the kernels' arithmetic, emulated --------------------------------------

def _bf(t):
    """Round to bf16 (nearest even) and back to fp32: a rounding point."""
    return t.to(torch.bfloat16).float()


def _mm16(a, b):
    """a [m, K] @ b [K, n], bf16 values summed in fp32 in k16 steps in
    ascending k: one mma.sync m16n8k16 a step, into one accumulator."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        out = out + a[:, k:k + 16] @ b[k:k + 16]
    return out


def _tree16(v):
    """Sum of the 16 rows of v [16, ...] in the kernels' shuffle order: rows
    g and g + 8 in a lane, then xor 4, 8, 16 over g."""
    s = v[:8] + v[8:]
    s = s[0::2] + s[1::2]
    s = s[0::2] + s[1::2]
    return s[0] + s[1]


def _fma(a, b, c):
    """fmaf(a, b, c): one rounding of the exact a * b + c."""
    return (a.double() * b.double() + c.double()).float()


def _ln_rows(x, ls, lb, eps):
    """layernorm_rows's forward from the staged bf16 x [R, C]: each lane
    sums its column pairs in order, the warp's xor tree sums the lanes;
    returns (round(LN(x)), mu, rstd)."""
    R, C = x.shape
    v = torch.zeros(R, 32, C // 64 + 1, 2)
    pairs = x.reshape(R, C // 2, 2)
    for p in range(C // 2):
        v[:, p % 32, p // 32] = pairs[:, p]
    s = torch.zeros(R, 32)
    ss = torch.zeros(R, 32)
    for k in range(v.shape[2]):
        s = s + v[:, :, k, 0]
        s = s + v[:, :, k, 1]
        ss = _fma(v[:, :, k, 0], v[:, :, k, 0], ss)
        ss = _fma(v[:, :, k, 1], v[:, :, k, 1], ss)
    for o in (16, 8, 4, 2, 1):
        idx = torch.arange(32) ^ o
        s, ss = s + s[:, idx], ss + ss[:, idx]
    mu = s[:, :1] / C
    rstd = torch.rsqrt(torch.clamp(ss[:, :1] / C - mu * mu, min=0.0) + eps)
    return _bf((x - mu) * (rstd * ls) + lb), mu, rstd


class Rules(NamedTuple):
    """The kernels' padding rules (all on: the kernels as written): rows
    past M of x and dy zero-filled as they are staged, dh forced to 0
    there."""
    zfill: bool = True
    zero_dh: bool = True


def emulate(x, ls, lb, w1, b1, w2, dy, act, eps, apply_ln, plan,
            rules=Rules(), pad=None):
    """The grads ``(dx, dln_scale, dln_bias, dw1, db1, dw2, db2)`` of
    ``ogvt_mlp_branch_bwd_mma`` under ``plan``, emulated in fp32 (bf16
    values as fp32). ``pad``: what rows past M hold in the staged tiles
    ((x rows, dy rows), any number), zeros by default; with
    ``rules.zfill`` the kernels zero-fill them whatever they hold."""
    M, C = x.shape
    H = w1.shape[1]
    x, dy, w1, w2, b1 = (t.float() for t in (x, dy, w1, w2, b1))
    f, fg = make_activation(act), activation_grad(act)

    def padded(rows, t, fill):
        """t's rows past M up to ``rows``: the fill, or zeros."""
        out = torch.zeros(rows, C)
        out[:M] = t
        if fill is not None and not rules.zfill:
            out[M:] = fill[:rows - M]
        return out

    # -- tokens kernel ------------------------------------------------------
    TM, S = plan.t_rows, plan.t_split
    Mt = plan.t_tiles * TM
    xt = padded(Mt, x, None if pad is None else pad[0])
    dyt = padded(Mt, dy, None if pad is None else pad[1])
    valid = torch.arange(Mt) < M
    if apply_ln:
        xn, mu, rstd = _ln_rows(xt, ls, lb, eps)
        xn = torch.where(valid[:, None], xn, xt)   # LN of rows < M only
    else:
        xn = xt
    h = _mm16(xn, w1)
    da = _mm16(dyt, w2.t())
    dh = _bf(da * fg(_bf(h + b1)))
    if rules.zero_dh:
        dh = torch.where(valid[:, None], dh, torch.zeros(()))
    dxn = _mm16(dh, w1.t())   # chunk by chunk, units ascending: one order
    db2_t = torch.zeros(plan.t_tiles, C)
    dls_t = torch.zeros(plan.t_tiles, C)
    dlb_t = torch.zeros(plan.t_tiles, C)
    dx = torch.zeros(Mt, C)
    cs = C // S
    for t in range(plan.t_tiles):
        r = slice(t * TM, (t + 1) * TM)
        rows = min(TM, M - t * TM)
        # db2: a thread sums a column pair over every RG-th row in order,
        # then the row groups in order
        RG = 512 // C
        acc = torch.zeros(C)
        for g in range(RG):
            part = torch.zeros(C)
            for i in range(g, rows, RG):
                part = part + dyt[t * TM + i]
            acc = acc + part
        db2_t[t] = acc
        d = dxn[r]
        if not apply_ln:
            dx[r] = d
            continue
        v = valid[r][:, None]
        xhat = torch.where(v, (xt[r] - mu[r]) * rstd[r], torch.zeros(()))
        # column sums: a warp's 16 rows by the shuffle tree, row tiles in
        # order
        cl = torch.stack([_tree16_pairs(c, xh)
                          for c, xh in zip(d.reshape(TM // 16, 16, C),
                                           xhat.reshape(TM // 16, 16, C))])
        cb = torch.stack([_tree16(c) for c in d.reshape(TM // 16, 16, C)])
        ls_acc = torch.zeros(C)
        lb_acc = torch.zeros(C)
        for i in range(TM // 16):
            ls_acc = ls_acc + cl[i]
            lb_acc = lb_acc + cb[i]
        dls_t[t], dlb_t[t] = ls_acc, lb_acc
        # row sums: a lane's column pairs in order, the quad's xor tree,
        # the splits in order
        dxhat = d * ls
        s1 = torch.zeros(TM, S, 4)
        s2 = torch.zeros(TM, S, 4)
        q = dxhat.reshape(TM, S, cs // 8, 4, 2)
        xq = xhat.reshape(TM, S, cs // 8, 4, 2)
        for n in range(cs // 8):
            s1 = s1 + (q[:, :, n, :, 0] + q[:, :, n, :, 1])
            s2 = _fma(q[:, :, n, :, 1], xq[:, :, n, :, 1],
                      _fma(q[:, :, n, :, 0], xq[:, :, n, :, 0], s2))
        s1 = (s1[..., 0] + s1[..., 1]) + (s1[..., 2] + s1[..., 3])
        s2 = (s2[..., 0] + s2[..., 1]) + (s2[..., 2] + s2[..., 3])
        m1 = torch.zeros(TM, 1)
        m2 = torch.zeros(TM, 1)
        for s in range(S):
            m1 = m1 + s1[:, s:s + 1]
            m2 = m2 + s2[:, s:s + 1]
        m1, m2 = m1 / C, m2 / C
        dx[r] = rstd[r] * (dxhat - m1 - xhat * m2)

    def blocks(parts, nblocks):
        """A block's tiles (t = b, b + nblocks, ...) in order, then the
        blocks' partials in order."""
        total = torch.zeros(parts.shape[1:])
        for b in range(nblocks):
            acc = torch.zeros(parts.shape[1:])
            for t in range(b, parts.shape[0], nblocks):
                acc = acc + parts[t]
            total = total + acc
        return total

    db2 = blocks(db2_t, plan.t_blocks)
    dls = blocks(dls_t, plan.t_blocks)
    dlb = blocks(dlb_t, plan.t_blocks)

    # -- weights kernel: per split, 16-token steps in tile order ----------
    TW = plan.w_rows
    Mw = -(-M // TW) * TW
    xw = padded(Mw, x, None if pad is None else pad[0])
    dyw = padded(Mw, dy, None if pad is None else pad[1])
    validw = torch.arange(Mw) < M
    xnw = torch.where(validw[:, None], _ln_rows(xw, ls, lb, eps)[0], xw) \
        if apply_ln else xw
    hw = _bf(_mm16(xnw, w1) + b1)
    g_a, g_d = f(hw), fg(hw)
    aw = _bf(g_a)
    dhw = _bf(_mm16(dyw, w2.t()) * g_d)
    if rules.zero_dh:
        dhw = torch.where(validw[:, None], dhw, torch.zeros(()))
    dw1 = torch.zeros(C, H)
    dw2t = torch.zeros(C, H)
    db1 = torch.zeros(H)
    tps = plan.w_tiles_per_split
    for sp in range(plan.w_splits):
        a1 = torch.zeros(C, H)
        a2 = torch.zeros(C, H)
        b = torch.zeros(H)
        for t in range(sp * tps, min(Mw // TW, (sp + 1) * tps)):
            rts = -(-min(TW, M - t * TW) // 16)
            for k in range(rts):
                r = slice(t * TW + 16 * k, t * TW + 16 * k + 16)
                a1 = a1 + xnw[r].t() @ dhw[r]
                a2 = a2 + dyw[r].t() @ aw[r]
            for k in range(rts):   # db1: row tiles in order, each a tree
                b = b + _tree16(dhw[t * TW + 16 * k:t * TW + 16 * k + 16])
        dw1, dw2t, db1 = dw1 + a1, dw2t + a2, db1 + b
    bf = torch.bfloat16
    return (dx[:M].to(bf), dls, dlb, dw1.to(bf), db1.to(bf),
            dw2t.t().contiguous().to(bf), db2.to(bf))


def _tree16_pairs(d, xhat):
    """The dxn * xhat column sums of one warp: each lane's two rows as
    fmaf(dxn[g + 8], xhat[g + 8], dxn[g] * xhat[g]), then the xor tree."""
    s = _fma(d[8:], xhat[8:], d[:8] * xhat[:8])
    s = s[0::2] + s[1::2]
    s = s[0::2] + s[1::2]
    return s[0] + s[1]


def _inputs(M, C, H, seed):
    """bf16 x, w1, b1, w2, b2, dy and fp32 ln_scale, ln_bias (torch)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bf = torch.bfloat16
    return dict(x=n(M, C).to(bf), ls=1 + 0.1 * n(C), lb=0.1 * n(C),
                w1=(n(C, H) * C ** -0.5).to(bf), b1=(0.02 * n(H)).to(bf),
                w2=(n(H, C) * H ** -0.5).to(bf), b2=(0.02 * n(C)).to(bf),
                dy=n(M, C).to(bf))


def _ulp(t):
    """One bf16 ulp of each value (of the smallest normal at 0)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _run(inp, act, apply_ln, M, C, H, **kw):
    plan = mb.mlp_branch_backward_plan(M, C, H)
    return emulate(inp["x"], inp["ls"], inp["lb"], inp["w1"], inp["b1"],
                   inp["w2"], inp["dy"], act, 1e-5, apply_ln, plan, **kw)


# M = 300: a ragged last tile in both kernels at every width
@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,mult", [(48, 2), (48, 4), (64, 2), (64, 4),
                                    (448, 2), (448, 4)])
def test_emulated_mma_arithmetic_matches_the_plain_version(C, mult, apply_ln,
                                                           act):
    M, H = 300, mult * C
    inp = _inputs(M, C, H, C + H)
    got = _run(inp, act, apply_ln, M, C, H)
    want = mb.mlp_branch_backward_reference(
        inp["x"], inp["ls"], inp["lb"], inp["w1"], inp["b1"], inp["w2"],
        inp["b2"], inp["dy"], act, 1e-5, apply_ln)
    terms = _dln_terms(inp, act) if apply_ln else None
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        if name.startswith("dln"):
            if not apply_ln:
                assert not g.any(), name
                continue
            # fp32 sums over the tokens: 2^-14 of each column's sum of
            # magnitudes
            scale = terms[name]
            assert bool(((g - w).abs() <= 2.0 ** -14 * scale).all()), \
                f"{name}: {((g - w).abs() / scale).max().item()}"
        else:   # bf16: one ulp at the scale of the row
            top = torch.maximum(g.abs(), w.abs())
            ulp = _ulp(top.amax(-1, keepdim=True) if top.dim() == 2
                       else top.max())
            assert bool(((g - w).abs() <= ulp).all()), \
                f"{name}: {((g - w).abs() / ulp).max().item()} ulp"


def _dln_terms(inp, act):
    """Per channel, the sums of |dxn * xhat| and |dxn| over the tokens that
    dln_scale and dln_bias add up, from the plain version's rounding
    points: the scale their fp32 sums are held at."""
    x = inp["x"].float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    xn = _bf((x - mu) * (rstd * inp["ls"]) + inp["lb"])
    h = _bf(xn @ inp["w1"].float() + inp["b1"].float())
    dh = _bf(inp["dy"].float() @ inp["w2"].float().t()
             * activation_grad(act)(h))
    dxn = dh @ inp["w1"].float().t()
    return {"dln_scale": (dxn * (x - mu) * rstd).abs().sum(0),
            "dln_bias": dxn.abs().sum(0)}


def _jax_grads(inp, act, apply_ln, fn):
    j = lambda t, dt=jnp.bfloat16: jnp.asarray(t.float().numpy(), dt)
    args = [j(inp["x"]), j(inp["ls"], jnp.float32), j(inp["lb"], jnp.float32),
            j(inp["w1"]), j(inp["b1"]), j(inp["w2"]), j(inp["b2"])]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: fn(*a, act, 1e-5, apply_ln), *args)
        return vjp(j(inp["dy"]))


@pytest.mark.parametrize("C,H,apply_ln,act", [
    (48, 192, True, "gelu"), (64, 128, False, "silu"),
    (448, 1792, True, "gelu")])
def test_emulated_mma_arithmetic_matches_mlp_branch_pallas_t(C, H, apply_ln,
                                                             act):
    # tests/test_torch_ops.py's bf16 tolerance for #2 (2e-2 abs + rel)
    M = 256
    inp = _inputs(M, C, H, C + 7)
    got = _run(inp, act, apply_ln, M, C, H)
    want = _jax_grads(inp, act, apply_ln, mlp_branch_pallas_t)
    _close(got, want, 2e-2)


def _close(got, want, tol):
    """dx and the fp32 dln grads within ``tol`` abs + rel; the bf16
    parameter grads (sums over all tokens) within ``tol`` of their largest
    value, as ``tests/test_torch_64px.py:_close_grads``."""
    for name, g, w in zip(GRADS, got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if name == "dx" or name.startswith("dln"):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                       err_msg=name)
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol * scale, name


@pytest.mark.parametrize("C,H", [(64, 256), (48, 96)])
def test_emulated_mma_arithmetic_matches_mlp_branch_pallas(C, H):
    # tests/test_torch_64px.py's bf16 tolerance for #4 (5e-2; parameter
    # grads relative to their largest value)
    M = 512
    inp = _inputs(M, C, H, C + 11)
    got = _run(inp, "gelu", True, M, C, H)
    _close(got, _jax_grads(inp, "gelu", True, mlp_branch_pallas), 5e-2)


# ---- the padding rule -------------------------------------------------------

@pytest.mark.parametrize("C", [64, 448])
@pytest.mark.parametrize("zfill,zero_dh", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_padding_rule(C, zfill, zero_dh):
    # M = 300 leaves 84 (C = 64: tiles of 128) or 20 (C = 448: 32) padded
    # rows in the tokens kernel's last tile and 20 / 4 in the weights
    # kernel's; they hold large finite garbage unless zero-filled
    M, H = 300, 4 * C
    inp = _inputs(M, C, H, 5)
    rng = np.random.default_rng(6)
    garbage = tuple(torch.from_numpy(
        (1e4 * rng.normal(size=(128, C))).astype(np.float32)).bfloat16()
        .float() for _ in range(2))
    exact = _run(inp, "gelu", True, M, C, H)   # zero padding
    got = _run(inp, "gelu", True, M, C, H, rules=Rules(zfill, zero_dh),
               pad=garbage)
    same = all(torch.equal(g, w) for g, w in zip(got, exact))
    # zero-filled rows give zero da, so dh is 0 there with or without the
    # forcing (the kernels force it all the same); without the zero fill
    # the garbage reaches dW2, db2 and the LN sums
    assert same == zfill


def test_padding_rule_garbage_reaches_the_grads_without_it():
    M, C, H = 300, 64, 128
    inp = _inputs(M, C, H, 8)
    garbage = tuple(torch.full((128, C), 1e4) for _ in range(2))
    exact = _run(inp, "silu", True, M, C, H)
    got = _run(inp, "silu", True, M, C, H, rules=Rules(False, True),
               pad=garbage)
    # the tokens kernel reads no padded row where dh is 0 (db2 sums the
    # rows below M), but the weights kernel's last 16-token step takes
    # 4 padded rows of dy into dW2
    assert torch.equal(got[6], exact[6])   # db2
    assert not torch.equal(got[5], exact[5])   # dW2
