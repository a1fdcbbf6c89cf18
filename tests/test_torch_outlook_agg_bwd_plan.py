"""The fused outlook projection's bf16 tensor-core backward,
``csrc/outlook_agg_bwd_mma.cu`` (TPU kernels #7
``outlook_attention_proj_pallas`` and #8 ``outlook_branch_pallas``,
backward half), checked on the CPU where it can be:

- Its launch plan (``ops/outlook_agg.py:outlook_agg_backward_plan``) at
  every outlooker shape of the shipped configs at batch 64 and 128 (the 7M
  model also at 48 and 96 px) and at the card tests' edge shapes (H != W, a
  ragged last tile, Cin != C): the tiles cover every image row and every
  pixel once, the blocks walk every tile once, the shared memory (recounted
  here from the layout) fits an H100 block, what one SM holds fits its
  registers and threads, the workspace holds every block's partial.
  Every outlooker of C <= 128 is taken in bf16; the refusals (fp32, C or
  Cin not a multiple of 16 such as the card test's Cin = 40, a head width
  not a multiple of 4, a layout that does not fit) send the launch to the
  FMA kernel's entry, each with its reason.
- A PyTorch emulation of the kernel's arithmetic: bf16 operands; the
  products summed in fp32 in k16 steps (v = x.Wv + bv and dyag = g.Wp^T
  on every staged pixel of each tile, the halo rows' dyag recomputed
  there, dx = round(dv).Wv^T; dWp += y^T.g and dWv += x^T.round(dv) into
  each block's running sums, 16 pixels a step, tile by tile); the taps in
  the plain version's order with each product rounded apart (a tap
  outside the image's columns adds the zero padding's +0); da summed with
  fmaf over each part's channels in order, then the parts' tree;
  dbv and dbp as column sums over 8 pixel segments in order; the blocks'
  partials summed in block order. At C = 48, 64 and 96 (with several
  channel chunks, a ragged last tile, Cin != C), against
  ``outlook_agg_proj_backward_reference`` /
  ``outlook_branch_backward_reference``: at least 98% of dv / dx and of da
  bitwise equal, every element within one bf16 rounding of the largest
  magnitude of its pixel's row (2^-7 of it: a fp32 sum taken in another
  order flips a rounding, of a value at most that large), every parameter
  grad within 2^-7 of its largest magnitude (sums over all pixels, cast
  once). Against JAX ``outlook_attention_proj_pallas`` /
  ``outlook_branch_pallas`` grads in interpret mode at the bf16 bars of
  ``tests/test_torch_outlook_agg.py:119-133``: fewer than 1% of dv / dx
  differ, each by at most one bf16 rounding; da and the weight grads
  within 2^-7 of their largest magnitude.
- The padding rule: staged rows outside the image filled with large finite
  garbage, then zero-filled, give bitwise the result of exact zero padding;
  so does garbage that is not zero-filled where the epilogue's mask (v and
  dyag forced to 0 outside the image) covers it, but not NaN garbage, and
  not the fold without the mask (v = bv would leak the bias).
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

from outgridvit_tpu.ops.experimental import outlook_agg_pallas as oap
from outgridvit_tpu_torch.ops import outlook_agg as oa

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
TAPS = 9
MMA, FMA = oa.BACKWARD_ENTRIES


# ---- the launch plan --------------------------------------------------------

def _outlooker_shapes(path, img=None, batch=None):
    """(B, H, C, heads) of every outlooker of a config's model at ``img``
    px and ``batch`` (default: the yaml's own): one per stage of Model A,
    the front outlookers (stage 0) of Model B."""
    cfg = yaml.safe_load((ROOT / path).read_text())
    img = img or cfg["data"]["img_size"]
    batch = batch or cfg["data"]["batch_size"]
    stages = cfg["model"]["stages"]
    if cfg["model"]["type"] == "model_b":
        stages = stages[:1]
    return {(batch, img >> si, s["dim"], s["outlook_heads"])
            for si, s in enumerate(stages)}


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
                 for batch in (64, 128)
                 for sh in _outlooker_shapes(path, img, batch)})
# the card tests' outlook shapes (tests/test_torch_cuda.py:OUTLOOK_SHAPES):
# (B, H, W, Cin, C, heads)
EDGE = [(128, 32, 32, 64, 64, 2), (4, 64, 64, 64, 64, 2),
        (3, 13, 20, 48, 48, 2)]


def test_the_shapes_reach_every_shipped_outlooker():
    widths = {C for _, _, C, _ in SHAPES}
    assert widths == {48, 64, 80, 96, 128, 160, 192, 256, 320, 384, 448}
    assert (128, 32, 64, 2) in SHAPES    # Model B's front, train batch
    assert (128, 64, 64, 2) in SHAPES    # Tiny-ImageNet stage 0
    assert (128, 96, 48, 2) in SHAPES    # the 7M model at 96 px


def _layout_bytes(W, Cin, C, heads, R, CH, fold):
    """The kernel's shared memory, recounted from its layout: x and g of
    the tile's R rows and its two halo rows (to 16-row tiles), Wp and Wv,
    the y (or dx) and round(dv) tiles, the tap weights, fp32 v and dyag of
    one chunk at every staged pixel with a zero pixel either side of each
    row, da, and the column sums; bf16 rows an odd number of 16-byte units
    apart, fp32 pixels two floats past the chunk."""
    def row(cols):
        return 16 * ((cols // 8) | 1)

    def up16(n):
        return -(-n // 16) * 16

    ext, SP = (R + 2) * W, up16(R * W)
    NE = up16(max(ext, W + SP))
    h9 = TAPS * heads
    return (NE * row(Cin) + NE * row(C) + C * row(C)
            + (Cin * row(C) if fold else 0) + SP * row(max(C, Cin))
            + SP * row(C) + up16(2 * ext * h9)
            + 2 * up16(4 * (R + 2) * (W + 2) * (CH + 2)) + up16(2 * SP * h9)
            + up16(4 * 8 * C) + 2 * up16(4 * C))


def _check_plan(p, B, H, W, Cin, C, heads, fold):
    hd = C // heads
    assert C % p.chunk == 0 and p.chunk % hd == 0 and p.chunk % 16 == 0
    # the tiles cover every image row of every image once, and every pixel
    per = -(-H // p.rows)
    assert p.tiles == B * per
    covered = [r for t in range(per)
               for r in range(t * p.rows, min(H, (t + 1) * p.rows))]
    assert covered == list(range(H))
    assert sum(min(p.rows, H - t * p.rows) * W for t in range(per)) * B \
        == B * H * W
    # the blocks walk every tile once (t = b, b + blocks, ...), none idle
    assert 1 <= p.blocks <= p.tiles
    walked = sorted(t for b in range(p.blocks)
                    for t in range(b, p.tiles, p.blocks))
    assert walked == list(range(p.tiles))
    # one block's shared memory, and what one SM holds
    assert p.smem == _layout_bytes(W, Cin, C, heads, p.rows, p.chunk, fold)
    assert p.smem <= BLOCK_SMEM
    assert p.blocks_per_sm * (p.smem + 1024) <= SM_SMEM
    assert p.blocks_per_sm * p.threads * p.regs <= 65536
    assert p.blocks_per_sm * p.threads <= 2048
    assert p.blocks <= 132 * p.blocks_per_sm
    # the dW tiles a warp holds, and every block's partial
    units = max((C // 16) ** 2, (Cin // 16) * (C // 16) if fold else 0)
    assert p.slots == -(-units // (p.threads // 32)) <= 4
    assert p.ws_floats == p.blocks * (C * C + C
                                      + (Cin * C + C if fold else 0))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,H,C,heads", SHAPES)
def test_mma_plan_at_every_outlooker_shape(B, H, C, heads, fold):
    W = H
    got = oa._fit_backward(B, H, W, C, C, heads, fold)
    entry = oa.backward_entry(B, H, W, C, C, heads, fold, torch.bfloat16)
    if C <= 128:  # every outlooker of C <= 128 runs the tensor cores
        assert isinstance(got, oa.OutlookBwdPlan), (B, H, C, got)
    if isinstance(got, str):
        assert entry == FMA
        with pytest.raises(ValueError, match="no tile"):
            oa.outlook_agg_backward_plan(B, H, W, C, C, heads, fold)
        return
    assert entry == MMA
    assert oa.outlook_agg_backward_plan(B, H, W, C, C, heads, fold) is got
    _check_plan(got, B, H, W, C, C, heads, fold)
    assert oa.backward_entry(B, H, W, C, C, heads, fold,
                             torch.float32) == FMA


def test_mma_plan_at_model_b_front():
    # the 1,024 tiles of 4 rows (32 x 32 images, batch 128) over one block
    # an SM
    for fold in (False, True):
        p = oa.outlook_agg_backward_plan(128, 32, 32, 64, 64, 2, fold)
        assert (p.rows, p.chunk, p.tiles, p.blocks, p.threads) == \
            (4, 64, 1024, 132, 512)
        assert p.blocks_per_sm == 1 and p.slots == 1


@pytest.mark.parametrize("B,H,W,Cin,C,heads", EDGE)
def test_mma_plan_at_the_card_tests_shapes(B, H, W, Cin, C, heads):
    for fold in (False, True):
        p = oa.outlook_agg_backward_plan(B, H, W, Cin, C, heads, fold)
        _check_plan(p, B, H, W, Cin, C, heads, fold)


def _plan_at(B, H, W, Cin, C, heads, rows, chunk, fold):
    """The plan the kernel's layout gives at ``rows`` and ``chunk``, built
    as ``_fit_backward`` builds its choice."""
    threads, smem, regs, slots = oa._layout(W, Cin, C, heads, rows, chunk,
                                            fold)
    per_sm = oa.sm_blocks(threads, smem, regs)
    tiles = B * -(-H // rows)
    blocks = min(tiles, 132 * per_sm)
    return oa.OutlookBwdPlan(rows, chunk, tiles, blocks, threads, smem, regs,
                             per_sm, slots,
                             blocks * oa.partial_floats(Cin, C, fold))


@pytest.mark.parametrize("rows", [2, 3, 4, 5])
def test_mma_plan_with_a_ragged_last_tile_and_cin_not_c(rows):
    # 13 rows in tiles of 2-5 leave a last tile of 1-3 rows; Cin = 32 != C
    p = _plan_at(300, 13, 20, 32, 48, 2, rows, 48, True)
    assert 13 % p.rows
    _check_plan(p, 300, 13, 20, 32, 48, 2, True)
    p = oa.outlook_agg_backward_plan(2, 13, 20, 32, 48, 2, True)
    _check_plan(p, 2, 13, 20, 32, 48, 2, True)


@pytest.mark.parametrize("B,H,W,Cin,C,heads,fold,dtype,why", [
    (128, 32, 32, 64, 64, 2, True, torch.float32, "bf16 only"),
    (3, 13, 20, 40, 48, 2, True, torch.bfloat16, "multiples of 16"),
    (2, 8, 8, 24, 24, 2, False, torch.bfloat16, "multiples of 16"),
    (2, 8, 8, 48, 48, 16, True, torch.bfloat16, "multiple of 4"),
    (2, 8, 8, 48, 48, 8, False, torch.bfloat16, "multiple of 4"),
    (128, 8, 8, 192, 192, 6, True, torch.bfloat16, "no tile"),
    (128, 4, 4, 256, 256, 8, False, torch.bfloat16, "no tile"),
    (2, 2, 4096, 64, 64, 2, True, torch.bfloat16, "no tile"),
    (0, 8, 8, 64, 64, 2, True, torch.bfloat16, "empty"),
])
def test_mma_plan_refuses_what_the_kernel_does_not_take(B, H, W, Cin, C,
                                                        heads, fold, dtype,
                                                        why):
    with pytest.raises(ValueError, match=why):
        oa.outlook_agg_backward_plan(B, H, W, Cin, C, heads, fold, dtype)
    assert oa.backward_entry(B, H, W, Cin, C, heads, fold, dtype) == FMA


def test_the_layout_query_refuses_what_the_kernel_does_not_take():
    ok = (32, 64, 64, 2, 4, 64, 1)
    assert oa._layout(*ok) is not None
    for bad in ((32, 64, 64, 2, 4, 48, 1),    # chunk not dividing C
                (32, 64, 64, 2, 4, 16, 1),    # chunk not a multiple of hd
                (32, 48, 64, 2, 4, 64, 0),    # Cin != C without the fold
                (32, 64, 64, 2, 5, 64, 1),    # more than one block's smem
                (32, 40, 48, 2, 1, 48, 1),    # Cin not a multiple of 16
                (8, 192, 192, 6, 1, 192, 1),  # 9 dW tiles a warp
                (32, 64, 64, 2, 0, 64, 1)):   # no rows
        assert oa._layout(*bad) is None, bad


# ---- the kernel's arithmetic, emulated --------------------------------------

def _bf(t):
    """Round to bf16 (nearest even) and back to fp32: a rounding point."""
    return t.to(torch.bfloat16).float()


def _mm16(a, b, out=None):
    """out + a [m, K] @ b [K, n], bf16 values summed in fp32 in k16 steps
    in ascending k: one mma.sync m16n8k16 a step, into one accumulator."""
    out = torch.zeros(a.shape[0], b.shape[1]) if out is None else out
    for k in range(0, a.shape[1], 16):
        out = out + a[:, k:k + 16] @ b[k:k + 16]
    return out


def _fma(a, b, c):
    """fmaf(a, b, c): one rounding of the exact a * b + c."""
    return (a.double() * b.double() + c.double()).float()


def _parts(hd, SP, hc):
    """The parts of a head's channels the taps take (the layout's np)."""
    n = 1
    while n < 8 and (hd // n) % 8 == 0 and SP * hc * n < 512:
        n *= 2
    return n


def _tree(parts):
    """The parts' sum over their lanes' xor tree: neighbours first."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _colsum(t, n, segs=8):
    """Column sums of t's first n rows the kernel's way: segments of
    ceil(n / 8) rows, each summed in order, then the segments in order."""
    L = -(-n // segs)
    total = torch.zeros(t.shape[1])
    for s in range(segs):
        part = torch.zeros(t.shape[1])
        for r in range(s * L, min(n, (s + 1) * L)):
            part = part + t[r]
        total = total + part
    return total


class Rules(NamedTuple):
    """The kernel's padding rules (both on: the kernel as written): staged
    rows outside the image zero-filled; v (the fold) and dyag forced to 0
    there by the products' epilogue."""
    zfill: bool = True
    mask: bool = True


def emulate(x, a, wv, bv, wp, g, rows, chunk, blocks, rules=Rules(),
            pad=None):
    """The grads of ``ogvt_outlook_agg_bwd_mma`` with tiles of ``rows``
    rows, channel chunks of ``chunk`` and ``blocks`` blocks, emulated in
    fp32 (bf16 values as fp32): ``(dv, da, dwp, dbp)``, with the fold
    (``wv`` given) ``(dx, da, dwv, dbv, dwp, dbp)``. ``pad``: what staged
    rows outside the image hold, a value (zeros by default); with
    ``rules.zfill`` the kernel zero-fills them whatever they hold."""
    fold = wv is not None
    B, H, W, Cin = x.shape
    C, heads = wp.shape[0], a.shape[-1] // TAPS
    hd, h9, R = C // heads, a.shape[-1], rows
    xf, af, gf, wpf = x.float(), a.float(), g.float(), wp.float()
    per = -(-H // R)
    SP = -(-R * W // 16) * 16
    NE = -(-max((R + 2) * W, W + SP) // 16) * 16
    n_p = _parts(hd, SP, chunk // hd)
    cp = hd // n_p
    dx = torch.zeros(B, H, W, Cin if fold else C)
    da = torch.zeros(B, H, W, h9)
    zero = {k: torch.zeros(n) for k, n in (("dwp", C * C), ("dbp", C),
                                           ("dwv", Cin * C), ("dbv", C))}
    acc = [{k: v.clone() for k, v in zero.items()} for _ in range(blocks)]
    for t in range(B * per):
        blk = acc[t % blocks]
        b, r0 = t // per, (t % per) * R
        nr = min(R, H - r0)
        Sv = nr * W
        inside = torch.zeros(NE, dtype=torch.bool)

        def staged(src):
            """NE staged pixels of rows r0 - 1 ... : the image's, the rest
            zero-filled (or ``pad`` without the fill)."""
            fill = 0.0 if rules.zfill or pad is None else pad
            out = torch.full((NE, src.shape[-1]), fill)
            for k in range(R + 2):
                r = r0 - 1 + k
                if 0 <= r < H:
                    out[k * W:(k + 1) * W] = src[b, r]
                    inside[k * W:(k + 1) * W] = True
            return out

        xs, gs, as_ = staged(xf), staged(gf), staged(af)
        m = inside[:, None] if rules.mask else \
            torch.ones(NE, 1, dtype=torch.bool)
        if fold:
            v = torch.where(m, _mm16(xs, wv.float()) + bv.float(),
                            torch.zeros(()))
        else:
            v = xs
        dyag = torch.where(m, _mm16(gs, wpf.t()), torch.zeros(()))
        # the taps, from the staged rows with zero columns either side
        E = (R + 2) * W

        def cols(t2):
            return torch.nn.functional.pad(
                t2[:E].reshape(R + 2, W, -1), (0, 0, 1, 1))

        vp, dp, ap = cols(v), cols(dyag), cols(as_)
        y = torch.zeros(SP, C)
        dv = torch.zeros(SP, C)
        dat = torch.zeros(Sv, h9)
        for i in range(nr):
            own = ap[i + 1, 1:W + 1].reshape(W, heads, TAPS)
            d_own = dp[i + 1, 1:W + 1]
            yacc = torch.zeros(W, C)
            qacc = torch.zeros(W, C)
            nb = []
            for tap in range(TAPS):
                oy, ox = tap // 3 - 1, tap % 3 - 1
                vn = vp[i + 1 + oy, 1 + ox:1 + ox + W]
                nb.append(vn)
                w = own[:, :, tap].repeat_interleave(hd, dim=1)
                yacc = yacc + vn * w
                src = (slice(None),) + (i + 1 - oy, slice(1 - ox,
                                                          1 - ox + W))
                ds = dp[src[1], src[2]]
                wsrc = ap[src[1], src[2]].reshape(W, heads, TAPS)[:, :, tap]
                qacc = qacc + ds * wsrc.repeat_interleave(hd, dim=1)
            y[i * W:(i + 1) * W] = _bf(yacc)
            dv[i * W:(i + 1) * W] = qacc
            # da: fmaf over each part's channels in order, the parts' tree
            for h in range(heads):
                for tap in range(TAPS):
                    parts = []
                    for p in range(n_p):
                        s = torch.zeros(W)
                        for c in range(h * hd + p * cp, h * hd + (p + 1) * cp):
                            s = _fma(nb[tap][:, c], d_own[:, c], s)
                        parts.append(s)
                    dat[i * W:(i + 1) * W, h * TAPS + tap] = _tree(parts)
        rows_out = slice(r0, r0 + nr)
        da[b, rows_out] = _bf(dat).reshape(nr, W, h9)
        dvr = _bf(dv)
        # the weight grads: the block's running sums, 16 pixels a step
        gt, xt = gs[W:W + SP], xs[W:W + SP]
        dwp = blk["dwp"].reshape(C, C)
        for k in range(0, SP, 16):
            dwp = dwp + y[k:k + 16].t() @ gt[k:k + 16]
        blk["dwp"] = dwp.reshape(-1)
        blk["dbp"] = blk["dbp"] + _colsum(gt, Sv)
        if fold:
            dwv = blk["dwv"].reshape(Cin, C)
            for k in range(0, SP, 16):
                dwv = dwv + xt[k:k + 16].t() @ dvr[k:k + 16]
            blk["dwv"] = dwv.reshape(-1)
            blk["dbv"] = blk["dbv"] + _colsum(dv, SP)
            out = _bf(_mm16(dvr, wv.float().t()))
        else:
            out = dvr
        dx[b, rows_out] = out[:Sv].reshape(nr, W, -1)
    tot = {k: v.clone() for k, v in zero.items()}
    for blk in acc:  # the blocks' partials in block order
        tot = {k: tot[k] + blk[k] for k in tot}
    bf = torch.bfloat16
    dwp, dbp = tot["dwp"].reshape(C, C).to(bf), tot["dbp"].to(bf)
    if not fold:
        return dx.to(bf), da.to(bf), dwp, dbp
    return (dx.to(bf), da.to(bf), tot["dwv"].reshape(Cin, C).to(bf),
            tot["dbv"].to(bf), dwp, dbp)


def _inputs(B, H, W, Cin, C, heads, fold, seed):
    """bf16 (x or v, a, [wv, bv,] wp, g): a softmaxed over each head's
    taps."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    logits = n(B, H, W, heads, TAPS)
    a = torch.softmax(logits, -1).reshape(B, H, W, heads * TAPS)
    args = [n(B, H, W, Cin), a]
    if fold:
        args += [n(Cin, C) * Cin ** -0.5, 0.1 * n(C)]
    args += [n(C, C) * C ** -0.5, n(B, H, W, C)]
    return [t.to(torch.bfloat16) for t in args]


def _emulate(args, fold, rows, chunk, blocks, **kw):
    if fold:
        return emulate(*args, rows, chunk, blocks, **kw)
    v, a, wp, g = args
    return emulate(v, a, None, None, wp, g, rows, chunk, blocks, **kw)


def _reference(args, fold):
    fn = oa.outlook_branch_backward_reference if fold else \
        oa.outlook_agg_proj_backward_reference
    return fn(*args)


# (B, H, W, Cin, C, heads, rows, chunk, blocks, fold): a ragged last tile
# and padded pixel rows (C = 48: 7 rows in tiles of 3, 18 pixels a tile
# padded to 32); two channel chunks (C = 64); three chunks and 3 dW tiles a
# warp (C = 96); Cin != C (the fold)
EMULATED = [(2, 7, 6, 48, 48, 2, 3, 48, 4, fold) for fold in (False, True)] \
    + [(2, 8, 8, 64, 64, 2, 3, 32, 3, fold) for fold in (False, True)] \
    + [(1, 6, 8, 96, 96, 3, 2, 32, 2, fold) for fold in (False, True)] \
    + [(2, 5, 8, 32, 48, 2, 2, 48, 2, True)]


@pytest.mark.parametrize("B,H,W,Cin,C,heads,rows,chunk,blocks,fold",
                         EMULATED)
def test_emulated_mma_arithmetic_matches_the_plain_version(
        B, H, W, Cin, C, heads, rows, chunk, blocks, fold):
    assert oa._layout(W, Cin, C, heads, rows, chunk, fold) is not None
    args = _inputs(B, H, W, Cin, C, heads, fold, B + H + C)
    got = _emulate(args, fold, rows, chunk, blocks)
    want = _reference(args, fold)
    names = ("dx", "da", "dwv", "dbv", "dwp", "dbp") if fold else \
        ("dv", "da", "dwp", "dbp")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        if name in ("dx", "dv", "da"):
            assert (g == w).float().mean() >= 0.98, name
            scale = w.abs().amax(-1, keepdim=True)
            assert ((g - w).abs() <= 2.0 ** -7 * scale).all(), name
        else:
            assert (g - w).abs().max() <= 2.0 ** -7 * w.abs().max(), name


def _jax_grads(args, fold):
    """The JAX kernel's grads in interpret mode, bf16 (the output gradient
    is the last argument)."""
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args]
    *ins, jg = jargs
    ins.append(jnp.zeros((ins[-1].shape[0],), jnp.bfloat16))  # bp
    jfn = oap.outlook_branch_pallas if fold else \
        oap.outlook_attention_proj_pallas

    def loss(*a):
        return jnp.sum((jfn(*a) * jg).astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=tuple(range(len(ins))))(*ins)
    return [np.asarray(gr, np.float32) for gr in grads]


@pytest.mark.parametrize("fold", [False, True])
def test_emulated_mma_arithmetic_matches_the_jax_kernels(fold):
    B, H, W, C, heads = 2, 4, 8, 48, 2
    args = _inputs(B, H, W, C, C, heads, fold, 11)
    got = _emulate(args, fold, 3, 48, 2)
    want = _jax_grads(args, fold)
    assert len(want) == len(got)  # the same order: dx or dv, da, ..., dbp
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.float().numpy()
        if i == 0:  # dv / dx: one bf16 rounding, rarely
            differ = g != w
            assert differ.mean() < 0.01
            bound = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
            assert (np.abs(g - w)[differ] <= bound[differ]).all()
        else:  # da and the weight grads: sums
            assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max(), i


@pytest.mark.parametrize("fold,zfill,mask,garbage,same", [
    (True, True, True, 1e4, True),      # the kernel: zero-filled
    (False, True, True, 1e4, True),
    (True, True, True, float("nan"), True),
    (True, False, True, 1e4, True),     # the mask covers v and dyag
    (False, False, True, 1e4, False),   # v = x is garbage outside
    (True, False, True, float("nan"), False),  # 0 * NaN in dv's taps
    (True, True, False, 1e4, False),    # v = bv outside: the bias leaks
    (False, True, False, 1e4, True),    # nothing to mask without the fold
])
def test_padding_rule(fold, zfill, mask, garbage, same):
    # 7 rows in tiles of 3: the first tile's top halo row, the last tile's
    # two rows past the image and its bottom halo row, and the staged rows
    # past (R + 2) W lie outside the image
    B, H, W, C, heads = 1, 7, 6, 48, 2
    args = _inputs(B, H, W, C, C, heads, fold, 5)
    exact = _emulate(args, fold, 3, 48, 2)
    got = _emulate(args, fold, 3, 48, 2, rules=Rules(zfill, mask),
                   pad=garbage)
    assert all(torch.equal(g, w) for g, w in zip(got, exact)) == same
