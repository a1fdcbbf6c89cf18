"""The fused outlook projection's bf16 tensor-core forward,
``csrc/outlook_agg_fwd_mma.cu`` (TPU kernels #7
``outlook_attention_proj_pallas`` and #8 ``outlook_branch_pallas``,
forward half), checked on the CPU where it can be:

- Its launch plan (``ops/outlook_agg.py:outlook_agg_forward_plan``) at
  every outlooker shape of the shipped configs at batch 64 and 128 (the 7M
  model also at 48 and 96 px) and at the card tests' edge shapes (H != W, a
  ragged last tile, Cin != C): the tiles cover every image row and every
  pixel once, the blocks walk every tile once, the shared memory (recounted
  here from the layout) fits an H100 block, what one SM holds fits its
  registers and threads. Every outlooker of C <= 128 is taken in bf16
  (with the fold up to C = 192, without it up to 256); the refusals (fp32,
  C or Cin not a multiple of 16 such as the card test's Cin = 40, a head
  width not a multiple of 4, Wp and Wv that do not fit beside one tile)
  send the launch to the FMA kernel's entry, each with its reason.
- A PyTorch emulation of the kernel's arithmetic, tile by tile: bf16
  operands; v = x.Wv + bv summed in fp32 in k16 steps at every staged pixel
  (0 outside the image), never rounded; the taps in the plain version's
  order with each product rounded apart (a tap outside the image's columns
  adds the zero padding's +0); y rounded once; out = y.Wp summed in k16
  steps, plus bp, rounded once. At C = 48, 64 (two channel chunks) and 128
  (a C > 64 the plan takes, with a ragged last tile and Cin != C), against
  ``outlook_agg_proj_reference`` / ``outlook_branch_reference``: at least
  99% of out bitwise equal, every element within one bf16 rounding of the
  largest magnitude of its pixel's row (2^-7 of it: an fp32 sum taken in
  another order flips a rounding, of y or of out, of a value at most that
  large). Against JAX ``outlook_attention_proj_pallas`` /
  ``outlook_branch_pallas`` in interpret mode at the bf16 bars of
  ``tests/test_torch_outlook_agg.py:_assert_one_rounding``: fewer than 1%
  of out differ, each by at most one bf16 rounding.
- The padding rule: staged halo rows outside the image filled with large
  finite garbage, then zero-filled, give bitwise the result of exact zero
  padding; so does garbage that is not zero-filled where the v product's
  mask (v forced to 0 outside the image) covers it, NaN included; not v
  itself (no fold), and not the fold without the mask (v = bv would leak
  the bias).
"""

import sys
from pathlib import Path
from typing import NamedTuple

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
MMA, FMA = oa.FORWARD_ENTRIES


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
# (B, H, W, Cin, C, heads); the third with Cin = 48, a multiple of 16
EDGE = [(128, 32, 32, 64, 64, 2), (4, 64, 64, 64, 64, 2),
        (3, 13, 20, 48, 48, 2)]


def test_the_shapes_reach_every_shipped_outlooker():
    widths = {C for _, _, C, _ in SHAPES}
    assert widths == {48, 64, 80, 96, 128, 160, 192, 256, 320, 384, 448}
    assert (64, 32, 64, 2) in SHAPES     # Model B's front, serving batch
    assert (64, 64, 64, 2) in SHAPES     # Tiny-ImageNet stage 0
    assert (64, 96, 48, 2) in SHAPES     # the 7M model at 96 px


def _layout_bytes(W, Cin, C, heads, R, CH, fold):
    """The forward's shared memory, recounted from its layout: x (or v) of
    the tile's R rows and its two halo rows (to 16-row tiles), Wp and Wv,
    the y tile, the tap weights of the tile's rows, and fp32 v of one chunk
    at every staged pixel with a zero pixel either side of each row, the
    out tile over it; bf16 rows an odd number of 16-byte units apart, fp32
    pixels two floats past the chunk."""
    def row(cols):
        return 16 * ((cols // 8) | 1)

    def up16(n):
        return -(-n // 16) * 16

    ext, SP = (R + 2) * W, up16(R * W)
    return (up16(ext) * row(Cin) + C * row(C)
            + (Cin * row(C) if fold else 0) + SP * row(C)
            + up16(2 * R * W * TAPS * heads)
            + max(up16(4 * (R + 2) * (W + 2) * (CH + 2)), SP * row(C)))


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


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,H,C,heads", SHAPES)
def test_mma_plan_at_every_outlooker_shape(B, H, C, heads, fold):
    W = H
    got = oa._fit_forward(B, H, W, C, C, heads, fold)
    entry = oa.forward_entry(B, H, W, C, C, heads, fold, torch.bfloat16)
    # the weights resident beside one tile: Wv and Wp up to C = 192, Wp
    # alone up to C = 256
    assert isinstance(got, oa.OutlookFwdPlan) == (C <= (192 if fold
                                                        else 256)), got
    assert oa.forward_entry(B, H, W, C, C, heads, fold,
                            torch.float32) == FMA
    if isinstance(got, str):
        assert entry == FMA
        with pytest.raises(ValueError, match="no tile"):
            oa.outlook_agg_forward_plan(B, H, W, C, C, heads, fold)
        return
    assert entry == MMA
    assert oa.outlook_agg_forward_plan(B, H, W, C, C, heads, fold) is got
    _check_plan(got, B, H, W, C, C, heads, fold)


def test_mma_plan_at_model_b_front():
    # the 256 tiles of 8 rows (32 x 32 images, batch 64) over one block an
    # SM; at the train batch 512 of them
    for fold in (False, True):
        for B, tiles in ((64, 256), (128, 512)):
            p = oa.outlook_agg_forward_plan(B, 32, 32, 64, 64, 2, fold)
            assert (p.rows, p.chunk, p.tiles, p.blocks, p.threads) == \
                (8, 64, tiles, 132, 512)
            assert p.blocks_per_sm == 1


@pytest.mark.parametrize("B,H,W,Cin,C,heads", EDGE)
def test_mma_plan_at_the_card_tests_shapes(B, H, W, Cin, C, heads):
    for fold in (False, True):
        p = oa.outlook_agg_forward_plan(B, H, W, Cin, C, heads, fold)
        _check_plan(p, B, H, W, Cin, C, heads, fold)


@pytest.mark.parametrize("rows", [2, 3, 4, 5])
def test_mma_plan_with_a_ragged_last_tile_and_cin_not_c(rows):
    # 13 rows in tiles of 2-5 leave a last tile of 1-3 rows; Cin = 32 != C
    p = oa._fwd_plan(300, 13, 20, 32, 48, 2, True, rows, 48)
    assert 13 % p.rows
    _check_plan(p, 300, 13, 20, 32, 48, 2, True)
    p = oa.outlook_agg_forward_plan(2, 13, 20, 32, 48, 2, True)
    _check_plan(p, 2, 13, 20, 32, 48, 2, True)


@pytest.mark.parametrize("B,H,W,Cin,C,heads,fold,dtype,why", [
    (64, 32, 32, 64, 64, 2, True, torch.float32, "bf16 only"),
    (64, 32, 32, 64, 64, 2, False, torch.float32, "bf16 only"),
    (3, 13, 20, 40, 48, 2, True, torch.bfloat16, "multiples of 16"),
    (2, 8, 8, 24, 24, 2, False, torch.bfloat16, "multiples of 16"),
    (2, 8, 8, 48, 48, 16, True, torch.bfloat16, "multiple of 4"),
    (64, 4, 4, 256, 256, 8, True, torch.bfloat16, "Wp and Wv resident"),
    (64, 8, 8, 384, 384, 6, False, torch.bfloat16, "Wp resident"),
    (2, 2, 4096, 64, 64, 2, True, torch.bfloat16, "no tile"),
    (0, 8, 8, 64, 64, 2, True, torch.bfloat16, "empty"),
])
def test_mma_plan_refuses_what_the_kernel_does_not_take(B, H, W, Cin, C,
                                                        heads, fold, dtype,
                                                        why):
    with pytest.raises(ValueError, match=why):
        oa.outlook_agg_forward_plan(B, H, W, Cin, C, heads, fold, dtype)
    assert oa.forward_entry(B, H, W, Cin, C, heads, fold, dtype) == FMA


def test_the_forward_layout_query_refuses_what_the_kernel_does_not_take():
    ok = (32, 64, 64, 2, 8, 64, 1)
    assert oa._layout(*ok, forward=True) is not None
    for bad in ((32, 64, 64, 2, 8, 48, 1),    # chunk not dividing C
                (32, 64, 64, 2, 8, 16, 1),    # chunk not a multiple of hd
                (32, 48, 64, 2, 8, 64, 0),    # Cin != C without the fold
                (32, 64, 64, 2, 10, 64, 1),   # more than one block's smem
                (32, 40, 48, 2, 1, 48, 1),    # Cin not a multiple of 16
                (4, 256, 256, 8, 1, 256, 1),  # Wv and Wp: 270 KB
                (32, 64, 64, 2, 0, 64, 1)):   # no rows
        assert oa._layout(*bad, forward=True) is None, bad


def test_profile_step_names_the_forward_kernels_source():
    # profile_step.py attributes a traced kernel to the csrc/ file that
    # defines its __global__ function
    sys.path.insert(0, str(ROOT))
    import profile_step

    port = profile_step.port_kernels()
    assert port["outlook_fwd_mma"] == "csrc/outlook_agg_fwd_mma.cu"
    assert port["outlook_fwd"] == "csrc/outlook_agg.cu"


def test_the_forward_layout_is_the_backwards_without_its_gradients():
    # at Model B's front the backward takes 4 rows, the forward 8: the
    # forward holds no g, dyag, dv or da (123 KB of the backward's 232 KB
    # at 4 rows)
    bwd = oa._layout(32, 64, 64, 2, 4, 64, 1)
    fwd = oa._layout(32, 64, 64, 2, 4, 64, 1, forward=True)
    assert fwd[0] == bwd[0] == 512 and fwd[2] == bwd[2] == 128
    assert fwd[1] < 0.55 * bwd[1]
    assert oa._layout(32, 64, 64, 2, 8, 64, 1) is None
    assert oa._layout(32, 64, 64, 2, 8, 64, 1, forward=True) is not None


# ---- the kernel's arithmetic, emulated --------------------------------------

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


class Rules(NamedTuple):
    """The kernel's padding rules (both on: the kernel as written): staged
    rows outside the image zero-filled; v (the fold) forced to 0 there by
    the product's epilogue."""
    zfill: bool = True
    mask: bool = True


def emulate(x, a, wv, bv, wp, bp, rows, rules=Rules(), pad=None):
    """out of ``ogvt_outlook_agg_fwd_mma`` with tiles of ``rows`` rows,
    emulated in fp32 (bf16 values as fp32), bf16. ``wv`` None: #7 (x is v).
    ``pad``: what staged rows outside the image hold, a value (zeros by
    default); with ``rules.zfill`` the kernel zero-fills them whatever they
    hold. The channel chunks do not enter: each chunk's v and y are those
    columns of the whole."""
    fold = wv is not None
    B, H, W, Cin = x.shape
    C, heads = wp.shape[0], a.shape[-1] // TAPS
    hd, R = C // heads, rows
    xf, af = x.float(), a.float()
    per = -(-H // R)
    NE = -(-(R + 2) * W // 16) * 16
    out = torch.zeros(B, H, W, C)
    for t in range(B * per):
        b, r0 = t // per, (t % per) * R
        nr = min(R, H - r0)
        inside = torch.zeros(NE, dtype=torch.bool)
        fill = 0.0 if rules.zfill or pad is None else pad
        xs = torch.full((NE, Cin), fill)
        for k in range(R + 2):
            r = r0 - 1 + k
            if 0 <= r < H:
                xs[k * W:(k + 1) * W] = xf[b, r]
                inside[k * W:(k + 1) * W] = True
        if fold:
            m = inside[:, None] if rules.mask else \
                torch.ones(NE, 1, dtype=torch.bool)
            v = torch.where(m, _mm16(xs, wv.float()) + bv.float(),
                            torch.zeros(()))
        else:
            v = xs
        # the taps, from the staged rows with a zero pixel either side
        vp = torch.nn.functional.pad(v[:(R + 2) * W].reshape(R + 2, W, C),
                                     (0, 0, 1, 1))
        y = torch.zeros(nr * W, C)
        for i in range(nr):
            w = af[b, r0 + i].reshape(W, heads, TAPS)
            acc = torch.zeros(W, C)
            for tap in range(TAPS):
                oy, ox = tap // 3 - 1, tap % 3 - 1
                wt = w[:, :, tap].repeat_interleave(hd, dim=1)
                acc = acc + vp[i + 1 + oy, 1 + ox:1 + ox + W] * wt
            y[i * W:(i + 1) * W] = _bf(acc)
        o = _bf(_mm16(y, wp.float()) + bp.float())
        out[b, r0:r0 + nr] = o.reshape(nr, W, C)
    return out.to(torch.bfloat16)


def _inputs(B, H, W, Cin, C, heads, fold, seed):
    """bf16 (x or v, a, [wv, bv,] wp, bp): a softmaxed over each head's
    taps; biases large enough that a leak shows."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    a = torch.softmax(n(B, H, W, heads, TAPS), -1).reshape(B, H, W,
                                                           heads * TAPS)
    args = [n(B, H, W, Cin), a]
    if fold:
        args += [n(Cin, C) * Cin ** -0.5, 0.5 * n(C)]
    args += [n(C, C) * C ** -0.5, 0.1 * n(C)]
    return [t.to(torch.bfloat16) for t in args]


def _emulate(args, fold, rows, **kw):
    if fold:
        return emulate(*args, rows, **kw)
    v, a, wp, bp = args
    return emulate(v, a, None, None, wp, bp, rows, **kw)


def _reference(args, fold):
    fn = oa.outlook_branch_reference if fold else \
        oa.outlook_agg_proj_reference
    return fn(*args)


# (B, H, W, Cin, C, heads, rows, fold): padded pixel rows and a ragged last
# tile (C = 48: 7 rows in tiles of 3, 18 pixels a tile padded to 32); C =
# 64; C = 128 (hd 32, four heads; Cin = 96 != C with the fold)
EMULATED = [(2, 7, 6, 48, 48, 2, 3, fold) for fold in (False, True)] \
    + [(2, 8, 8, 64, 64, 2, 3, fold) for fold in (False, True)] \
    + [(1, 5, 8, 128, 128, 4, 2, False), (1, 5, 8, 96, 128, 4, 2, True)]


@pytest.mark.parametrize("B,H,W,Cin,C,heads,rows,fold", EMULATED)
def test_emulated_mma_arithmetic_matches_the_plain_version(
        B, H, W, Cin, C, heads, rows, fold):
    chunks = [ch for ch in range(C, 0, -16)
              if C % ch == 0 and ch % (C // heads) == 0]
    assert all(oa._layout(W, Cin, C, heads, rows, ch, fold, forward=True)
               for ch in chunks)
    args = _inputs(B, H, W, Cin, C, heads, fold, B + H + C)
    got = _emulate(args, fold, rows)
    want = _reference(args, fold)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (B, H, W, C)
    g, w = got.float(), want.float()
    assert (g == w).float().mean() >= 0.99
    scale = w.abs().amax(-1, keepdim=True)
    assert ((g - w).abs() <= 2.0 ** -7 * scale).all()


def _jax_out(args, fold):
    """The JAX kernel's bf16 out in interpret mode."""
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args]
    jfn = oap.outlook_branch_pallas if fold else \
        oap.outlook_attention_proj_pallas
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jfn(*jargs), np.float32)


@pytest.mark.parametrize("fold", [False, True])
def test_emulated_mma_arithmetic_matches_the_jax_kernels(fold):
    B, H, W, C, heads = 2, 4, 8, 48, 2
    args = _inputs(B, H, W, C, C, heads, fold, 11)
    got = _emulate(args, fold, 3).float().numpy()
    want = _jax_out(args, fold)
    # one bf16 rounding, rarely (an fp32 sum in another order)
    differ = got != want
    assert differ.mean() < 0.01
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want)[differ] <= bound[differ]).all()


@pytest.mark.parametrize("fold,zfill,mask,garbage,same", [
    (True, True, True, 1e4, True),      # the kernel: zero-filled
    (False, True, True, 1e4, True),
    (True, True, True, float("nan"), True),
    (True, False, True, 1e4, True),     # the mask covers v
    (True, False, True, float("nan"), True),
    (False, False, True, 1e4, False),   # v = x is garbage outside
    (True, True, False, 1e4, False),    # v = bv outside: the bias leaks
    (False, True, False, 1e4, True),    # nothing to mask without the fold
])
def test_padding_rule(fold, zfill, mask, garbage, same):
    # 7 rows in tiles of 3: the first tile's top halo row, the last tile's
    # two rows past the image and its bottom halo row, and the staged rows
    # past (R + 2) W lie outside the image
    B, H, W, C, heads = 1, 7, 6, 48, 2
    args = _inputs(B, H, W, C, C, heads, fold, 5)
    exact = _emulate(args, fold, 3)
    got = _emulate(args, fold, 3, rules=Rules(zfill, mask), pad=garbage)
    assert torch.equal(got, exact) == same
