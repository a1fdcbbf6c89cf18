"""The fused outlook softmax's bf16 row kernel,
``csrc/outlook_softmax_rows.cu`` (TPU kernel #9,
``outlook_attention_pallas``, at K = 3), checked on the CPU where it can be:

- Its launch plan (``ops/outlook_softmax.py:outlook_softmax_plan``) at
  every outlooker shape of the shipped configs at batch 64 and 128 (the 7M
  model also at 48 and 96 px) and at edge shapes (H != W, a ragged last
  tile, head widths 24 / 40 / 56, W = 4): the tiles cover every image row
  and pixel once, the blocks walk every tile once, each thread's items (a
  run of adjacent pixels of one 8-channel chunk) cover every output chunk
  of a tile once and its staging items every staged 16-byte chunk once,
  the shared memory (recounted here from the layout) fits an H100 block and
  what one SM holds fits its registers and threads. Every shipped
  outlooker is taken in bf16; fp32, K = 5, a head width that is not a
  multiple of 8 and layouts that do not fit go to ``ogvt_outlook_softmax``
  (``csrc/outlook_softmax.cu``), each with its reason.
- A PyTorch emulation of the kernel, tile by tile: v rows staged with a
  zero halo row outside the image and zero pixels at either end of each
  row (to the end of the last run), each (pixel, head) softmax once into
  fp32 probabilities, then each run's outputs from the three tap rows'
  P + 2 chunks in the kernel's order (ky, then chunk j, each chunk the tap
  kx = j - i of output i), each product and sum rounded apart in fp32,
  outputs past the row discarded. Bitwise
  ``outlook_softmax_agg_reference`` (fp32 arithmetic on bf16 inputs) at
  runs of 2 and 4 pixels and several tile heights, and within the bf16
  bar of ``tests/test_torch_outlook_softmax.py:_assert_one_rounding``
  (fewer than 1% of the outputs differ, each by at most one bf16 rounding)
  against JAX ``outlook_attention_pallas`` in interpret mode.
- The padding rule: staged buffers first filled with large finite garbage,
  then written as the kernel writes them, give bitwise the zero-padded
  result; probabilities past the tile's pixels (NaN here) reach no stored
  output.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.experimental import outlook_pallas as op
from outgridvit_tpu_torch.ops import outlook_softmax as osm

ROOT = Path(__file__).resolve().parents[1]
SM_SMEM = 228 * 1024       # shared memory of one H100 SM
BLOCK_SMEM = 227 * 1024    # the most one block may ask for
THREADS = 256
ROWS, OLD = osm.ENTRIES


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
# (B, H, W, C, heads): H != W with a ragged last tile (hd 24), hd 40 and
# 56, W = 4, and the card tests' shapes
EDGE = [(3, 13, 20, 48, 2), (2, 9, 7, 80, 2), (2, 11, 5, 112, 2),
        (5, 6, 4, 64, 2), (3, 5, 3, 16, 2), (128, 32, 32, 64, 2),
        (16, 64, 64, 64, 2)]


def test_the_shapes_reach_every_shipped_outlooker():
    widths = {C for _, _, C, _ in SHAPES}
    assert widths == {48, 64, 80, 96, 128, 160, 192, 256, 320, 384, 448}
    assert (64, 32, 64, 2) in SHAPES     # Model B's front, serving batch
    assert (64, 64, 64, 2) in SHAPES     # Tiny-ImageNet stage 0
    assert (64, 96, 48, 2) in SHAPES     # the 7M model at 96 px


def _layout_bytes(W, C, heads, R, P):
    """The kernel's shared memory, recounted from its layout: two buffers
    of R + 2 staged rows of runs * P + 2 pixels of C bf16 and of the
    logits of R rows (to 16 bytes), and the fp32 probabilities of R rows
    and P pixels more."""
    def up16(n):
        return -(-n // 16) * 16

    WP = -(-W // P) * P + 2
    return (2 * (R + 2) * WP * C * 2 + 2 * up16(R * W * 9 * heads * 2)
            + up16((R * W + P) * 9 * heads * 4))


def _walk(n_items, lo_radix):
    """The thread-by-thread walk of a kernel loop over items i = hi *
    lo_radix + lo, each thread advancing its digits by the block's thread
    count (``Walk`` in the kernel): the (hi, lo) pairs it visits."""
    seen = []
    dlo, dhi = THREADS % lo_radix, THREADS // lo_radix
    for tid in range(THREADS):
        lo, hi = tid % lo_radix, tid // lo_radix
        while hi * lo_radix + lo < n_items:
            seen.append((hi, lo))
            lo += dlo
            if lo >= lo_radix:
                lo -= lo_radix
                hi += 1
            hi += dhi
    return seen


def _tap_items(nr, runs, U):
    """The kernel's tap items of a tile of ``nr`` rows, walked as its
    threads walk them (chunk u, run k, row r digits, carried): the (r, k,
    u) visited."""
    seen = []
    dq = THREADS // U
    du, dk, dr = THREADS % U, dq % runs, dq // runs
    for tid in range(THREADS):
        q0 = tid // U
        u, k, r = tid % U, q0 % runs, q0 // runs
        while r < nr:
            seen.append((r, k, u))
            u += du
            carry = 0
            if u >= U:
                u -= U
                carry = 1
            k += dk + carry
            if k >= runs:
                k -= runs
                r += 1
            r += dr
    return seen


def _check_plan(p, B, H, W, C, heads):
    U, runs = C // 8, -(-W // p.pix)
    # the tiles cover every image row of every image once, and every pixel
    per = -(-H // p.rows)
    assert p.tiles == B * per
    covered = [r for t in range(per)
               for r in range(t * p.rows, min(H, (t + 1) * p.rows))]
    assert covered == list(range(H))
    # the blocks walk every tile once (t = b, b + blocks, ...)
    assert 1 <= p.blocks <= p.tiles
    walked = sorted(t for b in range(p.blocks)
                    for t in range(b, p.tiles, p.blocks))
    assert walked == list(range(p.tiles))
    # a full tile's and the ragged last tile's items: every (row, run,
    # chunk) once, so every pixel's chunk once (the runs' pixels past W are
    # discarded); every staged row's 16-byte chunks once
    for nr in {p.rows, H - (per - 1) * p.rows}:
        items = _tap_items(nr, runs, U)
        assert sorted(items) == [(r, k, u) for r in range(nr)
                                 for k in range(runs) for u in range(U)]
        pixels = sorted((r, k * p.pix + i, u) for r, k, u in items
                        for i in range(p.pix) if k * p.pix + i < W)
        assert pixels == [(r, x, u) for r in range(nr) for x in range(W)
                          for u in range(U)]
        staged = _walk((nr + 2) * W * U, W * U)
        assert sorted(staged) == [(e, w) for e in range(nr + 2)
                                  for w in range(W * U)]
    # one block's shared memory, and what one SM holds
    assert p.smem == _layout_bytes(W, C, heads, p.rows, p.pix)
    assert p.smem <= BLOCK_SMEM and p.threads == THREADS
    assert p.blocks_per_sm * (p.smem + 1024) <= SM_SMEM
    assert p.blocks_per_sm * p.threads * p.regs <= 65536
    assert p.blocks_per_sm * p.threads <= 2048
    assert p.blocks <= 132 * p.blocks_per_sm


@pytest.mark.parametrize("B,H,C,heads", SHAPES)
def test_plan_at_every_outlooker_shape(B, H, C, heads):
    p = osm.outlook_softmax_plan(B, H, H, C, heads)
    assert osm.softmax_entry(B, H, H, C, heads, 3, torch.bfloat16) == ROWS
    assert osm.outlook_softmax_plan(B, H, H, C, heads) is p  # cached
    _check_plan(p, B, H, H, C, heads)


@pytest.mark.parametrize("B,H,W,C,heads", EDGE)
def test_plan_at_edge_shapes(B, H, W, C, heads):
    p = osm.outlook_softmax_plan(B, H, W, C, heads)
    _check_plan(p, B, H, W, C, heads)
    for rows in (1, 2, 3, 4, 5):  # every layout the kernel takes
        for pix in osm.PIX_RUNS:
            q = osm._rows_plan(B, H, W, C, heads, rows, pix)
            if q is not None:
                _check_plan(q, B, H, W, C, heads)


@pytest.mark.parametrize("B,H,W,C,heads,k,dtype,why", [
    (64, 32, 32, 64, 2, 3, torch.float32, "bf16 only"),
    (64, 32, 32, 64, 2, 5, torch.bfloat16, "K = 3 only"),
    (3, 13, 20, 48, 2, 5, torch.bfloat16, "K = 3 only"),
    (2, 8, 8, 36, 3, 3, torch.bfloat16, "multiple of 8"),
    (2, 8, 8, 48, 4, 3, torch.bfloat16, "multiple of 8"),
    (2, 2, 4096, 64, 2, 3, torch.bfloat16, "no tile"),
    (0, 8, 8, 64, 2, 3, torch.bfloat16, "empty"),
])
def test_plan_refuses_what_the_kernel_does_not_take(B, H, W, C, heads, k,
                                                    dtype, why):
    with pytest.raises(ValueError, match=why):
        osm.outlook_softmax_plan(B, H, W, C, heads, k, dtype)
    assert osm.softmax_entry(B, H, W, C, heads, k, dtype) == OLD


def test_the_layout_query_refuses_what_the_kernel_does_not_take():
    assert osm._layout(32, 64, 2, 4, 4) is not None
    for bad in ((32, 64, 2, 4, 3),      # runs of 3 pixels
                (32, 64, 2, 4, 8),      # runs of 8 pixels
                (32, 48, 4, 4, 4),      # hd 12
                (32, 64, 2, 0, 4),      # no rows
                (32, 64, 2, 40, 4),     # more than one block's smem
                (0, 64, 2, 4, 4)):      # no pixels
        assert osm._layout(*bad) is None, bad


# ---- the kernel's arithmetic, emulated --------------------------------------

def _emulate(v, logits, heads, rows, pix, garbage=0.0):
    """The row kernel's out, tile by tile, in fp32 arithmetic on the bf16
    inputs: staged buffers first filled with ``garbage``, then written as
    the kernel writes them; probabilities past the tile's pixels NaN."""
    B, H, W, C = v.shape
    hd, runs = C // heads, -(-W // pix)
    WP = runs * pix + 2
    out = torch.empty_like(v)
    per = -(-H // rows)
    for t in range(B * per):
        b, r0 = t // per, (t % per) * rows
        nr = min(rows, H - r0)
        buf = torch.full((rows + 2, WP, C), garbage)
        buf[:, 0] = 0.0  # the zero pixels either end of each row
        buf[:, W + 1:] = 0.0
        for e in range(nr + 2):
            y = r0 - 1 + e
            buf[e, 1:W + 1] = v[b, y].float() if 0 <= y < H else 0.0
        lg = logits[b, r0:r0 + nr].float().reshape(nr * W, heads, 9)
        ex = torch.exp(lg - lg.amax(-1, keepdim=True))
        s = torch.zeros(nr * W, heads)
        for tp in range(9):
            s = s + ex[..., tp]
        pr = torch.full((rows * W + pix, heads, 9), float("nan"))
        pr[:nr * W] = ex / s[..., None]
        # every run's outputs at once: [rows of the tile, runs, P, C]
        acc = torch.zeros(nr, runs, pix, C)
        px = torch.arange(runs) * pix  # the runs' first pixels
        for ky in range(3):
            for j in range(pix + 2):
                chunk = buf[ky:ky + nr][:, px + j]  # [nr, runs, C]
                for i in range(pix):
                    kx = j - i
                    if not 0 <= kx <= 2:
                        continue
                    s_idx = (torch.arange(nr)[:, None] * W + px + i)
                    w = pr[s_idx][..., ky * 3 + kx]  # [nr, runs, heads]
                    acc[:, :, i] = acc[:, :, i] + chunk * \
                        w.repeat_interleave(hd, -1)
        y = acc.reshape(nr, runs * pix, C)[:, :W]
        out[b, r0:r0 + nr] = y.to(v.dtype)
    return out


def _inputs(B, H, W, C, heads, seed):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    logits = torch.from_numpy((2.0 * rng.normal(
        size=(B, H, W, heads * 9))).astype(np.float32))
    return v.bfloat16(), logits.bfloat16()


@pytest.mark.parametrize("B,H,W,C,heads,rows,pix", [
    (2, 8, 8, 64, 2, 3, 4),     # Model B's widths, a ragged last tile
    (2, 13, 10, 48, 2, 4, 4),   # hd 24, H != W, ragged runs (10 = 4+4+2)
    (1, 6, 9, 80, 2, 2, 4),     # hd 40, two runs of 4 and one ragged
    (1, 5, 7, 112, 2, 5, 2),    # hd 56, runs of 2, one tile
    (3, 4, 4, 32, 1, 1, 4),     # W = 4: one run a row
])
def test_emulation_is_bitwise_the_plain_version(B, H, W, C, heads, rows,
                                                pix):
    v, logits = _inputs(B, H, W, C, heads, B + H + W + C)
    got = _emulate(v, logits, heads, rows, pix)
    want = osm.outlook_softmax_agg_reference(v, logits, heads)
    assert torch.equal(got, want)
    # and at the plan's own layout
    p = osm.outlook_softmax_plan(B, H, W, C, heads)
    assert torch.equal(_emulate(v, logits, heads, p.rows, p.pix), want)


@pytest.mark.parametrize("B,H,W,C,heads", [(2, 8, 8, 64, 2),
                                           (2, 6, 10, 48, 2)])
def test_emulation_meets_the_bf16_bar_against_jax(B, H, W, C, heads):
    v, logits = _inputs(B, H, W, C, heads, 11 + C)
    p = osm.outlook_softmax_plan(B, H, W, C, heads)
    got = _emulate(v, logits, heads, p.rows, p.pix).float().numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(op.outlook_attention_pallas(
            jnp.asarray(v.float().numpy(), jnp.bfloat16),
            jnp.asarray(logits.float().numpy(), jnp.bfloat16), heads, 3),
            np.float32)
    differ = got != want
    assert differ.mean() < 0.01, differ.mean()
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want)[differ] <= bound[differ]).all()


@pytest.mark.parametrize("pix", osm.PIX_RUNS)
def test_garbage_in_the_staged_buffers_reaches_no_output(pix):
    # halo rows outside the image, the zero pixels and the rows past a
    # ragged tile first hold 1e30, then are written as the kernel writes
    # them: bitwise the zero-padded result
    v, logits = _inputs(2, 7, 6, 32, 2, pix)
    want = osm.outlook_softmax_agg_reference(v, logits, 2)
    got = _emulate(v, logits, 2, 3, pix, garbage=1e30)
    assert torch.equal(got, want)
