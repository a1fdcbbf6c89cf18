"""The depthwise 3x3's launch plans
(``outgridvit_tpu_torch/ops/dwconv.py:dwconv3x3_forward_plan`` and
``dwconv3x3_backward_plan``, the cuts of the CUDA kernel in
``csrc/dwconv.cu``), held at every MBConv depthwise shape of every shipped
config (``configs/*.yaml`` with a ``model:`` section, and the 7M model at 48
px; the forward also at 96 px, the widest rows), in fp32 and bf16: the
backward at batch 128 and 1, the forward at 128, 64 and 1. Their shared
memory fits the budget (the forward's lets three blocks share an SM), the
dw partials' bytes stay within 10% of the launch's bytes for x, dy and dx,
the bands and chunks cover every (pixel, channel) once, and the grid has at
least 132 blocks wherever the (band, chunk) tiles allow that many, the
forward's at most one wave of three blocks an SM. At ragged shapes a walk of
the forward kernel's blocks, stages and thread items in Python (its halo
tiles zero-filled as ``load_stage`` fills them, its taps as ``tap_row``
sums them) writes every output once and equals the plain version bit for
bit. CPU only: the plans are Python.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from outgridvit_tpu_torch.ops import dwconv as dw

CONFIGS = sorted(p for p in (Path(__file__).resolve().parents[1]
                             / "configs").glob("*.yaml")
                 if "model" in yaml.safe_load(p.read_text()))
ITEMSIZE = {"f32": 4, "bf16": 2}
SMS = 132


def _shapes(path: Path, img: int):
    """(H = W, mid) of each stage's MBConv depthwise at ``img`` px."""
    cfg = yaml.safe_load(path.read_text())
    out = []
    for si, s in enumerate(cfg["model"]["stages"]):
        if not s.get("use_mbconv", True):
            continue
        mid = max(1, int(round(s["dim"] * s.get("mbconv_expand_ratio", 4.0))))
        out.append((img >> si, mid))
    return out


def _cases():
    for path in CONFIGS:
        img = yaml.safe_load(path.read_text())["data"]["img_size"]
        yield pytest.param(path, img, id=f"{path.stem}-{img}px")
    seven = next(p for p in CONFIGS if p.stem == "cifar100_model_a_7m")
    yield pytest.param(seven, 48, id="cifar100_model_a_7m-48px")


def _forward_cases():
    yield from _cases()
    seven = next(p for p in CONFIGS if p.stem == "cifar100_model_a_7m")
    yield pytest.param(seven, 96, id="cifar100_model_a_7m-96px")


def _covers_once(plan, B, H):
    """Times each image row is written: stages split among the parts, bands
    among the stages, rows among the bands."""
    nb = -(-H // plan.rows)
    nsub = B * nb
    assert plan.stages == -(-nsub // plan.bands)
    count = np.zeros((B, H), np.int64)
    for part in range(plan.parts):
        lo = plan.stages * part // plan.parts
        hi = plan.stages * (part + 1) // plan.parts
        assert hi > lo, "a block with no stage"
        for st in range(lo, hi):
            for sb in range(st * plan.bands,
                            min(nsub, (st + 1) * plan.bands)):
                row0 = (sb % nb) * plan.rows
                count[sb // nb, row0:row0 + plan.rows] += 1
    return count


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("path,img", list(_cases()))
def test_backward_plan_at_every_shipped_shape(path, img, batch, dtype):
    itemsize = ITEMSIZE[dtype]
    for H, C in _shapes(path, img):
        W = H
        p = dw.dwconv3x3_backward_plan(batch, H, W, C, itemsize)
        where = (path.stem, img, batch, dtype, H, C, p)
        # what the kernel takes (csrc/dwconv.cu: bwd_geom)
        groups = p.chunk // dw.CV
        assert p.chunk % dw.CV == 0 and dw.THREADS % groups == 0, \
            where
        assert 1 <= p.rows <= H and 1 <= p.parts <= p.stages, where
        if C % (16 // itemsize) == 0:  # the 16-byte copies need it
            assert p.chunk % (16 // itemsize) == 0, where
        # shared memory
        assert p.smem_bytes == dw.bwd_smem_bytes(W, p.rows, p.chunk, p.bands,
                                                 itemsize), where
        # the budget, within what one H100 block may ask for
        assert p.smem_bytes <= dw.BWD_SMEM_BUDGET <= 232_448, where
        # dw partials: written once, read once
        launch = 3 * batch * H * W * C * itemsize
        partials = p.workspace_floats * 4 * 2
        assert p.workspace_floats == (9 * C * p.parts if p.parts > 1 else 0)
        assert partials <= 0.10 * launch, (where, partials / launch)
        # every (pixel, channel) once: rows by bands, channels by chunks
        assert (_covers_once(p, batch, H) == 1).all(), where
        assert p.chunks == -(-C // p.chunk) and \
            (p.chunks - 1) * p.chunk < C <= p.chunks * p.chunk, where
        # enough blocks to fill the card where the tiles allow it
        units = batch * H * W * C / (p.rows * W * p.chunk)
        if units >= SMS:
            assert p.blocks >= SMS, (where, units)


@pytest.mark.parametrize("B,H,W,C,itemsize", [
    (2, 13, 9, 64, 2),     # H not a multiple of the rows
    (3, 5, 7, 20, 4),      # C not a multiple of the copy width
    (1, 1, 1, 1, 2),       # one pixel, one channel
    (2, 6, 100, 5, 4),     # W != H, odd C
])
def test_backward_plan_covers_ragged_shapes(B, H, W, C, itemsize):
    p = dw.dwconv3x3_backward_plan(B, H, W, C, itemsize)
    assert (_covers_once(p, B, H) == 1).all()
    assert p.chunks * p.chunk >= C and p.smem_bytes <= dw.BWD_SMEM_BUDGET
    assert p.workspace_floats * 8 <= 0.10 * 3 * B * H * W * C * itemsize


def test_backward_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError, match="fits"):
        dw.dwconv3x3_backward_plan(1, 4, 5000, 64, 4)
    with pytest.raises(ValueError, match="empty"):
        dw.dwconv3x3_backward_plan(0, 4, 4, 64, 2)


def _forward_covers_once(plan, B, H, W):
    """Times each output pixel is written: stages split among the parts,
    bands among the stages, each band rows x tw pixels of one image (the
    column tile fastest)."""
    nbr, ntw = -(-H // plan.rows), -(-W // plan.tw)
    nsub = B * nbr * ntw
    assert plan.stages == -(-nsub // plan.bands)
    count = np.zeros((B, H, W), np.int64)
    for part in range(plan.parts):
        lo = plan.stages * part // plan.parts
        hi = plan.stages * (part + 1) // plan.parts
        assert hi > lo, "a block with no stage"
        for sb in range(lo * plan.bands, min(nsub, hi * plan.bands)):
            b, bi = divmod(sb, nbr * ntw)
            rb, cb = divmod(bi, ntw)
            count[b, rb * plan.rows:(rb + 1) * plan.rows,
                  cb * plan.tw:(cb + 1) * plan.tw] += 1
    return count


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [128, 64, 1])
@pytest.mark.parametrize("path,img", list(_forward_cases()))
def test_forward_plan_at_every_shipped_shape(path, img, batch, dtype):
    itemsize = ITEMSIZE[dtype]
    for H, C in _shapes(path, img):
        W = H
        p = dw.dwconv3x3_forward_plan(batch, H, W, C, itemsize)
        where = (path.stem, img, batch, dtype, H, C, p)
        # what the kernel takes (csrc/dwconv.cu: make_geom)
        groups = p.chunk // dw.CV
        assert p.chunk % dw.CV == 0 and dw.THREADS % groups == 0, where
        assert 1 <= p.rows <= min(H, dw.MAX_ROWS) and 1 <= p.tw <= W, where
        assert 1 <= p.parts <= min(p.stages, 65535), where
        if C % (16 // itemsize) == 0:  # the 16-byte copies need it
            assert p.chunk % (16 // itemsize) == 0, where
        # a block reads at least 64 bytes of a pixel where C allows
        assert p.chunk * itemsize >= min(64, -(-C // 2) * 2 * itemsize), \
            where
        # shared memory: two buffers of halo tiles, two blocks an SM
        assert p.smem_bytes == dw.fwd_smem_bytes(p.tw, p.rows, p.chunk,
                                                 p.bands, itemsize), where
        assert p.smem_bytes <= dw.FWD_SMEM_BUDGET, where
        per_sm = min(dw.FWD_BLOCKS_PER_SM,
                     dw.SMEM_PER_SM // (p.smem_bytes + 1024))
        assert per_sm >= 2, where
        # every (pixel, channel) once: pixels by bands, channels by chunks
        assert (_forward_covers_once(p, batch, H, W) == 1).all(), where
        assert p.chunks == -(-C // p.chunk) and \
            (p.chunks - 1) * p.chunk < C <= p.chunks * p.chunk, where
        # one wave at most, and enough blocks to fill the card where the
        # tiles allow it
        assert p.blocks <= per_sm * SMS, where
        units = batch * H * W * C / (p.rows * p.tw * p.chunk)
        if units >= SMS:
            assert p.blocks >= SMS, (where, units)


def _walk_forward(plan, x, w9):
    """The forward kernel's blocks, stages and threads in Python, on float32
    numpy inputs: each block's halo tiles as ``load_stage`` fills them
    (zeros outside the image, past C and past the last band), each thread's
    items as ``compute_stage`` steps through them (column j + step,
    wrapping into the next band), the taps as ``tap_row`` sums them. Returns
    y and how often each output was written."""
    B, H, W, C = x.shape
    rows, tw, chunk = plan.rows, plan.tw, plan.chunk
    nbr, ntw = -(-H // rows), -(-W // tw)
    nb = nbr * ntw
    nsub = B * nb
    groups = chunk // dw.CV
    step = dw.THREADS // groups
    y = np.zeros_like(x)
    count = np.zeros(x.shape, np.int64)

    def band(sb):  # image, first row, first column
        b, bi = divmod(sb, nb)
        rb, cb = divmod(bi, ntw)
        return b, rb * rows, cb * tw

    for c0 in range(0, plan.chunks * chunk, chunk):
        for part in range(plan.parts):
            lo = plan.stages * part // plan.parts
            hi = plan.stages * (part + 1) // plan.parts
            for st in range(lo, hi):
                tile = np.zeros((plan.bands, rows + 2, tw + 2, chunk),
                                np.float32)
                for s in range(plan.bands):
                    if st * plan.bands + s >= nsub:
                        continue
                    b, row0, col0 = band(st * plan.bands + s)
                    for tr in range(rows + 2):
                        for tc in range(tw + 2):
                            row, col = row0 + tr - 1, col0 + tc - 1
                            if 0 <= row < H and 0 <= col < W:
                                piece = x[b, row, col, c0:c0 + chunk]
                                tile[s, tr, tc, :piece.size] = piece
                for t in range(dw.THREADS):
                    c = c0 + (t % groups) * dw.CV
                    s, j = divmod(t // groups, tw)
                    while s < plan.bands and st * plan.bands + s < nsub:
                        b, row0, col0 = band(st * plan.bands + s)
                        for r in range(min(rows, H - row0)
                                       if col0 + j < W else 0):
                            for k in range(dw.CV):
                                if c + k >= C:
                                    continue
                                acc = np.float32(0)
                                for tap, (oy, ox) in enumerate(dw.OFFS):
                                    acc = np.float32(acc + np.float32(
                                        tile[s, r + 1 + oy, j + 1 + ox,
                                             c + k - c0] * w9[tap, c + k]))
                                y[b, row0 + r, col0 + j, c + k] = acc
                                count[b, row0 + r, col0 + j, c + k] += 1
                        j += step
                        while j >= tw:
                            j -= tw
                            s += 1
    return y, count


@pytest.mark.parametrize("B,H,W,C,itemsize", [
    (2, 13, 9, 64, 2),     # H not a multiple of the rows
    (3, 5, 7, 20, 4),      # C not a multiple of the copy width
    (3, 5, 7, 20, 2),      # ... and a chunk wider than C
    (1, 1, 1, 1, 2),       # one pixel, one channel
    (2, 6, 100, 5, 4),     # W != H, odd C, bands narrower than W
    (3, 40, 4, 6, 2),      # H past MAX_ROWS: three bands an image
    (1, 20, 37, 64, 2),    # W not a multiple of the band width
])
def test_forward_plan_walk_covers_each_output_once(B, H, W, C, itemsize):
    p = dw.dwconv3x3_forward_plan(B, H, W, C, itemsize)
    assert p.chunks * p.chunk >= C and p.smem_bytes <= dw.FWD_SMEM_BUDGET
    rng = np.random.default_rng(B + H + W + C)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w9 = (rng.normal(size=(9, C)) / 3).astype(np.float32)
    y, count = _walk_forward(p, x, w9)
    assert (count == 1).all()
    want = dw.dwconv3x3_reference(torch.from_numpy(x), torch.from_numpy(w9))
    assert np.array_equal(y, want.numpy())


def test_forward_plan_refuses_what_no_tile_fits():
    # every tiling of so many images has 2**31 bands or more (ints in the
    # kernel)
    with pytest.raises(ValueError, match=r"\(16777216, 4096, 8, 64\).*fits"):
        dw.dwconv3x3_forward_plan(1 << 24, 4096, 8, 64, 4)
    with pytest.raises(ValueError, match="empty"):
        dw.dwconv3x3_forward_plan(2, 0, 4, 64, 2)
