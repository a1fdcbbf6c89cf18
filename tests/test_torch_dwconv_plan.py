"""The depthwise 3x3 backward's launch plan
(``outgridvit_tpu_torch/ops/dwconv.py:dwconv3x3_backward_plan``, the cut of
the CUDA kernel in ``csrc/dwconv.cu``), held at every MBConv depthwise shape
of every shipped config (``configs/*.yaml`` with a ``model:`` section, and
the 7M model at 48 px), at batch 128 and 1, in fp32 and bf16: its shared
memory fits the budget, the dw partials' bytes stay within 10% of the
launch's bytes for x, dy and dx, the bands and chunks cover every (pixel,
channel) once, and the grid has at least 132 blocks wherever the (band,
chunk) tiles allow that many. CPU only: the plan is Python.
"""

from pathlib import Path

import numpy as np
import pytest
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
        groups = p.chunk // dw.BWD_CV
        assert p.chunk % dw.BWD_CV == 0 and dw.BWD_THREADS % groups == 0, \
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
