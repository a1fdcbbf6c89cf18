"""CUDA kernels of outgridvit_tpu_torch (forward and backward) against their
plain PyTorch versions on the card, at edge shapes the Model A paths do not
reach (odd token and channel counts, N=1, C not a multiple of 32, a ragged
last token tile, a hidden width that is not a multiple of the 64-unit chunk,
a grid whose staging needs more than 48 KB of shared memory) and at the full
Tiny-ImageNet-200 stage shapes (train batch 128: the fused attention branch
at N=64, the head-chunked grid shapes at C=128/256/384, the row-layout MLP
shapes at M=524,288), the head-chunked grid kernel
(``csrc/grid_mhsa_th.cu``) also at the default Model A's shapes (C =
160/320/448), at G = 1 and 3, at every head width it takes, through its own
entry points in bf16, and its refusals (a pointer off 16 bytes, N != 16, hd
not a multiple of 8 up to 64), the fused outlook kernels (#7, #8) at a Model
B front shape, a 64 x 64 shape and an hd=24 shape with H != W and a ragged
last tile, the fused outlook softmax (#9) and the depthwise kernels (#10,
#11) at one shape of each configuration and at edge shapes (K = 5, hd = 24,
C not a multiple of the vector width), plus tiny models (Model A, Model B in
the fused outlook modes, Model B with the depthwise mode "t" and Model A
with "bwd") through the kernels against the plain path, forward and one
train step; the fused outlook projection's bf16 tensor-core forward
(``csrc/outlook_agg_fwd_mma.cu``) at the outlook shapes above and the
``chip_smoke.py`` shapes of C <= 128, two calls bitwise equal, at least 90%
bitwise the plain version, every layout of its plan bitwise the plan's, both
kernels on request, its refusals (fp32, a pointer off 16 bytes) and the FMA
kernel for fp32, Cin = 40 and the widths whose weights do not fit, and a
bf16 Model B forward and train step in both fused modes on it; the
block-packed grid core (#6) at the 48 px 7M stage-0 shapes (serving and
train batch) and edge shapes (N = 1, 17, 63; hd = 56, 64), its bf16 kernel
(``csrc/grid_mhsa_packed_mma.cu``) at N = 17, 33, 48, 49, 63 times hd = 8,
24, 56, 64 through its own entry points (fp32 through
``csrc/grid_mhsa_packed.cu``'s) and its refusal of hd = 12, the NHWC fused
branch (#12) at the default Model A stage-0 shape and rectangular maps,
against its plain version and bit for bit against partition -> #5 ->
unpartition, tiny models through both, and ``model.use_pallas: false``,
which launches no kernel; the fused branch's bf16 tensor-core forward
(``csrc/attn_branch_mma.cu``) at the Tiny-ImageNet and default Model A
stage-0 shapes, one grid and a rectangular map, two calls bitwise equal,
#12's y bitwise #5's on the partitioned tokens, both kernels on request, its
refusals (a pointer off 16 bytes, a plan or shape it does not take) and the
FMA kernel for fp32 and other shapes; the MLP forward's and backward's bf16
tensor-core kernels (``csrc/mlp_branch_mma.cu``,
``csrc/mlp_branch_bwd_mma.cu``) at a ragged tile, the row-layout tag, the
widest C and a 5-token launch without LN (the forward also at the
Tiny-ImageNet stage 0 and in every layout it takes at five shapes), with the
entry point each launch took (fp32 and H = 100 keep ``csrc/mlp_branch.cu``
and ``csrc/mlp_branch_bwd.cu``), both kernels on request and the tensor-core
entries' refusals; the training entry point: the eval graph, the
prefetcher, ``train_model`` on the kernels, and the train superstep's CUDA
graph (K replayed steps bitwise K eager ones, a graph per input shape,
``train_model`` at K = 2 bitwise K = 1).

Marked ``cuda``: skips without a card. Imports no JAX, so it also runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: |kernel - plain| <= tol * (1 + |plain|),
tol 1e-4 in fp32 (summation order), 2e-2 in bf16 (one bf16 ulp), for
activations and their gradients; parameter gradients (sums over all tokens)
|kernel - plain| <= tol * max|plain| with the same tol.
"""

import pytest
import torch

from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.models.blocks import MultiHeadSelfAttention
from outgridvit_tpu_torch.models.layers import DropPath, LayerNorm
from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.attn_branch import (
    attn_branch,
    attn_branch_backward,
    attn_branch_backward_reference,
    attn_branch_nhwc,
    attn_branch_nhwc_backward,
    attn_branch_nhwc_backward_reference,
    attn_branch_nhwc_reference,
    attn_branch_reference,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.dwconv import (
    dwconv3x3,
    dwconv3x3_backward,
    dwconv3x3_backward_reference,
    dwconv3x3_forward_plan,
    dwconv3x3_reference,
)
from outgridvit_tpu_torch.ops.grid import grid_partition, grid_unpartition
from outgridvit_tpu_torch.ops.grid_attention import (
    grid_mhsa,
    grid_mhsa_backward,
    grid_mhsa_backward_reference,
    grid_mhsa_packed,
    grid_mhsa_packed_backward,
    grid_mhsa_packed_backward_reference,
    grid_mhsa_packed_reference,
    grid_mhsa_reference,
)
from outgridvit_tpu_torch.ops import attn_branch as attn_branch_mod
from outgridvit_tpu_torch.ops import grid_attention as grid_attention_mod
from outgridvit_tpu_torch.ops import mlp_branch as mlp_branch_mod
from outgridvit_tpu_torch.ops import outlook_agg as outlook_agg_mod
from outgridvit_tpu_torch.ops import outlook_softmax as outlook_softmax_mod
from outgridvit_tpu_torch.ops.mlp_branch import (
    mlp_branch,
    mlp_branch_backward,
    mlp_branch_backward_reference,
    mlp_branch_reference,
)
from outgridvit_tpu_torch.ops.outlook_agg import (
    outlook_agg_proj,
    outlook_agg_proj_backward,
    outlook_agg_proj_backward_reference,
    outlook_agg_proj_reference,
    outlook_branch,
    outlook_branch_backward,
    outlook_branch_backward_reference,
    outlook_branch_reference,
)
from outgridvit_tpu_torch.ops.outlook_softmax import (
    outlook_softmax_agg,
    outlook_softmax_agg_reference,
)
from outgridvit_tpu_torch.training.optim import AdamW
from outgridvit_tpu_torch.training.steps import (
    StepConfig,
    StepDraws,
    make_train_step,
    sample_step_draws,
)
from outgridvit_tpu_torch.training.train_state import TrainState

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= TOL[dtype] * (1 + want.float().abs())).all()), \
        f"max abs err {diff.max().item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,C,heads", [
    (5, 1, 8, 1), (7, 9, 36, 3), (3, 16, 40, 5), (2, 16, 512, 8)])
def test_grid_mhsa_kernel_matches_plain(dev, dtype, G, N, C, heads):
    g = torch.Generator().manual_seed(G * N + C)
    qkv = torch.randn(G, N, 3 * C, generator=g).to(dev, dtype)
    n = grid_mhsa.launches
    got = grid_mhsa(qkv, heads)
    torch.cuda.synchronize()
    assert grid_mhsa.launches == n + 1
    _assert_close(got, grid_mhsa_reference(qkv, heads), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("M,C,H,apply_ln", [
    (37, 48, 100, True), (5, 320, 640, False), (300, 7, 28, True)])
def test_mlp_branch_kernel_matches_plain(dev, dtype, act, M, C, H, apply_ln):
    g = torch.Generator().manual_seed(M + C + H)

    def r(*shape, s=1.0, b=0.0):
        return torch.randn(*shape, generator=g) * s + b

    args = (r(M, C).to(dev, dtype), r(C, s=0.1, b=1.0).to(dev),
            r(C, s=0.1).to(dev), r(C, H, s=C ** -0.5).to(dev, dtype),
            r(H, s=0.02).to(dev, dtype), r(H, C, s=H ** -0.5).to(dev, dtype),
            r(C, s=0.02).to(dev, dtype))
    got = mlp_branch(*args, act, 1e-5, apply_ln)
    torch.cuda.synchronize()
    _assert_close(got, mlp_branch_reference(*args, act, 1e-5, apply_ln),
                  dtype)


def _assert_close_to_max(got, want, dtype, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= TOL[dtype] * max(scale, 1e-30), f"{name}: {err} vs {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,C,heads", [
    (5, 1, 8, 1), (7, 9, 36, 3), (3, 16, 40, 5), (2, 16, 512, 8)])
def test_grid_mhsa_backward_kernel_matches_plain(dev, dtype, G, N, C, heads):
    g = torch.Generator().manual_seed(G * N + C + 1)
    qkv = torch.randn(G, N, 3 * C, generator=g).to(dev, dtype)
    dout = torch.randn(G, N, C, generator=g).to(dev, dtype)
    n = grid_mhsa_backward.launches
    got = grid_mhsa_backward(qkv, dout, heads)
    again = grid_mhsa_backward(qkv, dout, heads)
    torch.cuda.synchronize()
    assert grid_mhsa_backward.launches == n + 2
    assert torch.equal(got, again)
    _assert_close(got, grid_mhsa_backward_reference(qkv, dout, heads), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("M,C,H,apply_ln", [
    (37, 48, 100, True), (5, 320, 640, False), (300, 7, 28, True),
    (1000, 40, 100, False)])
def test_mlp_branch_backward_kernel_matches_plain(dev, dtype, act, M, C, H,
                                                  apply_ln):
    g = torch.Generator().manual_seed(M + C + H + 1)

    def r(*shape, s=1.0, b=0.0):
        return torch.randn(*shape, generator=g) * s + b

    args = (r(M, C).to(dev, dtype), r(C, s=0.1, b=1.0).to(dev),
            r(C, s=0.1).to(dev), r(C, H, s=C ** -0.5).to(dev, dtype),
            r(H, s=0.02).to(dev, dtype), r(H, C, s=H ** -0.5).to(dev, dtype),
            r(C, s=0.02).to(dev, dtype))
    dy = r(M, C).to(dev, dtype)
    n = mlp_branch_backward.launches
    got = mlp_branch_backward(*args, dy, act, 1e-5, apply_ln)
    again = mlp_branch_backward(*args, dy, act, 1e-5, apply_ln)
    torch.cuda.synchronize()
    assert mlp_branch_backward.launches == n + 2
    want = mlp_branch_backward_reference(*args, dy, act, 1e-5, apply_ln)
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for name, a, b, w in zip(names, got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        elif not apply_ln and name.startswith("dln"):
            assert not a.any(), name
        else:
            _assert_close_to_max(a, w, dtype, name)


def _mlp_args(g, M, C, H, dev, dtype, dy_scale=1.0):
    def r(*shape, s=1.0, b=0.0):
        return torch.randn(*shape, generator=g) * s + b

    return ((r(M, C).to(dev, dtype), r(C, s=0.1, b=1.0).to(dev),
             r(C, s=0.1).to(dev), r(C, H, s=C ** -0.5).to(dev, dtype),
             r(H, s=0.02).to(dev, dtype), r(H, C, s=H ** -0.5).to(dev, dtype),
             r(C, s=0.02).to(dev, dtype)),
            r(M, C, s=dy_scale).to(dev, dtype))


def _mlp_entries():
    return dict(mlp_branch_backward.by_entry)


def _entry_delta(before):
    return {k: v - before.get(k, 0)
            for k, v in mlp_branch_backward.by_entry.items()
            if v - before.get(k, 0)}


def _check_mlp_grads(got, again, want, dtype, apply_ln):
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for name, a, b, w in zip(names, got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        elif not apply_ln and name.startswith("dln"):
            assert not a.any(), name
        else:
            _assert_close_to_max(a, w, dtype, name)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("M,C,H,apply_ln,variant", [
    (37, 48, 96, True, "t"),         # one ragged tile, H past one chunk
    (1000, 64, 256, True, "row"),    # the row-layout kernel's tag (#4)
    (300, 448, 1792, True, "t"),     # the widest C: 4 warps a row tile
    (5, 320, 640, False, "t")])      # 5 tokens, no LN
def test_mlp_branch_backward_mma_matches_plain(dev, act, M, C, H, apply_ln,
                                               variant):
    # bf16 launches whose C and H are multiples of 16 take the tensor-core
    # kernel, csrc/mlp_branch_bwd_mma.cu
    args, dy = _mlp_args(torch.Generator().manual_seed(M + C + H), M, C, H,
                         dev, torch.bfloat16)
    before = _mlp_entries()
    n = mlp_branch_backward.by_variant[variant]
    got = mlp_branch_backward(*args, dy, act, 1e-5, apply_ln, variant)
    again = mlp_branch_backward(*args, dy, act, 1e-5, apply_ln, variant)
    torch.cuda.synchronize()
    assert _entry_delta(before) == {"ogvt_mlp_branch_bwd_mma": 2}
    assert mlp_branch_backward.by_variant[variant] == n + 2
    want = mlp_branch_backward_reference(*args, dy, act, 1e-5, apply_ln)
    _check_mlp_grads(got, again, want, torch.bfloat16, apply_ln)


@pytest.mark.parametrize("dtype,H", [(torch.float32, 256),
                                     (torch.bfloat16, 100)])
def test_mlp_branch_backward_takes_the_fma_kernel_where_mma_does_not(
        dev, dtype, H):
    # fp32, and bf16 at H = 100 (not a multiple of 16): csrc/mlp_branch_bwd.cu
    M, C = 70, 48
    args, dy = _mlp_args(torch.Generator().manual_seed(H), M, C, H, dev,
                         dtype)
    before = _mlp_entries()
    got = mlp_branch_backward(*args, dy, "gelu", 1e-5, True)
    again = mlp_branch_backward(*args, dy, "gelu", 1e-5, True)
    torch.cuda.synchronize()
    assert _entry_delta(before) == {"ogvt_mlp_branch_bwd": 2}
    want = mlp_branch_backward_reference(*args, dy, "gelu", 1e-5, True)
    _check_mlp_grads(got, again, want, dtype, True)


def test_mlp_branch_backward_entries_on_request(dev):
    # the A/B of chip_smoke.py: either kernel at a shape both take, each
    # against the plain version; the mma entry refuses fp32 by name
    launch = mlp_branch_mod._launch_backward
    args, dy = _mlp_args(torch.Generator().manual_seed(5), 200, 64, 128, dev,
                         torch.bfloat16)
    want = mlp_branch_backward_reference(*args, dy, "silu", 1e-5, True)
    for entry in ("ogvt_mlp_branch_bwd", "ogvt_mlp_branch_bwd_mma"):
        before = _mlp_entries()
        got = launch(entry, *args, dy, "silu", 1e-5, True, "t")
        again = launch(entry, *args, dy, "silu", 1e-5, True, "t")
        torch.cuda.synchronize()
        assert _entry_delta(before) == {entry: 2}
        _check_mlp_grads(got, again, want, torch.bfloat16, True)
    f32 = tuple(t.float() for t in args)
    with pytest.raises(ValueError, match="M=200, C=64, H=128"):
        launch("ogvt_mlp_branch_bwd_mma", *f32, dy.float(), "silu", 1e-5,
               True, "t")
    with pytest.raises(ValueError, match="entry"):
        launch("ogvt_nope", *args, dy, "silu", 1e-5, True, "t")


def _fwd_entries():
    return dict(mlp_branch.by_entry)


def _fwd_entry_delta(before):
    return {k: v - before.get(k, 0) for k, v in mlp_branch.by_entry.items()
            if v - before.get(k, 0)}


def _check_mlp_forward(got, again, want):
    """Two calls bitwise equal, the plain version within the bf16
    tolerance, and at least 90% of y bitwise its y (only the fp32 sum order
    differs), as chip_smoke.py holds the kernel."""
    assert torch.equal(got, again), "y differs between two calls"
    _assert_close(got, want, torch.bfloat16)
    share = (got == want).float().mean().item()
    assert share >= 0.9, f"{share:.4%} of y bitwise the plain version's"


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("M,C,H,apply_ln,variant", [
    (37, 48, 96, True, "t"),          # one ragged tile, H past one chunk
    (1000, 64, 256, True, "row"),     # the row-layout kernel's tag (#4)
    (300, 448, 1792, True, "t"),      # the widest C: 4 warps a row tile
    (5, 320, 640, False, "t"),        # 5 tokens, no LN
    (262_144, 64, 256, True, "row")])  # Tiny-ImageNet stage 0, batch 64
def test_mlp_branch_mma_matches_plain(dev, act, M, C, H, apply_ln, variant):
    # bf16 launches whose C and H are multiples of 16 take the tensor-core
    # forward, csrc/mlp_branch_mma.cu
    args, _ = _mlp_args(torch.Generator().manual_seed(M + C + H), M, C, H,
                        dev, torch.bfloat16)
    before = _fwd_entries()
    n = mlp_branch.by_variant[variant]
    got = mlp_branch(*args, act, 1e-5, apply_ln, variant)
    again = mlp_branch(*args, act, 1e-5, apply_ln, variant)
    torch.cuda.synchronize()
    assert _fwd_entry_delta(before) == {"ogvt_mlp_branch_mma": 2}
    assert mlp_branch.by_variant[variant] == n + 2
    _check_mlp_forward(got, again,
                       mlp_branch_reference(*args, act, 1e-5, apply_ln))


@pytest.mark.parametrize("dtype,H", [(torch.float32, 256),
                                     (torch.bfloat16, 100)])
def test_mlp_branch_takes_the_fma_kernel_where_mma_does_not(dev, dtype, H):
    # fp32, and bf16 at H = 100 (not a multiple of 16): csrc/mlp_branch.cu
    M, C = 70, 48
    args, _ = _mlp_args(torch.Generator().manual_seed(H), M, C, H, dev,
                        dtype)
    before = _fwd_entries()
    got = mlp_branch(*args, "gelu", 1e-5, True)
    torch.cuda.synchronize()
    assert _fwd_entry_delta(before) == {"ogvt_mlp_branch": 1}
    _assert_close(got, mlp_branch_reference(*args, "gelu", 1e-5, True),
                  dtype)


@pytest.mark.parametrize("M,C,H", [(300, 48, 192), (1000, 64, 256),
                                   (200, 128, 512), (129, 256, 1024),
                                   (70, 384, 1536)])
def test_mlp_branch_mma_takes_every_layout(dev, M, C, H):
    # every layout the kernel takes at these shapes (split 1-8, the weights
    # resident or in 1 or 2 buffers), not only the one the plan picks
    launch = mlp_branch_mod._launch_forward
    args, _ = _mlp_args(torch.Generator().manual_seed(M + H), M, C, H, dev,
                        torch.bfloat16)
    want = mlp_branch_reference(*args, "gelu", 1e-5, True)
    layouts = mlp_branch_mod._fwd_layouts(C, H)
    assert layouts
    for split, buffers, *_ in layouts:
        plan = mlp_branch_mod._fwd_plan(M, C, H, split, buffers)
        got = launch("ogvt_mlp_branch_mma", *args, "gelu", 1e-5, True, "t",
                     plan)
        again = launch("ogvt_mlp_branch_mma", *args, "gelu", 1e-5, True,
                       "t", plan)
        torch.cuda.synchronize()
        _check_mlp_forward(got, again, want)


def test_mlp_branch_entries_on_request(dev):
    # the A/B of chip_smoke.py: either forward kernel at a shape both take,
    # each against the plain version; the mma entry refuses fp32 by name
    launch = mlp_branch_mod._launch_forward
    args, _ = _mlp_args(torch.Generator().manual_seed(5), 200, 64, 128, dev,
                        torch.bfloat16)
    want = mlp_branch_reference(*args, "silu", 1e-5, True)
    for entry in ("ogvt_mlp_branch", "ogvt_mlp_branch_mma"):
        before = _fwd_entries()
        got = launch(entry, *args, "silu", 1e-5, True, "t")
        torch.cuda.synchronize()
        assert _fwd_entry_delta(before) == {entry: 1}
        _assert_close(got, want, torch.bfloat16)
    f32 = tuple(t.float() for t in args)
    with pytest.raises(ValueError, match="M=200, C=64, H=128"):
        launch("ogvt_mlp_branch_mma", *f32, "silu", 1e-5, True, "t")
    with pytest.raises(ValueError, match="entry"):
        launch("ogvt_nope", *args, "silu", 1e-5, True, "t")


def test_mlp_branch_mma_refuses_what_it_does_not_take(dev):
    args, _ = _mlp_args(torch.Generator().manual_seed(6), 64, 48, 96, dev,
                        torch.bfloat16)
    # a pointer off 16 bytes: the kernel copies 16 bytes at a time
    off = torch.empty(64 * 48 + 1, device=dev,
                      dtype=torch.bfloat16)[1:].view(64, 48)
    off.copy_(args[0])
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError, match="x .*16-byte aligned"):
        mlp_branch(off, *args[1:], "gelu")
    # the entry point checks the plan it is given against the shapes
    plan = mlp_branch_mod.mlp_branch_forward_plan(64, 48, 96)
    lib = kernel_build.load()
    y = torch.empty_like(args[0])
    ptrs = (*(t.data_ptr() for t in args), y.data_ptr(), 64, 48, 96, 0,
            1e-5, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (dict(smem=plan.smem + 16), dict(split=3), dict(buffers=3),
                dict(blocks=0), dict(blocks=plan.tiles + 1)):
        err = lib.ogvt_mlp_branch_mma(*ptrs, *plan._replace(**bad).args(),
                                      stream)
        assert err != 0, bad
    assert lib.ogvt_mlp_branch_mma(*ptrs[:-1], 0, *plan.args(), stream) != 0
    assert lib.ogvt_mlp_branch_mma(*ptrs, *plan.args(), stream) == 0


def test_mlp_branch_backward_mma_refuses_what_it_does_not_take(dev):
    args, dy = _mlp_args(torch.Generator().manual_seed(6), 64, 48, 96, dev,
                         torch.bfloat16)
    # a pointer off 16 bytes: the kernel copies 16 bytes at a time
    off = torch.empty(64 * 48 + 1, device=dev,
                      dtype=torch.bfloat16)[1:].view(64, 48)
    off.copy_(dy)
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError, match="dy .*16-byte aligned"):
        mlp_branch_backward(*args, off, "gelu")
    # the entry point checks the plan it is given against the shapes
    plan = mlp_branch_mod.mlp_branch_backward_plan(64, 48, 96)
    lib = kernel_build.load()
    assert lib.ogvt_mlp_branch_bwd_mma_workspace(
        64, 48, 96, plan.t_blocks, plan.w_splits) == plan.ws_floats
    grads = [torch.empty_like(t) for t in args]
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    for bad in (dict(t_smem=plan.t_smem + 16), dict(w_smem=plan.w_smem - 16),
                dict(t_split=3), dict(w_units=48), dict(w_mt=1),
                dict(t_blocks=0), dict(w_splits=plan.w_splits + 5)):
        err = lib.ogvt_mlp_branch_bwd_mma(
            *(t.data_ptr() for t in args[:6]), dy.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), 64, 48, 96, 0,
            1e-5, 1, 1, *plan._replace(**bad).args(),
            torch.cuda.current_stream().cuda_stream)
        assert err != 0, bad
    err = lib.ogvt_mlp_branch_bwd_mma(
        *(t.data_ptr() for t in args[:6]), dy.data_ptr(),
        *(g.data_ptr() for g in grads), ws.data_ptr(), 64, 48, 96, 0, 1e-5, 1,
        1, *plan.args(), torch.cuda.current_stream().cuda_stream)
    assert err == 0


def _branch_args(g, G, N, C, dev, dtype):
    def r(*shape, s=1.0, b=0.0):
        return torch.randn(*shape, generator=g) * s + b

    return (r(G, N, C).to(dev, dtype), r(C, s=0.1, b=1.0).to(dev),
            r(C, s=0.1).to(dev), r(C, 3 * C, s=C ** -0.5).to(dev, dtype),
            r(3 * C, s=0.02).to(dev, dtype),
            r(C, C, s=C ** -0.5).to(dev, dtype), r(C, s=0.02).to(dev, dtype))


BRANCH_GRADS = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj",
                "dbproj")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,C,heads,apply_ln", [
    (8192, 64, 64, 2, True),   # Tiny-ImageNet stage 0 at train batch 128
    (5, 64, 80, 2, True),      # cifar100_model_a stage 0 (hd 40)
    (3, 72, 48, 3, False),     # N not a multiple of 32, no LN
    (2, 100, 24, 4, True)])
def test_attn_branch_kernels_match_plain(dev, dtype, G, N, C, heads,
                                         apply_ln):
    g = torch.Generator().manual_seed(G + N + C)
    args = _branch_args(g, G, N, C, dev, dtype)
    dy = torch.randn(G, N, C, generator=g).to(dev, dtype)
    n = (attn_branch.launches, attn_branch_backward.launches)
    got = attn_branch(*args, heads, 1e-5, apply_ln)
    grads = attn_branch_backward(*args, dy, heads, 1e-5, apply_ln)
    again = attn_branch_backward(*args, dy, heads, 1e-5, apply_ln)
    torch.cuda.synchronize()
    assert (attn_branch.launches, attn_branch_backward.launches) == \
        (n[0] + 1, n[1] + 2)
    _assert_close(got, attn_branch_reference(*args, heads, 1e-5, apply_ln),
                  dtype)
    want = attn_branch_backward_reference(*args, dy, heads, 1e-5, apply_ln)
    for name, a, b, w in zip(BRANCH_GRADS, grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        elif not apply_ln and name.startswith("dln"):
            assert not a.any(), name
        else:
            _assert_close_to_max(a, w, dtype, name)


def _attn_bwd_entries(fn=attn_branch_backward):
    return dict(fn.by_entry)


def _attn_delta(before, fn=attn_branch_backward):
    return {k: v - before.get(k, 0) for k, v in fn.by_entry.items()
            if v - before.get(k, 0)}


def _check_branch_grads(got, again, want, dtype, apply_ln):
    for name, a, b, w in zip(BRANCH_GRADS, got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        elif not apply_ln and name.startswith("dln"):
            assert not a.any(), name
        else:
            _assert_close_to_max(a, w, dtype, name)


@pytest.mark.parametrize("G,C,apply_ln", [
    (8192, 64, True),    # Tiny-ImageNet stage 0 at train batch 128
    (5, 80, True),       # cifar100_model_a stage 0 (hd 40), 5 grids
    (2048, 80, False),   # the same at batch 32, no LN
    (1, 64, False),      # one grid
    (1, 80, True)])
def test_attn_branch_backward_mma_matches_plain(dev, G, C, apply_ln):
    # bf16 launches at the shapes csrc/attn_branch_bwd_mma.cu is
    # instantiated at (N = 64; C = 64, hd 32; C = 80, hd 40) take it
    g = torch.Generator().manual_seed(G + C)
    args = _branch_args(g, G, 64, C, dev, torch.bfloat16)
    dy = torch.randn(G, 64, C, generator=g).to(dev, torch.bfloat16)
    before = _attn_bwd_entries()
    got = attn_branch_backward(*args, dy, 2, 1e-5, apply_ln)
    again = attn_branch_backward(*args, dy, 2, 1e-5, apply_ln)
    torch.cuda.synchronize()
    assert _attn_delta(before) == {"ogvt_attn_branch_bwd_mma": 2}
    want = attn_branch_backward_reference(*args, dy, 2, 1e-5, apply_ln)
    _check_branch_grads(got, again, want, torch.bfloat16, apply_ln)


@pytest.mark.parametrize("B,H,W,C,g", [
    (128, 32, 32, 80, 4),   # cifar100_model_a stage 0, train batch 128
    (3, 16, 64, 64, 4)])    # a rectangular map: 4 x 16 windows of 4 x 16
def test_attn_branch_nhwc_backward_mma_matches_plain_and_tokens(dev, B, H, W,
                                                                C, g):
    gen = torch.Generator().manual_seed(B + H + W + C)
    args = _branch_args(gen, B, H * W, C, dev, torch.bfloat16)
    args = (args[0].reshape(B, H, W, C), *args[1:])
    dy = torch.randn(B, H, W, C, generator=gen).to(dev, torch.bfloat16)
    before = _attn_bwd_entries(attn_branch_nhwc_backward)
    got = attn_branch_nhwc_backward(*args, dy, 2, g)
    again = attn_branch_nhwc_backward(*args, dy, 2, g)
    torch.cuda.synchronize()
    assert _attn_delta(before, attn_branch_nhwc_backward) == \
        {"ogvt_attn_branch_nhwc_bwd_mma": 2}
    want = attn_branch_nhwc_backward_reference(*args, dy, 2, g)
    _check_branch_grads(got, again, want, torch.bfloat16, True)
    # #5 on the partitioned tokens: the same blocks, the same grids each
    x, meta, shape = _windows(args[0], g)
    before = _attn_bwd_entries()
    tgrads = attn_branch_backward(x, *args[1:], _windows(dy, g)[0], 2)
    assert _attn_delta(before) == {"ogvt_attn_branch_bwd_mma": 1}
    assert torch.equal(got[0],
                       grid_unpartition(tgrads[0].reshape(shape), meta))
    for name, a, t in zip(BRANCH_GRADS[1:], got[1:], tgrads[1:]):
        assert torch.equal(a, t), name


@pytest.mark.parametrize("dtype,G,N,C,heads", [
    (torch.float32, 8, 64, 64, 2),     # fp32: the FMA kernel's
    (torch.bfloat16, 3, 72, 48, 3),    # N other than 64
    (torch.bfloat16, 2, 100, 24, 4),
    (torch.bfloat16, 4, 64, 64, 4)])   # hd 16: not instantiated
def test_attn_branch_backward_takes_the_fma_kernel_where_mma_does_not(
        dev, dtype, G, N, C, heads):
    g = torch.Generator().manual_seed(G + N + C + heads)
    args = _branch_args(g, G, N, C, dev, dtype)
    dy = torch.randn(G, N, C, generator=g).to(dev, dtype)
    before = _attn_bwd_entries()
    got = attn_branch_backward(*args, dy, heads)
    again = attn_branch_backward(*args, dy, heads)
    torch.cuda.synchronize()
    assert _attn_delta(before) == {"ogvt_attn_branch_bwd": 2}
    want = attn_branch_backward_reference(*args, dy, heads)
    _check_branch_grads(got, again, want, dtype, True)


def test_attn_branch_backward_entries_on_request(dev):
    # the A/B of chip_smoke.py: either kernel at a shape both take, each
    # against the plain version, on tokens and on the NHWC map; the mma
    # entry refuses fp32 by name
    g = torch.Generator().manual_seed(9)
    args = _branch_args(g, 64, 64, 80, dev, torch.bfloat16)
    dy = torch.randn(64, 64, 80, generator=g).to(dev, torch.bfloat16)
    want = attn_branch_backward_reference(*args, dy, 2)
    for entry in attn_branch_mod.BACKWARD_ENTRIES:
        before = _attn_bwd_entries()
        got = attn_branch_mod._launch_backward(entry, *args, dy, 2)
        again = attn_branch_mod._launch_backward(entry, *args, dy, 2)
        torch.cuda.synchronize()
        assert _attn_delta(before) == {entry: 2}
        _check_branch_grads(got, again, want, torch.bfloat16, True)
    xm = args[0].reshape(4, 32, 32, 80)
    dym = dy.reshape(4, 32, 32, 80)
    want = attn_branch_nhwc_backward_reference(xm, *args[1:], dym, 2, 4)
    for entry in attn_branch_mod.NHWC_BACKWARD_ENTRIES:
        before = _attn_bwd_entries(attn_branch_nhwc_backward)
        got = attn_branch_mod._launch_nhwc_backward(entry, xm, *args[1:], dym,
                                                    2, 4)
        again = attn_branch_mod._launch_nhwc_backward(entry, xm, *args[1:],
                                                      dym, 2, 4)
        torch.cuda.synchronize()
        assert _attn_delta(before, attn_branch_nhwc_backward) == \
            {entry: 2}
        _check_branch_grads(got, again, want, torch.bfloat16, True)
    f32 = tuple(t.float() for t in args)
    with pytest.raises(ValueError, match="G=64, N=64, C=80, heads=2"):
        attn_branch_mod._launch_backward("ogvt_attn_branch_bwd_mma", *f32,
                                         dy.float(), 2)
    with pytest.raises(ValueError, match="entry"):
        attn_branch_mod._launch_backward("ogvt_nope", *args, dy, 2)


def test_attn_branch_backward_mma_refuses_what_it_does_not_take(dev):
    g = torch.Generator().manual_seed(10)
    G, C = 6, 64
    args = _branch_args(g, G, 64, C, dev, torch.bfloat16)
    dy = torch.randn(G, 64, C, generator=g).to(dev, torch.bfloat16)
    # a pointer off 16 bytes: the kernels copy 16 bytes at a time
    off = torch.empty(G * 64 * C + 1, device=dev,
                      dtype=torch.bfloat16)[1:].view(G, 64, C)
    off.copy_(dy)
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError, match="dy .*16-byte aligned"):
        attn_branch_backward(*args, off, 2)
    # the entry point checks the plan it is given against the shapes
    plan = attn_branch_mod.attn_branch_backward_plan(G, 64, C, 2)
    lib = kernel_build.load()
    grads = [torch.empty_like(t) for t in args]
    ws = torch.empty(lib.ogvt_attn_branch_bwd_mma_workspace(
        G, C, plan.t_blocks, plan.w_splits), dtype=torch.float32, device=dev)

    def call(p, N=64, heads=2):
        return lib.ogvt_attn_branch_bwd_mma(
            *(t.data_ptr() for t in args[:6]), dy.data_ptr(),
            *(t.data_ptr() for t in grads), ws.data_ptr(), G, N, C, heads,
            0.125, 1e-5, 1, 1, *p.args(),
            torch.cuda.current_stream().cuda_stream)

    for bad in (dict(t_smem=plan.t_smem + 16), dict(w_smem=plan.w_smem - 16),
                dict(t_blocks=0), dict(t_grids=plan.t_grids + 1,
                                       t_blocks=plan.t_blocks + 1),
                dict(w_splits=plan.w_splits + 5)):
        assert call(plan._replace(**bad)) != 0, bad
    assert call(plan, N=72) != 0
    assert call(plan, heads=4) != 0
    assert call(plan) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("G,C,apply_ln", [
    (4096, 64, True),    # Tiny-ImageNet stage 0 at serving batch 64
    (8192, 64, False),   # the same at train batch 128, no LN
    (5, 80, True),       # cifar100_model_a stage 0 (hd 40), 5 grids
    (1024, 80, False),   # the same at batch 64, no LN
    (1, 64, True)])      # one grid
def test_attn_branch_mma_matches_plain(dev, G, C, apply_ln):
    # bf16 launches at the shapes csrc/attn_branch_mma.cu is instantiated
    # at (N = 64; C = 64, hd 32; C = 80, hd 40) take it; two calls are
    # bitwise equal
    g = torch.Generator().manual_seed(G + C + 1)
    args = _branch_args(g, G, 64, C, dev, torch.bfloat16)
    before = dict(attn_branch.by_entry)
    got = attn_branch(*args, 2, 1e-5, apply_ln)
    again = attn_branch(*args, 2, 1e-5, apply_ln)
    torch.cuda.synchronize()
    assert _attn_delta(before, attn_branch) == {"ogvt_attn_branch_mma": 2}
    assert torch.equal(got, again)
    _assert_close(got, attn_branch_reference(*args, 2, 1e-5, apply_ln),
                  torch.bfloat16)


@pytest.mark.parametrize("B,H,W,C,g", [
    (64, 32, 32, 80, 4),    # cifar100_model_a stage 0, serving batch 64
    (3, 16, 64, 64, 4)])    # a rectangular map: 4 x 16 windows of 4 x 16
def test_attn_branch_nhwc_mma_matches_plain_and_tokens(dev, B, H, W, C, g):
    gen = torch.Generator().manual_seed(B + H + W + C + 1)
    args = _branch_args(gen, B, H * W, C, dev, torch.bfloat16)
    args = (args[0].reshape(B, H, W, C), *args[1:])
    before = dict(attn_branch_nhwc.by_entry)
    got = attn_branch_nhwc(*args, 2, g)
    again = attn_branch_nhwc(*args, 2, g)
    torch.cuda.synchronize()
    assert _attn_delta(before, attn_branch_nhwc) == \
        {"ogvt_attn_branch_nhwc_mma": 2}
    assert torch.equal(got, again)
    _assert_close(got, attn_branch_nhwc_reference(*args, 2, g),
                  torch.bfloat16)
    # #5 on the partitioned tokens: the same y, bit for bit
    x, meta, shape = _windows(args[0], g)
    before = dict(attn_branch.by_entry)
    tokens = attn_branch(x, *args[1:], 2)
    assert _attn_delta(before, attn_branch) == {"ogvt_attn_branch_mma": 1}
    assert torch.equal(got, grid_unpartition(tokens.reshape(shape), meta))


@pytest.mark.parametrize("dtype,G,N,C,heads", [
    (torch.float32, 8, 64, 64, 2),     # fp32: the FMA kernel's
    (torch.float32, 5, 64, 80, 2),
    (torch.bfloat16, 3, 72, 48, 3),    # N other than 64
    (torch.bfloat16, 4, 64, 64, 4)])   # hd 16: not instantiated
def test_attn_branch_takes_the_fma_kernel_where_mma_does_not(
        dev, dtype, G, N, C, heads):
    g = torch.Generator().manual_seed(G + N + C + heads + 1)
    args = _branch_args(g, G, N, C, dev, dtype)
    before = dict(attn_branch.by_entry)
    got = attn_branch(*args, heads)
    torch.cuda.synchronize()
    assert _attn_delta(before, attn_branch) == {"ogvt_attn_branch": 1}
    _assert_close(got, attn_branch_reference(*args, heads), dtype)


def test_attn_branch_forward_entries_on_request(dev):
    # the A/B of chip_smoke.py: either kernel at a shape both take, each
    # against the plain version, on tokens and on the NHWC map; the mma
    # entry refuses fp32 by name
    g = torch.Generator().manual_seed(19)
    args = _branch_args(g, 64, 64, 80, dev, torch.bfloat16)
    want = attn_branch_reference(*args, 2)
    for entry in attn_branch_mod.FORWARD_ENTRIES:
        before = dict(attn_branch.by_entry)
        got = attn_branch_mod._launch_forward(entry, *args, 2)
        torch.cuda.synchronize()
        assert _attn_delta(before, attn_branch) == {entry: 1}
        _assert_close(got, want, torch.bfloat16)
    xm = args[0].reshape(4, 32, 32, 80)
    want = attn_branch_nhwc_reference(xm, *args[1:], 2, 4)
    for entry in attn_branch_mod.NHWC_FORWARD_ENTRIES:
        before = dict(attn_branch_nhwc.by_entry)
        got = attn_branch_mod._launch_nhwc_forward(entry, xm, *args[1:], 2,
                                                   4)
        torch.cuda.synchronize()
        assert _attn_delta(before, attn_branch_nhwc) == {entry: 1}
        _assert_close(got, want, torch.bfloat16)
    f32 = tuple(t.float() for t in args)
    with pytest.raises(ValueError, match="G=64, N=64, C=80, heads=2"):
        attn_branch_mod._launch_forward("ogvt_attn_branch_mma", *f32, 2)
    with pytest.raises(ValueError, match="entry"):
        attn_branch_mod._launch_forward("ogvt_nope", *args, 2)


def test_attn_branch_mma_refuses_what_it_does_not_take(dev):
    g = torch.Generator().manual_seed(11)
    G, C = 6, 64
    args = _branch_args(g, G, 64, C, dev, torch.bfloat16)
    # a pointer off 16 bytes: the kernel copies 16 bytes at a time
    off = torch.empty(G * 64 * C + 1, device=dev,
                      dtype=torch.bfloat16)[1:].view(G, 64, C)
    off.copy_(args[0])
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError, match="x .*16-byte aligned"):
        attn_branch(off, *args[1:], 2)
    # the entry point checks the plan it is given against the shapes
    plan = attn_branch_mod.attn_branch_forward_plan(G, 64, C, 2)
    lib = kernel_build.load()
    y = torch.empty_like(args[0])

    def call(p, N=64, heads=2, x=args[0]):
        return lib.ogvt_attn_branch_mma(
            x.data_ptr(), *(t.data_ptr() for t in args[1:]), y.data_ptr(),
            G, N, C, heads, (C // 2) ** -0.5, 1e-5, 1, 1, *p.args(),
            torch.cuda.current_stream().cuda_stream)

    for bad in (dict(smem=plan.smem + 16), dict(smem=plan.smem - 16),
                dict(blocks=0), dict(grids=plan.grids + 1,
                                     blocks=plan.blocks + 1),
                dict(blocks=plan.blocks + 5)):
        assert call(plan._replace(**bad)) != 0, bad
    assert call(plan, N=72) != 0
    assert call(plan, heads=4) != 0
    assert call(plan, x=off) != 0
    assert call(plan) == 0
    torch.cuda.synchronize()
    _assert_close(y, attn_branch_reference(*args, 2), torch.bfloat16)


def _th_entries():
    return (grid_mhsa.by_entry["ogvt_grid_mhsa_th"],
            grid_mhsa_backward.by_entry["ogvt_grid_mhsa_th_bwd"],
            grid_mhsa.by_entry["ogvt_grid_mhsa"],
            grid_mhsa_backward.by_entry["ogvt_grid_mhsa_bwd"])


def _check_th(dev, dtype, G, C, heads, seed):
    """Both "th" launches against their plain versions, the backward twice
    bitwise equal; bf16 through csrc/grid_mhsa_th.cu's entry points, fp32
    through csrc/grid_mhsa.cu's."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(G, 16, 3 * C, generator=g).to(dev, dtype)
    dout = torch.randn(G, 16, C, generator=g).to(dev, dtype)
    n = (grid_mhsa.by_variant["th"], grid_mhsa_backward.by_variant["th"])
    entries = _th_entries()
    got = grid_mhsa(qkv, heads, "th")
    dqkv = grid_mhsa_backward(qkv, dout, heads, "th")
    again = grid_mhsa_backward(qkv, dout, heads, "th")
    torch.cuda.synchronize()
    assert (grid_mhsa.by_variant["th"],
            grid_mhsa_backward.by_variant["th"]) == (n[0] + 1, n[1] + 2)
    step = (1, 2, 0, 0) if dtype == torch.bfloat16 else (0, 0, 1, 2)
    assert _th_entries() == tuple(a + b for a, b in zip(entries, step))
    assert torch.equal(dqkv, again)
    _assert_close(got, grid_mhsa_reference(qkv, heads), dtype)
    _assert_close(dqkv, grid_mhsa_backward_reference(qkv, dout, heads), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,C,heads", [
    (8192, 128, 4), (2048, 256, 8), (512, 384, 6),
    (2048, 160, 5), (512, 320, 10), (128, 448, 8),
    (1, 160, 5), (3, 384, 6), (1, 320, 10), (3, 448, 8)])
def test_grid_mhsa_kernels_at_the_64px_shapes(dev, dtype, G, C, heads):
    # the shapes of the head-chunked TPU kernel #3 at train batch 128, N=16:
    # Tiny-ImageNet stages 1-3 (hd 32 and 64) and the default Model A's
    # (C = 160/320/448, hd 32/32/56); then G = 1 and 3, whose (grid, head)
    # units leave the last block of the bf16 kernel part empty
    _check_th(dev, dtype, G, C, heads, C + G)


@pytest.mark.parametrize("hd", [8, 16, 24, 40, 48, 64])
def test_grid_mhsa_th_at_every_head_width(dev, hd):
    # every instantiation of csrc/grid_mhsa_th.cu: the k8 tail at odd hd/8
    _check_th(dev, torch.bfloat16, 7, 3 * hd, 3, hd)


def test_grid_mhsa_th_refuses_what_it_does_not_take(dev):
    def buf(*shape):
        n = 1
        for d in shape:
            n *= d
        return torch.randn(n + 1, device=dev).bfloat16()[1:].view(*shape)

    qkv, dout = buf(4, 16, 3 * 128), buf(4, 16, 128)
    assert qkv.data_ptr() % 16 and qkv.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        grid_mhsa(qkv, 4, "th")
    with pytest.raises(ValueError, match="dout .*16-byte aligned"):
        grid_mhsa_backward(qkv.clone(), dout, 4, "th")
    # fp32 "th" launches take csrc/grid_mhsa.cu, which copies elementwise
    q32 = torch.randn(4 * 16 * 3 * 128 + 1, device=dev)[1:].view(4, 16, 384)
    _assert_close(grid_mhsa(q32, 4, "th"), grid_mhsa_reference(q32, 4),
                  torch.float32)
    for G, N, C, heads in ((2, 9, 3 * 128, 4), (2, 16, 100, 5),
                           (2, 16, 144, 2)):
        x = torch.randn(G, N, 3 * C, device=dev).bfloat16()
        with pytest.raises(ValueError, match=f"N={N}, C={C}"):
            grid_mhsa(x, heads, "th")
        with pytest.raises(ValueError, match=f"N={N}, C={C}"):
            grid_mhsa_backward(x, x[..., :C].contiguous(), heads, "th")


def _check_grid(dev, dtype, G, N, C, heads, variant, seed, want, qkv=None,
                dout=None):
    """Both launches of one grid-core shape against their plain versions
    through the entry point ``want`` (``ogvt_grid_mhsa_th`` or
    ``ogvt_grid_mhsa``, ``_bwd`` for the backward), by each wrapper's
    ``by_entry``; the backward twice, bitwise equal; every output finite.
    Returns (out, dqkv)."""
    g = torch.Generator().manual_seed(seed)
    if qkv is None:
        qkv = torch.randn(G, N, 3 * C, generator=g).to(dev, dtype)
        dout = torch.randn(G, N, C, generator=g).to(dev, dtype)
    before = (grid_mhsa.by_entry.copy(), grid_mhsa_backward.by_entry.copy())
    got = grid_mhsa(qkv, heads, variant)
    dqkv = grid_mhsa_backward(qkv, dout, heads, variant)
    again = grid_mhsa_backward(qkv, dout, heads, variant)
    torch.cuda.synchronize()
    assert +(grid_mhsa.by_entry - before[0]) == {want: 1}
    assert +(grid_mhsa_backward.by_entry - before[1]) == {want + "_bwd": 2}
    assert torch.equal(dqkv, again)
    assert bool(torch.isfinite(got.float()).all())
    assert bool(torch.isfinite(dqkv.float()).all())
    _assert_close(got, grid_mhsa_reference(qkv, heads), dtype)
    _assert_close(dqkv, grid_mhsa_backward_reference(qkv, dout, heads), dtype)
    return got, dqkv


# Every "t" launch of the shipped configs at train batch 128 (G = 128 *
# grids an image): Model B (also 14M and SVHN) stage 0 (N = 16, C = 64) and
# stages 1-3 (N = 4); A-7M stage 0 (N = 16, C = 48, hd 24) and stages 1-3
# (N = 4); a7m_48 stages 1-3 (N = 9, one grid a unit, 7 padding rows).
T_SHAPES = [(8192, 16, 64, 2), (8192, 4, 128, 4), (2048, 4, 256, 8),
            (512, 4, 384, 6), (8192, 16, 48, 2), (8192, 4, 96, 3),
            (2048, 4, 192, 6), (512, 4, 256, 8), (8192, 9, 96, 3),
            (2048, 9, 192, 6), (512, 9, 256, 8)]


@pytest.mark.parametrize("G,N,C,heads", T_SHAPES)
def test_grid_mhsa_t_takes_the_tensor_core_kernel(dev, G, N, C, heads):
    _check_grid(dev, torch.bfloat16, G, N, C, heads, "t", G + N + C,
                "ogvt_grid_mhsa_th")


@pytest.mark.parametrize("G,N,C,heads", [
    (7, 1, 48, 2), (7, 5, 64, 2), (3, 9, 96, 3), (1, 9, 56, 1),
    (5, 4, 40, 5), (1, 4, 64, 2), (1, 16, 64, 2), (11, 7, 24, 3),
    (9, 2, 128, 2), (13, 3, 64, 1), (6, 6, 512, 8), (3, 15, 32, 4)])
def test_grid_mhsa_t_packs_grids_into_units(dev, G, N, C, heads):
    # N = 1, 5, 9 and others that do not divide 16, G % (16 // N) != 0
    # (the last unit part empty), G = 1, hd 8-64
    _check_grid(dev, torch.bfloat16, G, N, C, heads, "t", 7 * G + N,
                "ogvt_grid_mhsa_th")


@pytest.mark.parametrize("at_end", [False, True])
def test_grid_mhsa_t_reads_nothing_past_its_tensors(dev, at_end):
    # qkv and dout at the start of a NaN-filled allocation (a read past
    # their end would bring NaN in) or at its very end (past it, nothing is
    # allocated); G % P != 0, so the last unit holds one grid of three
    G, N, C, heads = 7, 5, 64, 2
    g = torch.Generator().manual_seed(5)

    def place(*shape):
        n = G * N * shape[-1]
        buf = torch.full((n + 4096,), float("nan"), device=dev,
                         dtype=torch.bfloat16)
        t = buf[4096:] if at_end else buf[:n]
        t.copy_(torch.randn(n, generator=g).to(dev, torch.bfloat16))
        return t.view(*shape)

    qkv, dout = place(G, N, 3 * C), place(G, N, C)
    _check_grid(dev, torch.bfloat16, G, N, C, heads, "t", 0,
                "ogvt_grid_mhsa_th", qkv, dout)


@pytest.mark.parametrize("G,C,heads", [(8192, 64, 2), (8192, 48, 2),
                                       (512, 128, 4)])
def test_grid_mhsa_t_is_bitwise_th_at_16_tokens(dev, G, C, heads):
    # one kernel for both tags: a "t" launch equals a "th" one at N = 16
    t = _check_grid(dev, torch.bfloat16, G, 16, C, heads, "t", G + C,
                    "ogvt_grid_mhsa_th")
    th = _check_grid(dev, torch.bfloat16, G, 16, C, heads, "th", G + C,
                     "ogvt_grid_mhsa_th")
    assert torch.equal(t[0], th[0]) and torch.equal(t[1], th[1])


@pytest.mark.parametrize("dtype,G,N,C,heads,want", [
    (torch.float32, 8192, 16, 64, 2, "ogvt_grid_mhsa"),
    (torch.float32, 2048, 4, 192, 6, "ogvt_grid_mhsa"),
    (torch.float32, 7, 5, 64, 2, "ogvt_grid_mhsa"),
    (torch.bfloat16, 7, 9, 36, 3, "ogvt_grid_mhsa"),
    (torch.bfloat16, 5, 4, 60, 5, "ogvt_grid_mhsa")])
def test_grid_mhsa_t_keeps_the_fma_kernel_for_fp32_and_other_heads(
        dev, dtype, G, N, C, heads, want):
    # fp32 and head widths the tensor-core kernel does not take (12)
    _check_grid(dev, dtype, G, N, C, heads, "t", G + C, want)


def test_grid_mhsa_entries_on_request(dev):
    # both kernels on the same bf16 inputs through grid_attention._launch
    g = torch.Generator().manual_seed(2)
    G, N, C, heads = 300, 4, 96, 3
    qkv = torch.randn(G, N, 3 * C, generator=g).to(dev, torch.bfloat16)
    dout = torch.randn(G, N, C, generator=g).to(dev, torch.bfloat16)
    before = (grid_mhsa.by_entry.copy(), grid_mhsa_backward.by_entry.copy())
    outs = [grid_attention_mod._launch(e, qkv, heads, "t") for e in
            grid_attention_mod.ENTRIES]
    douts = [grid_attention_mod._launch(e, qkv, heads, "t", dout) for e in
             grid_attention_mod.BACKWARD_ENTRIES]
    torch.cuda.synchronize()
    assert +(grid_mhsa.by_entry - before[0]) == {
        e: 1 for e in grid_attention_mod.ENTRIES}
    assert +(grid_mhsa_backward.by_entry - before[1]) == {
        e: 1 for e in grid_attention_mod.BACKWARD_ENTRIES}
    for got in outs:
        _assert_close(got, grid_mhsa_reference(qkv, heads), torch.bfloat16)
    for got in douts:
        _assert_close(got, grid_mhsa_backward_reference(qkv, dout, heads),
                      torch.bfloat16)
    with pytest.raises(ValueError, match="entry"):
        grid_attention_mod._launch("ogvt_grid_mhsa_th_bwd", qkv, heads)


def test_grid_mhsa_t_refuses_a_misaligned_pointer(dev):
    n = 7 * 4 * 3 * 64
    qkv = torch.randn(n + 1, device=dev).bfloat16()[1:].view(7, 4, 192)
    assert qkv.data_ptr() % 16 and qkv.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        grid_mhsa(qkv, 2, "t")
    dout = torch.randn(7 * 4 * 64 + 1, device=dev).bfloat16()[1:].view(
        7, 4, 64)
    with pytest.raises(ValueError, match="dout .*16-byte aligned"):
        grid_mhsa_backward(qkv.clone(), dout, 2, "t")
    # the entry point refuses it too, and a plan that is not the layout's
    lib = kernel_build.load()
    plan = grid_attention_mod.grid_mhsa_th_plan(7, 4, 64, 2, False)
    out = torch.empty(7, 4, 64, device=dev, dtype=torch.bfloat16)
    aligned = qkv.clone()

    def call(x, warps=plan.warps, smem=plan.smem_bytes, N=4):
        return lib.ogvt_grid_mhsa_th(
            x.data_ptr(), out.data_ptr(), 7, N, 64, 2, 32 ** -0.5, warps, smem,
            kernel_build.DTYPE_CODES[torch.bfloat16],
            torch.cuda.current_stream().cuda_stream)

    assert call(qkv) != 0
    assert call(aligned, warps=2) != 0
    assert call(aligned, smem=plan.smem_bytes + 16) != 0
    assert call(aligned, N=17) != 0
    assert call(aligned) == 0
    torch.cuda.synchronize()
    _assert_close(out, grid_mhsa_reference(aligned, 2), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [128, 256])
def test_mlp_branch_kernels_at_the_64px_row_shapes(dev, dtype, H):
    # Tiny-ImageNet stage 0 at train batch 128: M = 128*64*64 tokens of
    # C=64, the shapes of the row-layout TPU kernel #4
    M, C = 524_288, 64
    g = torch.Generator().manual_seed(H)

    def r(*shape, s=1.0, b=0.0):
        return torch.randn(*shape, generator=g) * s + b

    args = (r(M, C).to(dev, dtype), r(C, s=0.1, b=1.0).to(dev),
            r(C, s=0.1).to(dev), r(C, H, s=C ** -0.5).to(dev, dtype),
            r(H, s=0.02).to(dev, dtype), r(H, C, s=H ** -0.5).to(dev, dtype),
            r(C, s=0.02).to(dev, dtype))
    dy = r(M, C).to(dev, dtype)
    n = mlp_branch_backward.by_variant["row"]
    before = _mlp_entries()
    got = mlp_branch(*args, "gelu", 1e-5, True, "row")
    grads = mlp_branch_backward(*args, dy, "gelu", 1e-5, True, "row")
    again = mlp_branch_backward(*args, dy, "gelu", 1e-5, True, "row")
    torch.cuda.synchronize()
    assert mlp_branch_backward.by_variant["row"] == n + 2
    # bf16: the tensor-core kernel; fp32: the FMA kernel
    assert _entry_delta(before) == {
        "ogvt_mlp_branch_bwd_mma" if dtype == torch.bfloat16
        else "ogvt_mlp_branch_bwd": 2}
    _assert_close(got, mlp_branch_reference(*args, "gelu", 1e-5, True), dtype)
    want = mlp_branch_backward_reference(*args, dy, "gelu", 1e-5, True)
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for name, a, b, w in zip(names, grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        else:
            _assert_close_to_max(a, w, dtype, name)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    qkv = torch.randn(4, 17, 48, device=dev)
    with pytest.raises(ValueError, match="N=17"):
        grid_mhsa(qkv, 2)
    with pytest.raises(TypeError, match="float16"):
        grid_mhsa(qkv[:, :4].half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        grid_mhsa(torch.randn(4, 48, 4, device=dev).transpose(1, 2), 2)
    x = torch.randn(8, 16, device=dev)
    w = torch.randn(16, 32, device=dev)
    with pytest.raises(ValueError, match="w2"):
        mlp_branch(x, torch.ones(16, device=dev), torch.zeros(16, device=dev),
                   w, torch.zeros(32, device=dev), w, torch.zeros(16,
                   device=dev), "gelu")
    qkv = torch.randn(4, 4, 48, device=dev)
    with pytest.raises(ValueError, match="dout"):
        grid_mhsa_backward(qkv, torch.randn(4, 4, 8, device=dev), 2)
    with pytest.raises(ValueError, match="dout"):
        grid_mhsa_backward(qkv, torch.randn(4, 16, 4, device=dev)
                           .transpose(1, 2), 2)
    with pytest.raises(ValueError, match="N=17"):
        grid_mhsa_backward(torch.randn(4, 17, 48, device=dev),
                           torch.randn(4, 17, 16, device=dev), 2)
    ln = (torch.ones(16, device=dev), torch.zeros(16, device=dev))
    args = (x, *ln, w, torch.zeros(32, device=dev), w.t().contiguous(),
            torch.zeros(16, device=dev))
    with pytest.raises(ValueError, match="dy"):
        mlp_branch_backward(*args, torch.randn(16, 8, device=dev).t(),
                            "gelu")
    with pytest.raises(TypeError, match="float16"):
        mlp_branch_backward(x.half(), *args[1:], x.half(), "gelu")
    with pytest.raises(ValueError, match="activation"):
        mlp_branch_backward(*args, x, "tanh")
    bargs = _branch_args(torch.Generator().manual_seed(0), 2, 64, 16, dev,
                         torch.float32)
    with pytest.raises(ValueError, match="wqkv"):
        attn_branch(bargs[0], *bargs[1:3], bargs[3].t(), *bargs[4:], 2)
    with pytest.raises(ValueError, match="ln_scale"):
        attn_branch(bargs[0], bargs[1].bfloat16(), *bargs[2:], 2)
    with pytest.raises(ValueError, match="shared memory"):
        attn_branch(torch.randn(1, 256, 16, device=dev), *bargs[1:], 2)
    with pytest.raises(ValueError, match="dy"):
        attn_branch_backward(*bargs, bargs[0][:1], 2)
    with pytest.raises(ValueError, match="variant"):
        grid_mhsa(qkv, 2, "row")


def test_tiny_model_kernel_path_matches_plain_path(dev):
    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8, "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 4}]}
    kern = build_model(cfg, use_kernels=None, device=dev, seed=3)
    plain = build_model(cfg, use_kernels=False, device=dev, seed=3)
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    counts = (grid_mhsa.launches, mlp_branch.launches)
    with torch.inference_mode():
        got, want = kern(x.to(dev)), plain(x.to(dev))
    assert (grid_mhsa.launches - counts[0],
            mlp_branch.launches - counts[1]) == (2, 4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_tiny_64_token_model_kernel_path_matches_plain_path(dev):
    # 16px input, grid 2: stage 0 has grids of N=64 (the fused branch),
    # stage 1 grids of N=16
    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8,
           "dpr_max": 0.2, "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 4}]}
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    y = (torch.arange(8) % 10).to(dev)
    counters = (attn_branch, attn_branch_backward, grid_mhsa,
                grid_mhsa_backward)
    out = {}
    for use_kernels in (True, False):
        model = build_model(cfg, use_kernels=use_kernels, device=dev, seed=4)
        with torch.inference_mode():
            logits = model(x.to(dev))
        paths = [m.path for m in model.modules()
                 if isinstance(m, DropPath) and m.rate > 0]
        masks = DropPathMasks({p: torch.arange(8, device=dev) % (i + 2) > 0
                               for i, p in enumerate(paths)})
        step = make_train_step(StepConfig(num_classes=10))
        before = [c.launches for c in counters]
        state, m = step(TrainState.create(model, AdamW(1e-3)), (x.to(dev), y),
                        StepDraws(drop_masks=masks))
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([1, 1, 1, 1] if use_kernels else [0] * 4)
        out[use_kernels] = (logits, float(m["loss"]), {
            k: p.grad.clone() for k, p in model.named_parameters()})
    (lk, sk, gk), (lp, sp, gp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    assert abs(sk - sp) <= 1e-5 * abs(sp)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [t.norm() for t in gp.values()])).item()
    for k in gp:
        assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * gnorm, k


def test_tiny_model_train_step_kernel_path_matches_plain_path(dev):
    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8,
           "dpr_max": 0.2, "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
                "outlook_heads": 4}]}
    step_cfg = StepConfig(num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0,
                          mix_prob=0.5)
    step = make_train_step(step_cfg)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, 16, 3, generator=g).to(dev)
    y = (torch.arange(8) % 10).to(dev)
    draws = sample_step_draws(g, step_cfg, tuple(x.shape), dev)
    out = {}
    for use_kernels in (True, False):
        model = build_model(cfg, use_kernels=use_kernels, device=dev, seed=3)
        paths = [m.path for m in model.modules()
                 if isinstance(m, DropPath) and m.rate > 0]
        masks = DropPathMasks({p: torch.arange(8, device=dev) % (i + 2) > 0
                               for i, p in enumerate(paths)})
        counts = (grid_mhsa_backward.launches, mlp_branch_backward.launches)
        state, m = step(TrainState.create(model, AdamW(1e-3)), (x, y),
                        draws._replace(drop_masks=masks))
        torch.cuda.synchronize()
        launched = (grid_mhsa_backward.launches - counts[0],
                    mlp_branch_backward.launches - counts[1])
        assert launched == ((2, 4) if use_kernels else (0, 0))
        out[use_kernels] = (float(m["loss"]), {
            k: p.grad.clone() for k, p in model.named_parameters()})
    (lk, gk), (lp, gp) = out[True], out[False]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [t.norm() for t in gp.values()])).item()
    for k in gp:
        assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * gnorm, k


def _outlook_args(g, B, H, W, Cin, C, heads, fold, dev, dtype):
    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g) * s

    a = torch.softmax(r(B, H, W, heads, 9), -1).reshape(B, H, W, heads * 9)
    w = [r(C, C, s=C ** -0.5), r(C, s=0.02)]
    if fold:
        w = [r(Cin, C, s=Cin ** -0.5), r(C, s=0.02)] + w
    return tuple(t.to(dev, dtype) for t in (r(B, H, W, Cin), a, *w))


OUTLOOK_SHAPES = [
    (128, 32, 32, 64, 64, 2),   # Model B front at train batch 128
    (4, 64, 64, 64, 64, 2),     # 64px stage 0: two image rows per block
    (3, 13, 20, 40, 48, 2),     # hd=24, H != W, a ragged last tile, Cin != C
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,H,W,Cin,C,heads", OUTLOOK_SHAPES)
def test_outlook_kernels_match_plain(dev, dtype, fold, B, H, W, Cin, C,
                                     heads):
    if not fold and Cin != C:
        Cin = C
    g = torch.Generator().manual_seed(B + H + W + C)
    args = _outlook_args(g, B, H, W, Cin, C, heads, fold, dev, dtype)
    dy = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    if fold:
        fwd, bwd = outlook_branch, outlook_branch_backward
        fwd_ref, bwd_ref = outlook_branch_reference, \
            outlook_branch_backward_reference
        names = ("dx", "da", "dwv", "dbv", "dwp", "dbp")
    else:
        fwd, bwd = outlook_agg_proj, outlook_agg_proj_backward
        fwd_ref, bwd_ref = outlook_agg_proj_reference, \
            outlook_agg_proj_backward_reference
        names = ("dv", "da", "dwp", "dbp")
    n = (fwd.launches, bwd.launches)
    got = fwd(*args)
    grads = bwd(*args[:-1], dy)
    again = bwd(*args[:-1], dy)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n[0] + 1, n[1] + 2)
    _assert_close(got, fwd_ref(*args), dtype)
    want = bwd_ref(*args[:-1], dy)
    for name, a, b, w in zip(names, grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name in ("dx", "dv", "da"):
            _assert_close(a, w, dtype)
        else:
            _assert_close_to_max(a, w, dtype, name)


def test_outlook_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(0)
    v, a, wp, bp = _outlook_args(g, 2, 4, 8, 16, 16, 2, False, dev,
                                 torch.float32)
    with pytest.raises(TypeError, match="float16"):
        outlook_agg_proj(v.half(), a.half(), wp.half(), bp.half())
    with pytest.raises(ValueError, match="wp"):
        outlook_agg_proj(v, a, wp.bfloat16(), bp)
    with pytest.raises(ValueError, match="contiguous"):
        outlook_agg_proj(v, a, wp.t(), bp)
    with pytest.raises(ValueError, match="a must be"):
        outlook_agg_proj(v, a[..., :10], wp, bp)
    with pytest.raises(ValueError, match="divisible"):
        outlook_agg_proj(v[..., :15].contiguous(), a, wp[:15, :15]
                         .contiguous(), bp[:15].contiguous())
    with pytest.raises(ValueError, match="g is"):
        outlook_agg_proj_backward(v, a, wp, v[:1])
    x, a, wv, bv, wp, bp = _outlook_args(g, 2, 4, 8, 12, 16, 2, True, dev,
                                         torch.float32)
    with pytest.raises(ValueError, match="wv"):
        outlook_branch(x, a, wv[:8].contiguous(), bv, wp, bp)
    with pytest.raises(ValueError, match="shared memory"):
        outlook_branch(torch.randn(1, 2, 4096, 12, device=dev),
                       torch.randn(1, 2, 4096, 18, device=dev), wv, bv, wp,
                       bp)


OUTLOOK_MMA, OUTLOOK_FMA = outlook_agg_mod.BACKWARD_ENTRIES


def _outlook_bwd(fold):
    return ((outlook_branch_backward, outlook_branch_backward_reference,
             ("dx", "da", "dwv", "dbv", "dwp", "dbp")) if fold else
            (outlook_agg_proj_backward, outlook_agg_proj_backward_reference,
             ("dv", "da", "dwp", "dbp")))


def _check_outlook_bwd(dev, dtype, fold, B, H, W, Cin, C, heads, want_entry,
                       seed):
    """Two calls of the outlook backward at these shapes: the entry point
    ``want_entry`` launched twice, bitwise-equal grads, dv / dx and da
    close to the plain version per element, the parameter grads relative
    to their largest value."""
    g = torch.Generator().manual_seed(seed)
    *args, _ = _outlook_args(g, B, H, W, Cin, C, heads, fold, dev, dtype)
    dy = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    bwd, ref, names = _outlook_bwd(fold)
    before = bwd.by_entry.copy()
    got = bwd(*args, dy)
    again = bwd(*args, dy)
    torch.cuda.synchronize()
    assert dict(bwd.by_entry - before) == {want_entry: 2}
    want = ref(*args, dy)
    for name, a, b, w in zip(names, got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name in ("dx", "dv", "da"):
            _assert_close(a, w, dtype)
        else:
            _assert_close_to_max(a, w, dtype, name)


# the outlooker shapes of chip_smoke.py:OUTLOOK_SHAPES of C <= 128 at a
# small batch (H = W, C, heads): the 7M model's C = 48 and 96, TIN's C = 64
# at 64 px and C = 128
OUTLOOK_MMA_SHAPES = [(32, 48, 2), (16, 96, 3), (64, 64, 2), (32, 128, 4)]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,H,W,Cin,C,heads", OUTLOOK_SHAPES + [
    (2, h, h, c, c, n) for h, c, n in OUTLOOK_MMA_SHAPES])
def test_outlook_backward_takes_the_tensor_core_kernel(dev, fold, B, H, W,
                                                      Cin, C, heads):
    if not fold:
        Cin = C
    if Cin % 16:  # the card test's Cin = 40: refused, the FMA kernel
        want = OUTLOOK_FMA
    else:
        want = OUTLOOK_MMA
    _check_outlook_bwd(dev, torch.bfloat16, fold, B, H, W, Cin, C, heads,
                       want, B + H + C)
    # fp32 keeps the FMA kernel
    _check_outlook_bwd(dev, torch.float32, fold, B, H, W, Cin, C, heads,
                       OUTLOOK_FMA, B + H + C + 1)


@pytest.mark.parametrize("fold", [False, True])
def test_outlook_backward_keeps_the_fma_kernel_where_mma_does_not(dev,
                                                                 fold):
    # C = 192 (the 7M model's stage 2): 9 dW tiles a warp, refused
    _check_outlook_bwd(dev, torch.bfloat16, fold, 4, 8, 8, 192, 192, 6,
                       OUTLOOK_FMA, 7)


@pytest.mark.parametrize("fold", [False, True])
def test_outlook_backward_entries_on_request(dev, fold):
    # the A/B of chip_smoke.py: either kernel at a shape both take, each
    # launching its own entry point, the two close; the tensor-core entry
    # refuses fp32 and a pointer off 16 bytes
    g = torch.Generator().manual_seed(3)
    *args, _ = _outlook_args(g, 4, 32, 32, 64, 64, 2, fold, dev,
                             torch.bfloat16)
    dy = torch.randn(4, 32, 32, 64, generator=g).to(dev, torch.bfloat16)
    bwd, _, names = _outlook_bwd(fold)
    full = args if fold else [args[0], args[1], None, None, args[2]]
    name = bwd.__name__
    out = {}
    for entry in (OUTLOOK_MMA, OUTLOOK_FMA):
        before = bwd.by_entry.copy()
        out[entry] = outlook_agg_mod._launch_backward(entry, name, *full, dy)
        torch.cuda.synchronize()
        assert dict(bwd.by_entry - before) == {entry: 1}
    for n, a, b in zip(names, out[OUTLOOK_MMA], out[OUTLOOK_FMA]):
        if n in ("dx", "dv", "da"):
            _assert_close(a, b, torch.bfloat16)
        else:
            _assert_close_to_max(a, b, torch.bfloat16, n)
    f32 = [None if t is None else t.float() for t in full]
    with pytest.raises(ValueError, match="bf16 only"):
        outlook_agg_mod._launch_backward(OUTLOOK_MMA, name, *f32,
                                         dy.float())
    x = torch.empty(full[0].numel() + 1, dtype=torch.bfloat16,
                    device=dev)[1:].view(full[0].shape)
    x.copy_(full[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        outlook_agg_mod._launch_backward(OUTLOOK_MMA, name, x, *full[1:], dy)


@pytest.mark.parametrize("mode", ["fused_agg", "fused_agg_v"])
def test_model_b_bf16_train_step_takes_the_tensor_core_outlook_backward(
        dev, mode):
    # Model B (configs/cifar100_model_b.yaml's model) at batch 8 in bf16:
    # each front outlooker's backward (C = 64, 2 heads) on the new kernel
    cfg = {"type": "model_b", "num_classes": 100, "in_ch": 3, "stem_dim": 64,
           "outlooker_front_depth": 3, "dpr_max": 0.1, "use_pallas": mode,
           "stages": [
               {"dim": 64, "depth": 2, "num_heads": 2, "grid_size": 8,
                "outlook_heads": 2},
               {"dim": 128, "depth": 2, "num_heads": 4, "grid_size": 8,
                "outlook_heads": 4},
               {"dim": 256, "depth": 3, "num_heads": 8, "grid_size": 4,
                "outlook_heads": 8},
               {"dim": 384, "depth": 1, "num_heads": 6, "grid_size": 2,
                "outlook_heads": 6}]}
    bwd = _outlook_bwd(mode == "fused_agg_v")[0]
    model = build_model(cfg, dtype=torch.bfloat16, use_kernels=True,
                        device=dev, seed=1)
    x = torch.randn(8, 32, 32, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    y = (torch.arange(8) % 100).to(dev)
    before = bwd.by_entry.copy()
    state, m = make_train_step(StepConfig(num_classes=100))(
        TrainState.create(model, AdamW(1e-3)), (x, y),
        generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    assert dict(bwd.by_entry - before) == {OUTLOOK_MMA: 3}
    assert float(m["nonfinite"]) == 0.0 and torch.isfinite(m["loss"])


OUTLOOK_FWD_MMA, OUTLOOK_FWD_FMA = outlook_agg_mod.FORWARD_ENTRIES


def _outlook_fwd(fold):
    return ((outlook_branch, outlook_branch_reference) if fold else
            (outlook_agg_proj, outlook_agg_proj_reference))


def _check_outlook_fwd(dev, dtype, fold, B, H, W, Cin, C, heads, want_entry,
                       seed):
    """Two calls of the outlook forward at these shapes: the entry point
    ``want_entry`` launched twice, bitwise-equal outputs, close to the plain
    version per element and (bf16) at least 90% of them bitwise its."""
    g = torch.Generator().manual_seed(seed)
    args = _outlook_args(g, B, H, W, Cin, C, heads, fold, dev, dtype)
    fwd, ref = _outlook_fwd(fold)
    before = fwd.by_entry.copy()
    got = fwd(*args)
    again = fwd(*args)
    torch.cuda.synchronize()
    assert dict(fwd.by_entry - before) == {want_entry: 2}
    assert torch.equal(got, again), "two calls differ"
    want = ref(*args)
    _assert_close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert (got == want).float().mean().item() >= 0.9


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("B,H,W,Cin,C,heads", OUTLOOK_SHAPES + [
    (2, h, h, c, c, n) for h, c, n in OUTLOOK_MMA_SHAPES])
def test_outlook_forward_takes_the_tensor_core_kernel(dev, fold, B, H, W,
                                                     Cin, C, heads):
    if not fold:
        Cin = C
    # the card test's Cin = 40: refused, the FMA kernel
    want = OUTLOOK_FWD_FMA if Cin % 16 else OUTLOOK_FWD_MMA
    _check_outlook_fwd(dev, torch.bfloat16, fold, B, H, W, Cin, C, heads,
                       want, B + H + C + 2)
    # fp32 keeps the FMA kernel
    _check_outlook_fwd(dev, torch.float32, fold, B, H, W, Cin, C, heads,
                       OUTLOOK_FWD_FMA, B + H + C + 3)


@pytest.mark.parametrize("fold,H,C,heads", [
    (True, 4, 256, 8),     # the 7M model's stage 3: Wv and Wp do not fit
    (False, 8, 384, 6),    # Tiny-ImageNet's stage 3: Wp does not fit
])
def test_outlook_forward_keeps_the_fma_kernel_where_mma_does_not(dev, fold,
                                                                H, C,
                                                                heads):
    _check_outlook_fwd(dev, torch.bfloat16, fold, 4, H, H, C, C, heads,
                       OUTLOOK_FWD_FMA, 8)


@pytest.mark.parametrize("fold", [False, True])
def test_outlook_forward_entries_on_request(dev, fold):
    # the A/B of chip_smoke.py: either kernel at a shape both take, each
    # launching its own entry point, the two close; every layout the
    # tensor-core plan could pick agrees with the plan's bit for bit; the
    # tensor-core entry refuses fp32 and a pointer off 16 bytes
    g = torch.Generator().manual_seed(4)
    args = _outlook_args(g, 4, 32, 32, 64, 64, 2, fold, dev, torch.bfloat16)
    fwd, _ = _outlook_fwd(fold)
    full = list(args) if fold else [args[0], args[1], None, None, *args[2:]]
    name = fwd.__name__
    out = {}
    for entry in (OUTLOOK_FWD_MMA, OUTLOOK_FWD_FMA):
        before = fwd.by_entry.copy()
        out[entry] = outlook_agg_mod._launch_forward(entry, name, *full)
        torch.cuda.synchronize()
        assert dict(fwd.by_entry - before) == {entry: 1}
    _assert_close(out[OUTLOOK_FWD_MMA], out[OUTLOOK_FWD_FMA], torch.bfloat16)
    for rows in (1, 3, 4, 8):
        for chunk in (64, 32):
            plan = outlook_agg_mod._fwd_plan(4, 32, 32, 64, 64, 2, fold,
                                             rows, chunk)
            got = outlook_agg_mod._launch_forward(OUTLOOK_FWD_MMA, name,
                                                  *full, plan=plan)
            assert torch.equal(got, out[OUTLOOK_FWD_MMA]), (rows, chunk)
    f32 = [None if t is None else t.float() for t in full]
    with pytest.raises(ValueError, match="bf16 only"):
        outlook_agg_mod._launch_forward(OUTLOOK_FWD_MMA, name, *f32)
    x = torch.empty(full[0].numel() + 1, dtype=torch.bfloat16,
                    device=dev)[1:].view(full[0].shape)
    x.copy_(full[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        outlook_agg_mod._launch_forward(OUTLOOK_FWD_MMA, name, x, *full[1:])


@pytest.mark.parametrize("mode", ["fused_agg", "fused_agg_v"])
def test_model_b_bf16_forward_and_step_take_the_tensor_core_outlook_forward(
        dev, mode):
    # Model B (configs/cifar100_model_b.yaml's model) at batch 8 in bf16:
    # each front outlooker's forward (C = 64, 2 heads) on the new kernel,
    # served and in the train step
    cfg = {"type": "model_b", "num_classes": 100, "in_ch": 3, "stem_dim": 64,
           "outlooker_front_depth": 3, "dpr_max": 0.1, "use_pallas": mode,
           "stages": [
               {"dim": 64, "depth": 2, "num_heads": 2, "grid_size": 8,
                "outlook_heads": 2},
               {"dim": 128, "depth": 2, "num_heads": 4, "grid_size": 8,
                "outlook_heads": 4},
               {"dim": 256, "depth": 3, "num_heads": 8, "grid_size": 4,
                "outlook_heads": 8},
               {"dim": 384, "depth": 1, "num_heads": 6, "grid_size": 2,
                "outlook_heads": 6}]}
    fwd = _outlook_fwd(mode == "fused_agg_v")[0]
    model = build_model(cfg, dtype=torch.bfloat16, use_kernels=True,
                        device=dev, seed=1)
    x = torch.randn(8, 32, 32, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    y = (torch.arange(8) % 100).to(dev)
    before = fwd.by_entry.copy()
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    assert dict(fwd.by_entry - before) == {OUTLOOK_FWD_MMA: 3}
    assert torch.isfinite(logits.float()).all()
    before = fwd.by_entry.copy()
    state, m = make_train_step(StepConfig(num_classes=100))(
        TrainState.create(model, AdamW(1e-3)), (x, y),
        generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    assert dict(fwd.by_entry - before) == {OUTLOOK_FWD_MMA: 3}
    assert float(m["nonfinite"]) == 0.0 and torch.isfinite(m["loss"])


@pytest.mark.parametrize("mode", ["fused_agg", "fused_agg_v"])
def test_tiny_model_b_kernel_path_matches_plain_path(dev, mode):
    cfg = {"type": "model_b", "num_classes": 10, "stem_dim": 8,
           "outlooker_front_depth": 3, "dpr_max": 0.2, "use_pallas": mode,
           "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 4}]}
    fwd, bwd = ((outlook_branch, outlook_branch_backward)
                if mode == "fused_agg_v"
                else (outlook_agg_proj, outlook_agg_proj_backward))
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    y = (torch.arange(8) % 10).to(dev)
    out = {}
    for use_kernels in (True, False):
        model = build_model(cfg, use_kernels=use_kernels, device=dev, seed=5)
        before = fwd.launches
        with torch.inference_mode():
            logits = model(x.to(dev))
        assert fwd.launches - before == (3 if use_kernels else 0)
        paths = [m.path for m in model.modules()
                 if isinstance(m, DropPath) and m.rate > 0]
        masks = DropPathMasks({p: torch.arange(8, device=dev) % (i + 2) > 0
                               for i, p in enumerate(paths)})
        before = bwd.launches
        state, m = make_train_step(StepConfig(num_classes=10))(
            TrainState.create(model, AdamW(1e-3)), (x.to(dev), y),
            StepDraws(drop_masks=masks))
        torch.cuda.synchronize()
        assert bwd.launches - before == (3 if use_kernels else 0)
        out[use_kernels] = (logits, float(m["loss"]), {
            k: p.grad.clone() for k, p in model.named_parameters()})
    (lk, sk, gk), (lp, sp, gp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    assert abs(sk - sp) <= 1e-5 * abs(sp)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [t.norm() for t in gp.values()])).item()
    for k in gp:
        assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * gnorm, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,k", [
    (64, 32, 32, 64, 2, 3),    # Model B front at the serving batch
    (64, 16, 16, 96, 3, 3),    # Model A-7M stage 1
    (16, 64, 64, 64, 2, 3),    # Tiny-ImageNet stage 0
    (3, 13, 20, 48, 2, 5),     # K = 5, hd = 24, H != W, a ragged last block
])
def test_outlook_softmax_kernel_matches_plain(dev, dtype, B, H, W, C, heads,
                                              k):
    g = torch.Generator().manual_seed(B + H + C + k)
    v = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    logits = (2 * torch.randn(B, H, W, heads * k * k, generator=g)).to(
        dev, dtype)
    n = outlook_softmax_agg.launches
    got = outlook_softmax_agg(v, logits, heads, k)
    torch.cuda.synchronize()
    assert outlook_softmax_agg.launches == n + 1
    _assert_close(got, outlook_softmax_agg_reference(v, logits, heads, k),
                  dtype)


SOFTMAX_ROWS, SOFTMAX_OLD = outlook_softmax_mod.ENTRIES


def _softmax_args(B, H, W, C, heads, k, dev, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    logits = (2 * torch.randn(B, H, W, heads * k * k, generator=g)).to(
        dev, dtype)
    return v, logits


@pytest.mark.parametrize("B,H,W,C,heads", [
    (64, 32, 32, 64, 2),    # Model B front at the serving batch
    (64, 16, 16, 96, 3),    # Model A-7M stage 1
    (16, 64, 64, 64, 2),    # Tiny-ImageNet stage 0
    (3, 13, 20, 48, 2),     # hd = 24, H != W, a ragged last tile
    (5, 9, 7, 80, 2),       # hd = 40, a ragged run
    (4, 11, 5, 112, 2),     # hd = 56
    (7, 10, 12, 64, 2),     # 10 rows in the plan's tiles: a ragged last one
])
def test_outlook_softmax_rows_is_bitwise_the_plain_and_the_old_kernel(
        dev, B, H, W, C, heads):
    # bf16 at K = 3: csrc/outlook_softmax_rows.cu, twice, bitwise equal to
    # each other, to the plain version and to csrc/outlook_softmax.cu
    v, logits = _softmax_args(B, H, W, C, heads, 3, dev, torch.bfloat16,
                              B + H + W + C)
    before = outlook_softmax_agg.by_entry.copy()
    got = outlook_softmax_agg(v, logits, heads)
    again = outlook_softmax_agg(v, logits, heads)
    torch.cuda.synchronize()
    assert dict(outlook_softmax_agg.by_entry - before) == {SOFTMAX_ROWS: 2}
    assert torch.equal(got, again), "two calls differ"
    assert torch.equal(got, outlook_softmax_agg_reference(v, logits, heads))
    old = outlook_softmax_mod._launch(SOFTMAX_OLD, v, logits, heads)
    assert torch.equal(got, old)


@pytest.mark.parametrize("dtype,k,want", [
    (torch.bfloat16, 3, SOFTMAX_ROWS), (torch.float32, 3, SOFTMAX_OLD),
    (torch.bfloat16, 5, SOFTMAX_OLD), (torch.float32, 5, SOFTMAX_OLD)])
def test_outlook_softmax_routes_by_dtype_and_k(dev, dtype, k, want):
    v, logits = _softmax_args(4, 32, 32, 64, 2, k, dev, dtype, k)
    before = outlook_softmax_agg.by_entry.copy()
    got = outlook_softmax_agg(v, logits, 2, k)
    torch.cuda.synchronize()
    assert dict(outlook_softmax_agg.by_entry - before) == {want: 1}
    assert torch.equal(got, outlook_softmax_agg_reference(v, logits, 2, k))


def test_outlook_softmax_rows_every_layout_and_logits_alignment(dev):
    # every (rows, pix) layout the kernel takes gives the plan's output bit
    # for bit; logits copied 16, 4 and 2 bytes at a time (a [*, 18] tensor
    # at a 16-byte address, a W * 18 that is not a multiple of 8, one
    # element off) give the same
    v, logits = _softmax_args(3, 9, 12, 64, 2, 3, dev, torch.bfloat16, 9)
    want = outlook_softmax_agg(v, logits, 2)
    for rows in (1, 2, 3, 4, 9):
        for pix in outlook_softmax_mod.PIX_RUNS:
            plan = outlook_softmax_mod._rows_plan(3, 9, 12, 64, 2, rows, pix)
            got = outlook_softmax_mod._launch(SOFTMAX_ROWS, v, logits, 2,
                                              plan=plan)
            assert torch.equal(got, want), (rows, pix)
    v5, l5 = _softmax_args(2, 6, 5, 32, 2, 3, dev, torch.bfloat16, 5)
    off = torch.empty(l5.numel() + 1, dtype=l5.dtype, device=dev)[1:]
    off = off.view(l5.shape)
    off.copy_(l5)
    want = outlook_softmax_agg_reference(v5, l5, 2)
    for lg in (l5, off):
        got = outlook_softmax_mod._launch(SOFTMAX_ROWS, v5, lg, 2)
        assert torch.equal(got, want)


def test_outlook_softmax_rows_refuses_what_it_does_not_take(dev):
    v, logits = _softmax_args(2, 8, 8, 64, 2, 3, dev, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="bf16 only"):
        outlook_softmax_mod._launch(SOFTMAX_ROWS, v.float(), logits.float(),
                                    2)
    with pytest.raises(ValueError, match="K = 3 only"):
        outlook_softmax_mod._launch(SOFTMAX_ROWS, v, torch.zeros(
            2, 8, 8, 50, dtype=v.dtype, device=dev), 2, 5)
    x = torch.empty(v.numel() + 1, dtype=v.dtype, device=dev)[1:]
    x = x.view(v.shape)
    x.copy_(v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        outlook_softmax_mod._launch(SOFTMAX_ROWS, x, logits, 2)
    # the entry point itself refuses a plan it does not match
    plan = outlook_softmax_mod.outlook_softmax_plan(2, 8, 8, 64, 2)
    out = torch.empty_like(v)
    lib = kernel_build.load()
    stream = torch.cuda.current_stream().cuda_stream
    args = dict(B=2, H=8, W=8, C=64, heads=2, rows=plan.rows, pix=plan.pix,
                dtype=1, blocks=plan.blocks, smem=plan.smem)

    def call(**kw):
        a = {**args, **kw}
        return lib.ogvt_outlook_softmax_rows(
            v.data_ptr(), logits.data_ptr(), out.data_ptr(), a["B"], a["H"],
            a["W"], a["C"], a["heads"], a["rows"], a["pix"], a["dtype"],
            a["blocks"], a["smem"], stream)

    assert call() == 0
    torch.cuda.synchronize()
    for bad in ({"dtype": 0}, {"pix": 3}, {"smem": plan.smem + 16},
                {"blocks": plan.tiles + 1}, {"blocks": 0}, {"C": 48},
                {"heads": 4}):
        assert call(**bad) != 0, bad


def test_model_b_o_bf16_serve_and_step_take_the_row_kernel(dev):
    # Model B (configs/cifar100_model_b.yaml's model) with use_pallas
    # fused_outlook at batch 8 in bf16: each front outlooker's softmax +
    # aggregate (C = 64, 2 heads) on csrc/outlook_softmax_rows.cu, served
    # and in the train step (its backward is autograd, no kernel)
    cfg = {"type": "model_b", "num_classes": 100, "in_ch": 3, "stem_dim": 64,
           "outlooker_front_depth": 3, "dpr_max": 0.1,
           "use_pallas": "fused_outlook", "stages": [
               {"dim": 64, "depth": 2, "num_heads": 2, "grid_size": 8,
                "outlook_heads": 2},
               {"dim": 128, "depth": 2, "num_heads": 4, "grid_size": 8,
                "outlook_heads": 4},
               {"dim": 256, "depth": 3, "num_heads": 8, "grid_size": 4,
                "outlook_heads": 8},
               {"dim": 384, "depth": 1, "num_heads": 6, "grid_size": 2,
                "outlook_heads": 6}]}
    model = build_model(cfg, dtype=torch.bfloat16, use_kernels=True,
                        device=dev, seed=1)
    x = torch.randn(8, 32, 32, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    y = (torch.arange(8) % 100).to(dev)
    before = outlook_softmax_agg.by_entry.copy()
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    assert dict(outlook_softmax_agg.by_entry - before) == {SOFTMAX_ROWS: 3}
    assert torch.isfinite(logits.float()).all()
    before = outlook_softmax_agg.by_entry.copy()
    state, m = make_train_step(StepConfig(num_classes=100))(
        TrainState.create(model, AdamW(1e-3)), (x, y),
        generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    assert dict(outlook_softmax_agg.by_entry - before) == {SOFTMAX_ROWS: 3}
    assert float(m["nonfinite"]) == 0.0 and torch.isfinite(m["loss"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", [
    (128, 32, 32, 192),   # Model A-7M stage 0 at the train batch
    (128, 64, 64, 256),   # Tiny-ImageNet stage 0
    (128, 4, 4, 1536),    # Model B stage 3
    (128, 4, 4, 1792),    # a_base stage 3
    (128, 6, 6, 1024),    # a7m_48 stage 3
    (2, 13, 9, 64),       # H not a multiple of the backward plan's rows
    (1, 32, 32, 256),     # B = 1
    (3, 5, 7, 20),        # C not a multiple of the vector width, H != W
    (128, 96, 96, 192),   # a7m_96 stage 0: the widest rows either plan tiles
    (64, 12, 12, 1024),   # a7m_96 stage 3 at the serving batch
])
def test_dwconv_kernels_match_plain(dev, dtype, B, H, W, C):
    """The forward bit for bit (each product and sum rounded as the plain
    version rounds it), the backward within the tolerances and bitwise
    across two calls."""
    g = torch.Generator().manual_seed(B + H + C)
    x = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    w9 = (torch.randn(9, C, generator=g) / 3).to(dev, dtype)
    dy = torch.randn(B, H, W, C, generator=g).to(dev, dtype)
    n = (dwconv3x3.launches, dwconv3x3_backward.by_variant["bwd"])
    got = dwconv3x3(x, w9)
    grads = dwconv3x3_backward(x, w9, dy, "bwd")
    again = dwconv3x3_backward(x, w9, dy, "bwd")
    torch.cuda.synchronize()
    assert (dwconv3x3.launches, dwconv3x3_backward.by_variant["bwd"]) == \
        (n[0] + 1, n[1] + 2)
    assert torch.equal(got, dwconv3x3_reference(x, w9))
    want = dwconv3x3_backward_reference(x, w9, dy)
    for name, a, b in zip(("dx", "dw"), grads, again):
        assert torch.equal(a, b), f"{name} differs between two calls"
    _assert_close(grads[0], want[0], dtype)
    _assert_close_to_max(grads[1], want[1], dtype, "dw")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwconv_backward_takes_a_pointer_off_by_one_element(dev, dtype):
    """x, dy and dx one element past a 16-byte boundary (slices of larger
    buffers): the backward runs its one-element copy path and matches."""
    B, H, W, C = 4, 8, 8, 64
    g = torch.Generator().manual_seed(7)
    n = B * H * W * C

    def sliced(scale=1.0):
        buf = (torch.randn(n + 1, generator=g) * scale).to(dev, dtype)
        return buf[1:].view(B, H, W, C)

    x, dy = sliced(), sliced()
    w9 = (torch.randn(9, C, generator=g) / 3).to(dev, dtype)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    launches = dwconv3x3_backward.launches
    dx, dw = dwconv3x3_backward(x, w9, dy, "t")
    torch.cuda.synchronize()
    assert dwconv3x3_backward.launches == launches + 1
    want = dwconv3x3_backward_reference(x, w9, dy)
    _assert_close(dx, want[0], dtype)
    _assert_close_to_max(dw, want[1], dtype, "dw")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwconv_forward_takes_a_pointer_off_by_one_element(dev, dtype):
    """x and y one element past a 16-byte boundary (slices of larger
    buffers): the forward runs its one-element copy path and matches the
    plain version bit for bit."""
    B, H, W, C = 4, 8, 8, 64
    g = torch.Generator().manual_seed(8)
    x = torch.randn(B * H * W * C + 1, generator=g).to(dev, dtype)[1:] \
        .view(B, H, W, C)
    w9 = (torch.randn(9, C, generator=g) / 3).to(dev, dtype)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    launches = dwconv3x3.launches
    got = dwconv3x3(x, w9)
    torch.cuda.synchronize()
    assert dwconv3x3.launches == launches + 1
    assert torch.equal(got, dwconv3x3_reference(x, w9))


def test_dwconv_forward_entry_refuses_a_plan_it_cannot_take(dev):
    """``ogvt_dwconv3x3`` checks the plan it is handed: shared bytes that
    are not the plan's, a band taller or wider than the map, a chunk of
    channels that is not a power of two of threads, 16-byte copies of a C
    or a pointer that does not allow them."""
    B, H, W, C = 2, 8, 8, 64
    x = torch.randn(B, H, W, C, device=dev, dtype=torch.bfloat16)
    w9 = torch.randn(9, C, device=dev, dtype=torch.bfloat16)
    y = torch.empty_like(x)
    p = dwconv3x3_forward_plan(B, H, W, C, 2)
    lib = kernel_build.load()

    def call(x=x, y=y, C=C, rows=p.rows, tw=p.tw, chunk=p.chunk,
             smem=p.smem_bytes, vecio=1):
        err = lib.ogvt_dwconv3x3(
            x.data_ptr(), w9.data_ptr(), y.data_ptr(), B, H, W, C, rows, tw,
            chunk, p.bands, p.parts, smem, vecio, 1,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return err

    assert call() == 0
    for bad in ({"smem": p.smem_bytes + 2}, {"rows": H + 1}, {"tw": W + 1},
                {"chunk": 48}, {"C": 60}, {"y": y.view(-1)[1:]}):
        assert call(**bad) != 0, bad


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    v = torch.randn(2, 4, 8, 16, device=dev)
    logits = torch.randn(2, 4, 8, 18, device=dev)
    with pytest.raises(TypeError, match="float16"):
        outlook_softmax_agg(v.half(), logits.half(), 2)
    with pytest.raises(ValueError, match="logits are"):
        outlook_softmax_agg(v, logits.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        outlook_softmax_agg(v, torch.randn(2, 4, 18, 8, device=dev)
                            .transpose(2, 3), 2)
    with pytest.raises(ValueError, match="shared memory"):
        outlook_softmax_agg(v, torch.randn(2, 4, 8, 8 * 17 * 17, device=dev),
                            8, 17)
    x, w9 = torch.randn(2, 4, 8, 16, device=dev), torch.randn(9, 16,
                                                              device=dev)
    with pytest.raises(TypeError, match="float16"):
        dwconv3x3(x.half(), w9.half())
    with pytest.raises(ValueError, match="w9 is"):
        dwconv3x3(x, w9.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        dwconv3x3(x, torch.randn(16, 9, device=dev).t())
    with pytest.raises(ValueError, match="dy is"):
        dwconv3x3_backward(x, w9, x[:1])
    with pytest.raises(ValueError, match="variant"):
        dwconv3x3_backward(x, w9, x, "xla")


@pytest.mark.parametrize("model_type,use_pallas,dwconv", [
    ("model_b", "fused_outlook", "t"), ("model_a", None, "bwd")])
def test_tiny_model_depthwise_modes_kernel_path_matches_plain_path(
        dev, model_type, use_pallas, dwconv):
    cfg = {"type": model_type, "num_classes": 10, "stem_dim": 8,
           "outlooker_front_depth": 3, "dpr_max": 0.2,
           "use_pallas": use_pallas, "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 4}]}
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(6))
    y = (torch.arange(8) % 10).to(dev)
    counters = (outlook_softmax_agg, dwconv3x3)
    fwd = [3 if use_pallas else 0, 2 if dwconv == "t" else 0]
    out = {}
    for use_kernels in (True, False):
        model = build_model(cfg, use_kernels=use_kernels, device=dev, seed=7,
                            dwconv=dwconv)
        before = [c.launches for c in counters]
        with torch.inference_mode():
            logits = model(x.to(dev))
        assert [c.launches - b for c, b in zip(counters, before)] == \
            (fwd if use_kernels else [0, 0])
        paths = [m.path for m in model.modules()
                 if isinstance(m, DropPath) and m.rate > 0]
        masks = DropPathMasks({p: torch.arange(8, device=dev) % (i + 2) > 0
                               for i, p in enumerate(paths)})
        before = dwconv3x3_backward.by_variant[dwconv]
        state, m = make_train_step(StepConfig(num_classes=10))(
            TrainState.create(model, AdamW(1e-3)), (x.to(dev), y),
            StepDraws(drop_masks=masks))
        torch.cuda.synchronize()
        assert dwconv3x3_backward.by_variant[dwconv] - before == \
            (2 if use_kernels else 0)
        out[use_kernels] = (logits, float(m["loss"]), {
            k: p.grad.clone() for k, p in model.named_parameters()})
    (lk, sk, gk), (lp, sp, gp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    assert abs(sk - sp) <= 1e-5 * abs(sp)
    gnorm = torch.linalg.vector_norm(torch.stack(
        [t.norm() for t in gp.values()])).item()
    for k in gp:
        assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * gnorm, k


# ---- #6, the block-packed grid core ----------------------------------------

def _packed_entries():
    bwd = grid_mhsa_packed_backward.by_entry
    return (grid_mhsa_packed.by_entry["ogvt_grid_mhsa_packed_mma"],
            bwd["ogvt_grid_mhsa_packed_mma_bwd"],
            grid_mhsa_packed.by_entry["ogvt_grid_mhsa_packed"],
            bwd["ogvt_grid_mhsa_packed_bwd"])


def _check_packed(dev, dtype, G, N, C, heads, seed):
    """Both #6 launches against their plain versions, the backward twice
    bitwise equal; bf16 through csrc/grid_mhsa_packed_mma.cu's entry
    points, fp32 through csrc/grid_mhsa_packed.cu's."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(G, N, 3 * C, generator=g).to(dev, dtype)
    dout = torch.randn(G, N, C, generator=g).to(dev, dtype)
    n = (grid_mhsa_packed.launches, grid_mhsa_packed_backward.launches)
    entries = _packed_entries()
    got = grid_mhsa_packed(qkv, heads)
    dqkv = grid_mhsa_packed_backward(qkv, dout, heads)
    again = grid_mhsa_packed_backward(qkv, dout, heads)
    torch.cuda.synchronize()
    assert (grid_mhsa_packed.launches, grid_mhsa_packed_backward.launches) \
        == (n[0] + 1, n[1] + 2)
    step = (1, 2, 0, 0) if dtype == torch.bfloat16 else (0, 0, 1, 2)
    assert _packed_entries() == tuple(a + b for a, b in zip(entries, step))
    assert torch.equal(dqkv, again)
    _assert_close(got, grid_mhsa_packed_reference(qkv, heads), dtype)
    _assert_close(dqkv, grid_mhsa_packed_backward_reference(qkv, dout, heads),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,C,heads", [
    (8192, 36, 48, 2),   # Model A-7M at 48 px, stage 0, train batch 128
    (4096, 36, 48, 2),   # and serving batch 64
    (4, 1, 8, 1), (7, 17, 40, 5), (3, 63, 64, 1), (5, 25, 448, 8)])
def test_grid_mhsa_packed_kernels_match_plain(dev, dtype, G, N, C, heads):
    _check_packed(dev, dtype, G, N, C, heads, G + N + C)


@pytest.mark.parametrize("hd", [8, 24, 56, 64])
@pytest.mark.parametrize("N", [17, 33, 48, 49, 63])
def test_grid_mhsa_packed_mma_at_every_row_tiling(dev, N, hd):
    # 2, 3 and 4 m16 row tiles; a key tail of 8 (N = 17, 33, 49) or none
    # (48); the hd k8 tail at hd 24 and 56; 3 heads, so a block's units
    # span grids
    _check_packed(dev, torch.bfloat16, 11, N, 3 * hd, 3, N * hd)


def test_grid_mhsa_packed_mma_refuses_what_it_does_not_take(dev):
    x = torch.randn(2, 36, 3 * 24, device=dev).bfloat16()  # hd = 12
    with pytest.raises(ValueError, match="N=36, C=24, heads=2"):
        grid_mhsa_packed(x, 2)
    with pytest.raises(ValueError, match="N=36, C=24, heads=2"):
        grid_mhsa_packed_backward(x, x[..., :24].contiguous(), 2)
    # fp32 takes csrc/grid_mhsa_packed.cu, which takes any head width
    x = x.float()
    _assert_close(grid_mhsa_packed(x, 2), grid_mhsa_packed_reference(x, 2),
                  torch.float32)


# ---- #6 for 64 <= N <= 256: csrc/grid_mhsa_long.cu ------------------------

LONG_ENTRIES = ("ogvt_grid_mhsa_long", "ogvt_grid_mhsa_long_bwd")


def _entries_of(fwd_entry, bwd_entry):
    return (grid_mhsa_packed.by_entry[fwd_entry],
            grid_mhsa_packed_backward.by_entry[bwd_entry])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 24, 32, 64])
@pytest.mark.parametrize("N", [64, 65, 100, 144, 200, 256])
def test_grid_mhsa_long_kernels_match_plain(dev, dtype, N, hd):
    """Both launches of csrc/grid_mhsa_long.cu against their plain versions
    (2 heads, so a block's unit is one head of a grid; 3 grids), the
    backward twice bitwise equal, each through the long entry points."""
    g = torch.Generator().manual_seed(N * 100 + hd)
    C = 2 * hd
    qkv = torch.randn(3, N, 3 * C, generator=g).to(dev, dtype)
    dout = torch.randn(3, N, C, generator=g).to(dev, dtype)
    before = _entries_of(*LONG_ENTRIES)
    got = grid_mhsa_packed(qkv, 2)
    dqkv = grid_mhsa_packed_backward(qkv, dout, 2)
    again = grid_mhsa_packed_backward(qkv, dout, 2)
    torch.cuda.synchronize()
    assert _entries_of(*LONG_ENTRIES) == (before[0] + 1, before[1] + 2)
    assert torch.equal(dqkv, again)
    _assert_close(got, grid_mhsa_packed_reference(qkv, 2), dtype)
    _assert_close(dqkv, grid_mhsa_packed_backward_reference(qkv, dout, 2),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [36, 63, 64, 144, 256])
def test_grid_mhsa_packed_entry_point_by_n(dev, dtype, N):
    """N <= 63 takes csrc/grid_mhsa_packed_mma.cu (bf16) or
    csrc/grid_mhsa_packed.cu (fp32), N >= 64 csrc/grid_mhsa_long.cu."""
    short = ("ogvt_grid_mhsa_packed_mma", "ogvt_grid_mhsa_packed_mma_bwd") \
        if dtype == torch.bfloat16 else ("ogvt_grid_mhsa_packed",
                                         "ogvt_grid_mhsa_packed_bwd")
    want = LONG_ENTRIES if N >= 64 else short
    other = short if N >= 64 else LONG_ENTRIES
    qkv = torch.randn(2, N, 3 * 48, device=dev).to(dtype)
    before, before_other = _entries_of(*want), _entries_of(*other)
    grid_mhsa_packed(qkv, 2)
    grid_mhsa_packed_backward(qkv, qkv[..., :48].contiguous(), 2)
    assert _entries_of(*want) == (before[0] + 1, before[1] + 1)
    assert _entries_of(*other) == before_other


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_past_the_fused_branch_trains_on_the_card(dev, dtype):
    """The 7M model's stage 0 at 96 px: grids of N = 144, C = 48, 2 heads,
    which #5 cannot hold (its backward needs 406,656 shared bytes). The
    module routes them to #6's long kernel both ways, and its output and
    gradients match the plain path's."""
    x = torch.randn(2, 96, 96, 48, generator=torch.Generator().manual_seed(3))
    out = {}
    for use_kernels in (True, False):
        mhsa = MultiHeadSelfAttention(48, 2, dtype=dtype,
                                      use_kernels=use_kernels, device=dev)
        ln = LayerNorm(48, 1e-5, device=dev)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in (*mhsa.parameters(), *ln.parameters()):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        before = _entries_of(*LONG_ENTRIES)
        xin = x.to(dev, dtype).requires_grad_(True)
        y = mhsa(xin, ln, 8)
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        assert _entries_of(*LONG_ENTRIES) == (
            (before[0] + 1, before[1] + 1) if use_kernels else before)
        out[use_kernels] = [y.detach(), xin.grad] + [
            p.grad for p in (*mhsa.parameters(), *ln.parameters())]
    for got, want in zip(out[True], out[False]):
        assert torch.isfinite(got.float()).all()
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype] * max(scale, 1.0), (err, scale)


# ---- #12, the fused branch on the NHWC map ---------------------------------

def _windows(t, g):
    grids, meta = grid_partition(t, g)
    G, Hg, Wg, C = grids.shape
    return grids.reshape(G, Hg * Wg, C).contiguous(), meta, (G, Hg, Wg, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,g", [
    (128, 32, 32, 80, 2, 4),  # cifar100_model_a stage 0, train batch 128
    (2, 16, 16, 64, 2, 2), (2, 8, 16, 48, 2, 4), (3, 12, 20, 24, 4, 2)])
def test_attn_branch_nhwc_kernels_match_plain_and_attn_branch(
        dev, dtype, B, H, W, C, heads, g):
    gen = torch.Generator().manual_seed(B + H + W + C)
    args = _branch_args(gen, B, H * W, C, dev, dtype)
    args = (args[0].reshape(B, H, W, C), *args[1:])
    dy = torch.randn(B, H, W, C, generator=gen).to(dev, dtype)
    n = (attn_branch_nhwc.launches, attn_branch_nhwc_backward.launches)
    got = attn_branch_nhwc(*args, heads, g)
    grads = attn_branch_nhwc_backward(*args, dy, heads, g)
    again = attn_branch_nhwc_backward(*args, dy, heads, g)
    torch.cuda.synchronize()
    assert (attn_branch_nhwc.launches, attn_branch_nhwc_backward.launches) \
        == (n[0] + 1, n[1] + 2)
    _assert_close(got, attn_branch_nhwc_reference(*args, heads, g), dtype)
    want = attn_branch_nhwc_backward_reference(*args, dy, heads, g)
    for name, a, b, w in zip(BRANCH_GRADS, grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        if name == "dx":
            _assert_close(a, w, dtype)
        else:
            _assert_close_to_max(a, w, dtype, name)
    # #5 on the partitioned tokens: the same blocks in the same order
    x, meta, shape = _windows(args[0], g)
    tokens = attn_branch(x, *args[1:], heads)
    assert torch.equal(got, grid_unpartition(tokens.reshape(shape), meta))
    tgrads = attn_branch_backward(x, *args[1:], _windows(dy, g)[0], heads)
    assert torch.equal(grads[0],
                       grid_unpartition(tgrads[0].reshape(shape), meta))
    for name, a, t in zip(BRANCH_GRADS[1:], grads[1:], tgrads[1:]):
        assert torch.equal(a, t), name


def test_packed_and_nhwc_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError, match="N=257"):
        grid_mhsa_packed(torch.randn(2, 257, 48, device=dev), 2)
    with pytest.raises(ValueError, match="shared memory"):
        grid_mhsa_packed(torch.randn(2, 63, 3 * 1024, device=dev), 1)
    with pytest.raises(ValueError, match="dout"):
        grid_mhsa_packed_backward(torch.randn(2, 36, 48, device=dev),
                                  torch.randn(2, 36, 8, device=dev), 2)
    args = _branch_args(torch.Generator().manual_seed(1), 2, 64, 16, dev,
                        torch.float32)
    x = args[0].reshape(2, 8, 8, 16)
    with pytest.raises(ValueError, match="divisible by grid_size"):
        attn_branch_nhwc(x, *args[1:], 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        attn_branch_nhwc(x.transpose(1, 2), *args[1:], 2, 2)
    with pytest.raises(ValueError, match="dy"):
        attn_branch_nhwc_backward(x, *args[1:], x[:1], 2, 2)


@pytest.mark.parametrize("img,kernel,attn_nhwc", [
    (12, grid_mhsa_packed, False), (16, attn_branch_nhwc, True)])
def test_tiny_models_through_packed_and_nhwc_match_plain_path(
        dev, img, kernel, attn_nhwc):
    # grid 2: stage 0 has grids of N=36 (12 px, #6) or N=64 (16 px, #12)
    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8,
           "dpr_max": 0.0, "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 4}]}
    x = torch.randn(4, img, img, 3, generator=torch.Generator().manual_seed(2))
    out = {}
    for use_kernels in (True, False):
        model = build_model(cfg, use_kernels=use_kernels, device=dev, seed=5,
                            attn_nhwc=attn_nhwc).train()
        before = kernel.launches
        logits = model(x.to(dev))
        assert kernel.launches - before == (1 if use_kernels else 0)
        logits.square().sum().backward()
        out[use_kernels] = (logits.detach(), {
            k: p.grad.clone() for k, p in model.named_parameters()})
    (lk, gk), (lp, gp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for k in gp:
        scale = gp[k].abs().max().item()
        assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * max(scale, 1.0), k


def test_use_pallas_false_launches_no_kernel(dev):
    cfg = {"type": "model_a", "num_classes": 10, "stem_dim": 8,
           "use_pallas": False, "stages": [
               {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 2},
               {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                "outlook_heads": 4}]}
    counters = (grid_mhsa, grid_mhsa_packed, attn_branch, attn_branch_nhwc,
                mlp_branch)
    for img in (8, 12, 16):  # N = 16, 36, 64 at stage 0
        model = build_model(cfg, use_kernels=True, device=dev,
                            attn_nhwc=True)
        before = [c.launches for c in counters]
        with torch.inference_mode():
            logits = model(torch.randn(2, img, img, 3, device=dev))
        assert [c.launches for c in counters] == before
        assert torch.isfinite(logits).all()


# ---- the training entry point: eval graph, prefetcher, loop ---------------

LOOP_CFG = {"type": "model_a", "num_classes": 10, "stem_dim": 16,
            "dpr_max": 0.1, "stages": [
                {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
                 "outlook_heads": 2},
                {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                 "outlook_heads": 2}]}
LOOP_NORM = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))


def test_eval_graph_is_bitwise_eager_steps_before_and_after_a_step(dev):
    from outgridvit_tpu_torch.ops.augment import AugmentConfig
    from outgridvit_tpu_torch.training.steps import (
        EvalSuperstep,
        make_eval_step,
        make_eval_superstep,
    )

    model = build_model(LOOP_CFG, dtype=torch.bfloat16, device=dev, seed=1)
    state = TrainState.create(model, AdamW(1e-2))
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (4, 16, 16, 16, 3), dtype=torch.uint8,
                      generator=g).to(dev)
    y = torch.randint(0, 10, (4, 16), generator=g).to(dev, torch.int32)
    superstep = make_eval_superstep(model, normalize=LOOP_NORM, k=4)
    eager = make_eval_step(model, normalize=LOOP_NORM)
    step = make_train_step(StepConfig(
        num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.5,
        augment=AugmentConfig(*LOOP_NORM, crop_pad=2)))
    counts = grid_mhsa.launches, mlp_branch.launches
    outs = []
    for _ in range(2):
        replays = EvalSuperstep.replays
        got = superstep((x, y))
        assert EvalSuperstep.replays == replays + 1
        for i in range(4):
            for k, v in eager((x[i], y[i])).items():
                assert torch.equal(got[k][i], v), (k, i)
        outs.append(got)
        state, _ = step(state, (x[0], y[0]), seed=0)  # in-place update
    assert not torch.equal(outs[0]["loss"], outs[1]["loss"])
    assert len(superstep.graphs) == 1  # one capture, two replays
    assert grid_mhsa.launches > counts[0] and mlp_branch.launches > counts[1]


def test_prefetcher_delivers_batches_unchanged_to_the_card(dev):
    import numpy as np

    from outgridvit_tpu_torch.data.pipeline import Prefetcher

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(5)]
    batches.append((rng.standard_normal((3, 8, 16, 16, 3)).astype(
        np.float32), rng.integers(0, 10, (3, 8)).astype(np.int32)))
    got = []
    for x, y in Prefetcher(iter(batches), dev, depth=2):
        assert x.is_cuda and y.is_cuda
        torch.cuda._sleep(1_000_000)  # the consumer's stream is busy
        got.append((x.cpu().numpy(), y.cpu().numpy()))
    assert len(got) == len(batches)
    for (x, y), (xn, yn) in zip(got, batches):
        assert x.dtype == xn.dtype and x.shape == xn.shape
        np.testing.assert_array_equal(x, xn)
        np.testing.assert_array_equal(y, yn)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(Prefetcher(broken(), dev))


def test_train_model_two_epochs_launches_the_grid_and_mlp_kernels(
        dev, tmp_path):
    import math

    from outgridvit_tpu_torch.data.datasets import (
        get_synthetic_structured_dataloaders,
    )
    from outgridvit_tpu_torch.training.loop import train_model
    from outgridvit_tpu_torch.training.steps import EvalSuperstep

    train, val, _ = get_synthetic_structured_dataloaders(
        batch_size=16, num_samples=120, img_size=16, num_classes=10,
        seed=0, val_split=0.4)  # 72 / 48: 4 full + ragged, 3 full
    model = build_model(LOOP_CFG, dtype=torch.bfloat16, device=dev, seed=2)
    wrappers = (grid_mhsa, grid_mhsa_backward, mlp_branch,
                mlp_branch_backward)
    before = [w.launches for w in wrappers]
    replays = EvalSuperstep.replays
    hist, state = train_model(
        model, train, epochs=2, val_loader=val, device="cuda",
        autocast_dtype="bf16", print_every=2, num_classes=10,
        mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.5, early_stop=False,
        save_path=str(tmp_path / "b.ckpt"), last_path=str(tmp_path / "l.ckpt"),
        steps_per_dispatch=2)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    assert EvalSuperstep.replays == replays + 2  # one full K-group an epoch
    assert state.step == 2 * len(train) == 10
    assert all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])
    assert hist["train_mem_alloc_gib"][0] > 0
    assert (tmp_path / "l.ckpt").exists()


# ---- the train superstep: K train steps in one CUDA graph -----------------

def _train_tensors(state):
    return ([t.detach() for t in state.model.state_dict().values()]
            + [*state.opt_state.mu.values(), *state.opt_state.nu.values(),
               state.opt_state.count, state.device_step])


def _loop_step_cfg():
    from outgridvit_tpu_torch.ops.augment import AugmentConfig

    return StepConfig(num_classes=10, mixup_alpha=0.8, cutmix_alpha=1.0,
                      mix_prob=0.5,
                      augment=AugmentConfig(*LOOP_NORM, crop_pad=2))


def _loop_state(dev, seed=1):
    from outgridvit_tpu_torch.training.optim import warmup_cosine_lr

    sched = warmup_cosine_lr(1e-2, 40, 4, 1e-4)
    model = build_model(LOOP_CFG, dtype=torch.bfloat16, device=dev,
                        seed=seed)
    return TrainState.create(model, AdamW(sched, 0.05, 1.0)), sched


def test_train_graph_is_bitwise_eager_steps(dev):
    """Two K = 3 groups of the tiny bf16 model on the kernel path: the
    replayed graph against 3 eager steps each, from identical states, on
    the same batches and seed: parameters, BN statistics, mu, nu, count,
    the device step and every metric bitwise."""
    from outgridvit_tpu_torch.training.steps import (
        TrainSuperstep,
        make_train_superstep,
    )

    cfg = _loop_step_cfg()
    eager_state, sched = _loop_state(dev)
    graph_state, _ = _loop_state(dev)
    step = make_train_step(cfg, sched)
    superstep = make_train_superstep(cfg, sched, k=3)
    g = torch.Generator().manual_seed(3)
    counts = (grid_mhsa_backward.launches, mlp_branch_backward.launches)
    for _ in range(2):
        x = torch.randint(0, 256, (3, 16, 16, 16, 3), dtype=torch.uint8,
                          generator=g).to(dev)
        y = torch.randint(0, 10, (3, 16), generator=g).to(dev, torch.int32)
        ms = []
        for i in range(3):
            eager_state, m = step(eager_state, (x[i], y[i]), seed=7)
            ms.append(m)
        replays = TrainSuperstep.replays
        graph_state, got = superstep(graph_state, (x, y), seed=7)
        assert TrainSuperstep.replays == replays + 1
        assert graph_state.step == eager_state.step
        assert set(got) == set(ms[0])
        for k in got:
            assert torch.equal(got[k], torch.stack([m[k] for m in ms])), k
        for a, b in zip(_train_tensors(graph_state),
                        _train_tensors(eager_state)):
            assert torch.equal(a, b)
    assert int(graph_state.device_step) == graph_state.step == 6
    assert len(superstep.prepared) == 1  # one capture, two replays
    assert grid_mhsa_backward.launches > counts[0]
    assert mlp_branch_backward.launches > counts[1]


def test_train_superstep_captures_a_graph_per_shape(dev):
    from outgridvit_tpu_torch.training.steps import (
        TrainSuperstep,
        make_train_superstep,
    )

    state, sched = _loop_state(dev, seed=2)
    superstep = make_train_superstep(_loop_step_cfg(), sched, k=2)
    replays = TrainSuperstep.replays
    for b in (16, 8, 16):
        x = torch.randint(0, 256, (2, b, 16, 16, 3), dtype=torch.uint8,
                          device=dev)
        y = torch.randint(0, 10, (2, b), device=dev, dtype=torch.int32)
        state, m = superstep(state, (x, y), seed=0)
        assert m["loss"].shape == (2,) and torch.isfinite(m["loss"]).all()
    assert len(superstep.prepared) == 2
    assert all(p.graph is not None for p in superstep.prepared.values())
    assert TrainSuperstep.replays == replays + 3
    assert state.step == int(state.device_step) == 6


def test_train_model_on_the_card_k2_is_bitwise_k1(dev, tmp_path):
    """The full recipe (device augmentation, mixup/cutmix, drop-path) over
    2 epochs: K = 2, full groups through the train graph and a ragged tail
    eagerly, bitwise K = 1 in every history entry but device memory, and
    in the final state."""
    import numpy as np

    from outgridvit_tpu_torch.data.datasets import (
        get_synthetic_structured_dataloaders,
    )
    from outgridvit_tpu_torch.training.loop import train_model
    from outgridvit_tpu_torch.training.steps import TrainSuperstep

    runs = []
    for k in (1, 2):
        train, val, _ = get_synthetic_structured_dataloaders(
            batch_size=16, num_samples=120, img_size=16, num_classes=10,
            seed=0, val_split=0.4, device_augment=True)  # 4 full + ragged
        model = build_model(LOOP_CFG, dtype=torch.bfloat16, device=dev,
                            seed=2)
        replays = TrainSuperstep.replays
        runs.append(train_model(
            model, train, epochs=2, val_loader=val, device="cuda",
            autocast_dtype="bf16", print_every=2, num_classes=10,
            mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.5,
            early_stop=False, seed=4, save_path=str(tmp_path / f"b{k}"),
            last_path=str(tmp_path / f"l{k}"), steps_per_dispatch=k))
        assert TrainSuperstep.replays == replays + (0 if k == 1 else 4)
    (h1, s1), (h2, s2) = runs
    for key in h1:
        if "_mem_" not in key:
            np.testing.assert_array_equal(h2[key], h1[key], err_msg=key)
    assert s1.step == s2.step == int(s2.device_step) == 10
    for a, b in zip(_train_tensors(s2), _train_tensors(s1)):
        assert torch.equal(a, b)


# ---- the ogvt:: custom ops, the exported predictor, the robustness sweep --

def _ogvt_case(name, dev):
    """(wrapper, args) of an ogvt:: op at a bf16 shape its tensor-core
    kernel takes (C = 64, hd = 32, N = 16 / 36 / 64)."""
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16

    def r(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    C = 64
    ln = (r(C, scale=0.1, dtype=torch.float32) + 1,
          r(C, scale=0.1, dtype=torch.float32))
    a = torch.softmax(r(2, 16, 16, 2, 9, dtype=torch.float32), -1).reshape(
        2, 16, 16, 18).to(bf)
    w = (r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
         r(C, C, scale=C ** -0.5), r(C, scale=0.02))
    return {
        "grid_mhsa": (grid_mhsa, (r(8, 16, 3 * C), 2, "t")),
        "grid_mhsa_packed": (grid_mhsa_packed, (r(8, 36, 3 * C), 2)),
        "attn_branch": (attn_branch, (r(8, 64, C), *ln, *w, 2, 1e-5, True)),
        "attn_branch_nhwc": (attn_branch_nhwc,
                             (r(2, 16, 16, C), *ln, *w, 2, 2, 1e-5, True)),
        "mlp_branch": (mlp_branch, (r(2, 8, 8, C), *ln,
                                    r(C, 4 * C, scale=C ** -0.5),
                                    r(4 * C, scale=0.02),
                                    r(4 * C, C, scale=(4 * C) ** -0.5),
                                    r(C, scale=0.02), "gelu", 1e-5, True,
                                    "t")),
        "outlook_agg_proj": (outlook_agg_proj,
                             (r(2, 16, 16, C), a, *w[2:])),
        "outlook_branch": (outlook_branch, (r(2, 16, 16, C), a, *w[2:],
                                            *w[2:])),
        "outlook_softmax_agg": (outlook_softmax_agg,
                                (r(2, 16, 16, C), r(2, 16, 16, 18), 2, 3)),
        "dwconv3x3": (dwconv3x3, (r(2, 16, 16, C), r(9, C, scale=0.3))),
    }[name]


OGVT_OPS = ("grid_mhsa", "grid_mhsa_packed", "attn_branch",
            "attn_branch_nhwc", "mlp_branch", "outlook_agg_proj",
            "outlook_branch", "outlook_softmax_agg", "dwconv3x3")


@pytest.mark.parametrize("name", OGVT_OPS)
def test_ogvt_op_is_bitwise_its_direct_launch(dev, name):
    from outgridvit_tpu_torch.ops import library

    wrapper, args = _ogvt_case(name, dev)
    want = wrapper(*args)
    before = wrapper.launches
    got = getattr(torch.ops.ogvt, name)(*args)
    assert wrapper.launches == before + 1
    assert torch.equal(got, want)
    assert name in library.OPS


def test_exported_kernel_predictor_equals_the_live_one(dev, tmp_path):
    import numpy as np

    from outgridvit_tpu_torch.serving import (
        build_predictor,
        export_predictor,
        load_predictor,
    )

    live = build_predictor(LOOP_CFG, batch_size=8, img_size=16, device=dev,
                           seed=4)
    assert live.kernels
    path = tmp_path / "tiny.ogvt"
    export_predictor(live, str(path))
    loaded = load_predictor(str(path))
    assert loaded.kernels and loaded.device.type == "cuda"
    x = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), np.uint8)
    runs = []
    for pred in (live, loaded):
        before = grid_mhsa.launches, mlp_branch.launches
        runs.append((pred.predict(x), grid_mhsa.launches - before[0],
                     mlp_branch.launches - before[1]))
    ((l1, p1), *n1), ((l2, p2), *n2) = runs
    assert n1 == n2 and n1[0] > 0 and n1[1] > 0
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-6)


def test_eval_robustness_sweep_captures_one_eval_graph(dev, tmp_path):
    import json

    import numpy as np

    from outgridvit_tpu_torch import eval_robustness
    from outgridvit_tpu_torch.training.steps import EvalSuperstep

    stages = "".join(
        f"    - {{dim: {s['dim']}, depth: {s['depth']}, num_heads: "
        f"{s['num_heads']}, grid_size: {s['grid_size']}, outlook_heads: "
        f"{s['outlook_heads']}}}\n" for s in LOOP_CFG["stages"])
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("model:\n  type: model_a\n  num_classes: 100\n"
                   f"  stem_dim: 16\n  stages:\n{stages}"
                   "data:\n  img_size: 32\nruntime:\n  device: cuda\n")
    base = tmp_path / "CIFAR-100-C"
    base.mkdir()
    rng = np.random.default_rng(0)
    np.save(base / "labels.npy", np.arange(50_000, dtype=np.int64) % 100)
    block = rng.integers(0, 256, (1000, 32, 32, 3), dtype=np.uint8)
    np.save(base / "fog.npy", np.tile(block, (50, 1, 1, 1)))
    captures = EvalSuperstep.captures
    out = tmp_path / "rob.json"
    assert eval_robustness.main([
        "--config", str(cfg), "--suite", "cifar100c", "--data-dir",
        str(tmp_path), "--corruptions", "fog", "--severities", "1", "2",
        "3", "--batch-size", "512", "--eval-k", "4",
        "--json-out", str(out)]) == 0
    assert EvalSuperstep.captures == captures + 1
    res = json.loads(out.read_text())
    assert [r["severity"] for r in res["rows"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in res["rows"])
    assert res["summary"]["n_settings"] == 3


# ---- attention capture and per-block remat on the card --------------------

CAPTURE_CFGS = {"a": LOOP_CFG,
                "b": dict(LOOP_CFG, type="model_b", outlooker_front_depth=1,
                          use_pallas="fused_agg")}
# a capture takes the grid attention off its kernels (JAX's capture=True)
CAPTURE_OFF = (grid_mhsa, grid_mhsa_packed, attn_branch, attn_branch_nhwc,
               outlook_softmax_agg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model_key", ["a", "b"])
def test_capture_on_the_kernel_path_matches_the_plain_path(
        dev, model_key, dtype):
    """The tiny models' capture with the kernels on (#2, and #7 for Model
    B's front, still launched; no grid core, fused branch or fused
    softmax) against the same weights' plain-path capture: within TOL in
    fp32 and 5e-2 in bf16 (x (1 + |plain|)), the first outlooker's logits
    bitwise, every grid_attn row summing to 1 within 1e-5."""
    import numpy as np

    from outgridvit_tpu_torch.experiments import capture_attention

    cfg = CAPTURE_CFGS[model_key]
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    caps = {}
    for label, kern in (("kernel", None), ("plain", False)):
        model = build_model(cfg, dtype=dtype, use_kernels=kern, device=dev,
                            seed=3)
        before = [w.launches for w in (*CAPTURE_OFF, mlp_branch,
                                        outlook_agg_proj)]
        caps[label] = capture_attention(model, x)
        after = [w.launches for w in (*CAPTURE_OFF, mlp_branch,
                                      outlook_agg_proj)]
        delta = [a - b for a, b in zip(after, before)]
        if label == "plain":
            assert not any(delta)
            continue
        assert not any(delta[:len(CAPTURE_OFF)]), delta
        assert delta[-2] > 0
        assert (delta[-1] > 0) == (model_key == "b"), delta
    got, want = caps["kernel"], caps["plain"]
    tol = TOL[torch.float32] if dtype == torch.float32 else 5e-2
    assert set(got) == set(want)
    first = ("front", 0) if model_key == "b" else (0, 0)
    assert np.array_equal(got[first]["outlook_logits"],
                          want[first]["outlook_logits"])
    for key, slot in want.items():
        for f in ("outlook_logits", "grid_attn"):
            if slot[f] is None:
                assert got[key][f] is None
                continue
            a, b = got[key][f], slot[f]
            assert a.shape == b.shape and a.dtype == np.float32
            assert np.all(np.abs(a - b) <= tol * (1 + np.abs(b))), (key, f)
            if f == "grid_attn":
                assert np.abs(a.sum(-1, dtype=np.float64) - 1).max() <= 1e-5
        assert got[key]["grid_hw"] == slot["grid_hw"]


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_step_is_bitwise_the_plain_step_eager_and_in_the_graph(
        dev, policy):
    """The tiny bf16 model on the kernel path with ``model.remat``: one
    eager step and the K = 2 train superstep's graph bitwise the steps
    without remat from the same state, batches and seed (parameters, BN
    statistics, mu, nu, count, the device step, every metric)."""
    from outgridvit_tpu_torch.training.optim import warmup_cosine_lr
    from outgridvit_tpu_torch.training.steps import (
        TrainSuperstep,
        make_train_superstep,
    )

    cfg = _loop_step_cfg()
    sched = warmup_cosine_lr(1e-2, 40, 4, 1e-4)

    def state(remat):
        mcfg = LOOP_CFG if remat is None else dict(LOOP_CFG, remat=remat)
        model = build_model(mcfg, dtype=torch.bfloat16, device=dev, seed=1)
        return TrainState.create(model, AdamW(sched, 0.05, 1.0))

    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 16, 16, 16, 3), dtype=torch.uint8,
                      generator=g).to(dev)
    y = torch.randint(0, 10, (2, 16), generator=g).to(dev, torch.int32)
    step = make_train_step(cfg, sched)
    base, refs, ms = state(None), [], []
    for i in range(2):
        base, m = step(base, (x[i], y[i]), seed=7)
        ms.append(m)
        refs.append([t.clone() for t in _train_tensors(base)])
    rem = state(policy)
    assert rem.model.remat == policy
    rem, m = step(rem, (x[0], y[0]), seed=7)
    for k in m:
        assert torch.equal(m[k], ms[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(_train_tensors(rem),
                                                 refs[0]))
    replays = TrainSuperstep.replays
    graph, gm = make_train_superstep(cfg, sched, k=2)(state(policy), (x, y),
                                                      seed=7)
    assert TrainSuperstep.replays == replays + 1
    for k in gm:
        assert torch.equal(gm[k], torch.stack([m[k] for m in ms])), k
    assert all(torch.equal(a, b) for a, b in zip(_train_tensors(graph),
                                                 refs[1]))
