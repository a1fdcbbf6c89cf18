"""CUDA kernels of outgridvit_tpu_torch against their plain PyTorch versions
on the card, at edge shapes the Model A-7M path does not reach (odd token
and channel counts, a ragged last token tile, a hidden width that is not a
multiple of the 64-unit chunk, a grid whose staging needs more than 48 KB of
shared memory).

Marked ``cuda``: skips without a card. Imports no JAX, so it also runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: |kernel - plain| <= tol * (1 + |plain|),
tol 1e-4 in fp32 (summation order), 2e-2 in bf16 (one bf16 ulp).
"""

import pytest
import torch

from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops.grid_attention import (
    grid_mhsa,
    grid_mhsa_reference,
)
from outgridvit_tpu_torch.ops.mlp_branch import (
    mlp_branch,
    mlp_branch_reference,
)

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
