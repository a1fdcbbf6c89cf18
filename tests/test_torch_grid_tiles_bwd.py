"""Kernel #6's backward past 256 tokens (``csrc/grid_mhsa_tiles.cu``), the
design that reads the forward's row statistics, on the CPU:

- the layout header's register budget: both backward kernels at 72
  registers a thread at hd <= 32, two blocks an SM and at least 24
  resident warps at the 7M model's N = 576 (192 px) and 784 (224 px),
  today's 128 above hd 32; every plan still fits one SM;
- the plain version of the statistics (``grid_mhsa_tiles_stats_reference``,
  ``[G * heads, 3, covered]``: max, sum, 1 / sum; rows past N those of the
  kernel's zero q rows) and the plain backward given them, bitwise the one
  that recomputes them;
- ``_GridMHSAPacked`` keeps statistics only where autograd records a
  backward of a bf16 launch past 256 tokens, and a served (no-grad)
  forward keeps none; its gradients, with remat too, are bitwise the plain
  backward's.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from outgridvit_tpu_torch.ops import grid_attention as ga

SM_REGS, SM_THREADS = 65536, 2048


def _qkv(G, N, C, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(G, N, 3 * C, generator=g).to(dtype),
            torch.randn(G, N, C, generator=g).to(dtype))


# ---- the register budget ----------------------------------------------------

@pytest.mark.parametrize("hd", [8, 16, 24, 32])
@pytest.mark.parametrize("N", [576, 784])
def test_backward_budget_keeps_24_warps_an_sm(N, hd):
    heads = 2
    p = ga.grid_mhsa_tiles_plan(64, N, heads * hd, heads, True)
    assert p.regs == p.regs_key == 72
    for blocks, smem in ((p.blocks_per_sm, p.smem_bytes),
                         (p.blocks_per_sm_key, p.smem_key)):
        assert blocks == 2 and blocks * p.warps >= 24, (blocks, p.warps)
        assert blocks * 32 * p.warps * p.regs <= SM_REGS
        assert blocks * 32 * p.warps <= SM_THREADS
        assert blocks * (smem + 1024) <= 228 * 1024
    assert (p.parts, p.warps) == ((3, 12) if N == 576 else (4, 13))
    # the forward keeps its cut and its cap: the same rows, two blocks
    f = ga.grid_mhsa_tiles_plan(64, N, heads * hd, heads, False)
    assert (f.parts, f.warps, f.covered, f.regs, f.blocks_per_sm) == (
        p.parts, p.warps, p.covered, 64, 2)


@pytest.mark.parametrize("hd", [40, 64])
def test_backward_budget_above_hd_32_is_unchanged(hd):
    p = ga.grid_mhsa_tiles_plan(4, 576, 2 * hd, 2, True)
    assert p.regs == p.regs_key == 128
    assert p.blocks_per_sm == p.blocks_per_sm_key == 1


@pytest.mark.parametrize("N", [257, 400, 449, 512, 576, 784, 1000, 4096])
def test_backward_budget_fits_every_block(N):
    """Blocks of up to 16 warps still launch at 72 registers (one an SM
    past 14 warps), and the statistics' rows are the forward's."""
    p = ga.grid_mhsa_tiles_plan(2, N, 48, 2, True)
    assert p.warps <= 16 and p.blocks_per_sm >= 1
    assert 32 * p.warps * p.regs <= SM_REGS
    assert p.blocks_per_sm * p.warps >= (24 if p.warps <= 14 else 15)
    assert p.covered == ga.grid_mhsa_tiles_plan(2, N, 48, 2, False).covered


# ---- the plain statistics and the plain backward given them ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,C,heads", [
    (3, 257, 48, 2), (2, 300, 24, 1), (2, 576, 48, 2), (1, 784, 48, 2),
    (2, 400, 120, 3)])
def test_plain_backward_given_stats_is_bitwise_the_recompute(
        dtype, G, N, C, heads):
    qkv, dout = _qkv(G, N, C, dtype, N + C + heads)
    stats = ga.grid_mhsa_tiles_stats_reference(qkv, heads)
    want = ga.grid_mhsa_packed_backward_reference(qkv, dout, heads)
    got = ga.grid_mhsa_packed_backward_reference(qkv, dout, heads, stats)
    assert torch.equal(got, want)
    # and the wrapper on a CPU tensor, given them or not
    assert torch.equal(ga.grid_mhsa_packed_backward(qkv, dout, heads, stats),
                       want)
    assert torch.equal(ga.grid_mhsa_packed_backward(qkv, dout, heads), want)


@pytest.mark.parametrize("G,N,C,heads", [(3, 257, 48, 2), (2, 784, 48, 2)])
def test_stats_reference_layout(G, N, C, heads):
    qkv, _ = _qkv(G, N, C, torch.bfloat16, 7)
    stats = ga.grid_mhsa_tiles_stats_reference(qkv, heads)
    covered = ga.grid_mhsa_tiles_plan(G, N, C, heads, False).covered
    assert stats.shape == (G * heads, 3, covered) and covered >= N
    assert stats.dtype == torch.float32 and stats.is_contiguous()
    hd = C // heads
    q, k, _ = qkv.float().reshape(G, N, 3, heads, hd).unbind(2)
    logits = torch.einsum("gnhd,gmhd->ghnm", q, k) * hd**-0.5
    m = logits.amax(-1).reshape(G * heads, N)
    assert torch.equal(stats[:, 0, :N], m)
    s = torch.exp(logits - logits.amax(-1, keepdim=True)).sum(-1)
    torch.testing.assert_close(stats[:, 1, :N], s.reshape(G * heads, N),
                               rtol=1e-6, atol=0)
    assert torch.equal(stats[:, 2], 1.0 / stats[:, 1])
    # the kernel's rows past N hold zero q: logits 0, so (0, N, 1 / N)
    assert bool((stats[:, 0, N:] == 0).all())
    assert bool((stats[:, 1, N:] == N).all())
    # grid_mhsa_packed(save_stats=True) on a CPU tensor gives the same
    out, kept = ga.grid_mhsa_packed(qkv, heads, save_stats=True)
    assert torch.equal(kept, stats)
    assert torch.equal(out, ga.grid_mhsa_packed_reference(qkv, heads))


@pytest.mark.parametrize("N,dtype", [
    (256, torch.bfloat16), (576, torch.float32), (36, torch.bfloat16)])
def test_no_stats_where_the_launch_keeps_none(N, dtype):
    qkv, _ = _qkv(2, N, 48, dtype, 3)
    assert not ga.keeps_stats(N, dtype)
    out, kept = ga.grid_mhsa_packed(qkv, 2, save_stats=True)
    assert kept is None
    assert torch.equal(out, ga.grid_mhsa_packed_reference(qkv, 2))


def test_keeps_stats_by_n_and_dtype():
    assert ga.keeps_stats(257, torch.bfloat16)
    assert ga.keeps_stats(4096, torch.bfloat16)
    assert not ga.keeps_stats(256, torch.bfloat16)
    assert not ga.keeps_stats(576, torch.float32)


# ---- what _GridMHSAPacked saves ---------------------------------------------

def _saved(out):
    return out.grad_fn.saved_tensors


@pytest.mark.parametrize("N,dtype,kept", [
    (576, torch.bfloat16, True), (300, torch.bfloat16, True),
    (256, torch.bfloat16, False), (576, torch.float32, False),
    (36, torch.bfloat16, False)])
def test_autograd_saves_stats_only_under_grad_past_256_in_bf16(
        monkeypatch, N, dtype, kept):
    qkv, dout = _qkv(2, N, 48, dtype, N)
    asked = []
    real = ga.grid_mhsa_packed

    def spy(q, heads, save_stats=False):
        asked.append(save_stats)
        return real(q, heads, save_stats)

    monkeypatch.setattr(ga, "grid_mhsa_packed", spy)
    leaf = qkv.clone().requires_grad_(True)
    out = ga.grid_mhsa_packed_autograd(leaf, 2, True)
    saved_qkv, stats = _saved(out)
    assert saved_qkv is not None
    if kept:
        assert torch.equal(stats,
                           ga.grid_mhsa_tiles_stats_reference(qkv, 2))
    else:
        assert stats is None
    out.backward(dout)
    assert torch.equal(leaf.grad,
                       ga.grid_mhsa_packed_backward_reference(qkv, dout, 2))
    # served: no grad, or a qkv that needs none, asks for no statistics
    with torch.no_grad():
        served = ga.grid_mhsa_packed_autograd(leaf, 2, True)
    assert served.grad_fn is None
    ga.grid_mhsa_packed_autograd(qkv, 2, True)
    assert asked == [True, False, False]
    assert torch.equal(served, out.detach())
    # the plain path keeps none either
    plain = ga.grid_mhsa_packed_autograd(leaf, 2, False)
    assert _saved(plain)[1] is None


def test_remat_recompute_keeps_the_same_stats():
    """Under non-reentrant checkpoint the forward runs again in the backward
    and keeps its statistics again; the gradient is bitwise the one without
    remat."""
    qkv, dout = _qkv(2, 300, 48, torch.bfloat16, 11)
    grads = []
    for remat in (False, True):
        leaf = qkv.clone().requires_grad_(True)
        out = (checkpoint(ga.grid_mhsa_packed_autograd, leaf, 2, True,
                          use_reentrant=False, preserve_rng_state=False)
               if remat else ga.grid_mhsa_packed_autograd(leaf, 2, True))
        out.backward(dout)
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])


def test_traced_forward_keeps_no_stats(monkeypatch):
    from outgridvit_tpu_torch.ops import kernel_build

    monkeypatch.setattr(kernel_build, "tracing", lambda: True)
    qkv, _ = _qkv(2, 300, 48, torch.bfloat16, 5)
    with pytest.raises(ValueError, match="keeps no row statistics"):
        ga.grid_mhsa_packed(qkv, 2, save_stats=True)
