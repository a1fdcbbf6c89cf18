"""Port parity, ops: ``outgridvit_tpu_torch.ops`` against ``outgridvit_tpu``
on the same numpy inputs (CPU, fp32 unless stated).

Tolerances: 1e-5 per fp32 op; 3e-5 for the kernels' plain versions against
the Pallas kernels in interpret mode (the JAX kernel tests' own bar); bf16
cases at about one bf16 ulp of O(1) values (2^-7 ~ 7.8e-3), since a
different fp32 summation order can flip one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models.blocks import MultiHeadSelfAttention
from outgridvit_tpu.models.layers import layernorm_fp32 as jax_layernorm
from outgridvit_tpu.ops import grid as jgrid
from outgridvit_tpu.ops.activations import make_activation as jax_act
from outgridvit_tpu.ops.augment import normalize_batch as jax_normalize
from outgridvit_tpu.ops.grid_attention_pallas_t import grid_mhsa_pallas_t
from outgridvit_tpu.ops.mlp_branch_pallas_t import mlp_branch_pallas_t
from outgridvit_tpu.ops.outlook import outlook_aggregate as jax_outlook
from outgridvit_tpu_torch.ops import grid as tgrid
from outgridvit_tpu_torch.ops.activations import make_activation
from outgridvit_tpu_torch.ops.augment import normalize_batch
from outgridvit_tpu_torch.ops.grid_attention import (
    grid_mhsa,
    grid_mhsa_reference,
)
from outgridvit_tpu_torch.ops.mlp_branch import (
    layernorm_fp32,
    mlp_branch,
    mlp_branch_reference,
)
from outgridvit_tpu_torch.ops.outlook import outlook_aggregate

BF16_TOL = 2e-2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", ["gelu", "silu", "relu"])
def test_activation_parity(name):
    x = np.random.default_rng(0).normal(0, 3, (257,)).astype(np.float32)
    got = make_activation(name.upper())(_t(x))
    want = jax_act(name)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("g", [2, 4])
def test_grid_partition_parity(g):
    x = np.random.default_rng(1).normal(size=(2, 8, 12, 5)).astype(np.float32)
    got, meta = tgrid.grid_partition(_t(x), g)
    want, jmeta = jgrid.grid_partition(jnp.asarray(x), g)
    assert meta == jmeta
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(tgrid.grid_unpartition(got, meta)), x)
    # group (gy, gx) = (0, 1) of image 0 holds pixels (i*g, j*g+1)
    np.testing.assert_array_equal(_np(got[1, 1, 2]), x[0, g, 2 * g + 1])


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1)])
def test_outlook_aggregate_parity(k, s):
    rng = np.random.default_rng(2)
    B, H, W, heads, hd = 2, 7, 6, 3, 4
    Hs, Ws = (H - 1) // s + 1, (W - 1) // s + 1
    v = rng.normal(size=(B, H, W, heads * hd)).astype(np.float32)
    a = rng.random((B, Hs, Ws, heads, k * k)).astype(np.float32)
    got = outlook_aggregate(_t(v), _t(a), k, s)
    want = jax_outlook(jnp.asarray(v), jnp.asarray(a), kernel_size=k,
                       stride=s)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_outlook_aggregate_bf16_accumulates_in_bf16():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    a = rng.random((2, 8, 8, 3, 9)).astype(np.float32) / 9
    got = outlook_aggregate(_t(v, torch.bfloat16), _t(a, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jax_outlook(jnp.asarray(v, jnp.bfloat16),
                       jnp.asarray(a, jnp.bfloat16))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layernorm_parity(eps):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(5, 7, 48)) * 3 + 1).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    bi = (0.1 * rng.normal(size=48)).astype(np.float32)
    got = layernorm_fp32(_t(x), _t(sc), _t(bi), eps)
    want = jax_layernorm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), eps)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_normalize_batch_parity():
    x = np.random.default_rng(5).integers(0, 256, (3, 4, 4, 3), np.uint8)
    mean, std = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)
    got = normalize_batch(torch.from_numpy(x), mean, std)
    want = jax_normalize(jnp.asarray(x), mean, std)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# ---- kernel 1: grid MHSA ------------------------------------------------

@pytest.mark.parametrize("G,N,C,heads", [
    (8, 4, 96, 3),    # stage-1 family
    (4, 4, 256, 8),   # stage-3 family
    (4, 8, 48, 2),    # N=8
])
def test_grid_mhsa_reference_matches_pallas_interpret(G, N, C, heads):
    qkv = np.random.default_rng(6).normal(size=(G, N, 3 * C)).astype(
        np.float32)
    got = grid_mhsa_reference(_t(qkv), heads)
    with pltpu.force_tpu_interpret_mode():
        want = grid_mhsa_pallas_t(jnp.asarray(qkv), heads)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


def test_grid_mhsa_reference_n16_matches_jax_mhsa():
    # N=16 (stage 0) in interpret mode takes ~20 s: hold the plain version
    # against the JAX einsum path on the same qkv instead (proj = identity)
    rng = np.random.default_rng(7)
    G, N, C, heads = 4, 16, 48, 2
    mhsa = MultiHeadSelfAttention(dim=C, num_heads=heads, use_pallas=False)
    tokens = rng.normal(size=(G, N, C)).astype(np.float32)
    wqkv = rng.normal(size=(C, 3 * C)).astype(np.float32) * C ** -0.5
    variables = {"params": {
        "qkv": {"kernel": jnp.asarray(wqkv), "bias": jnp.zeros(3 * C)},
        "proj": {"kernel": jnp.eye(C), "bias": jnp.zeros(C)}}}
    want = mhsa.apply(variables, jnp.asarray(tokens))
    qkv = tokens @ wqkv
    got = grid_mhsa_reference(_t(qkv), heads)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


def test_grid_mhsa_reference_bf16_matches_pallas_interpret():
    qkv = np.random.default_rng(8).normal(size=(8, 4, 3 * 96)).astype(
        np.float32)
    got = grid_mhsa_reference(_t(qkv, torch.bfloat16), 3)
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = grid_mhsa_pallas_t(jnp.asarray(qkv, jnp.bfloat16), 3)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


# ---- kernel 2: MLP branch -----------------------------------------------

def _mlp_args(seed, M, C, H):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(M, C)).astype(np.float32),
        (1 + 0.1 * rng.normal(size=C)).astype(np.float32),
        (0.1 * rng.normal(size=C)).astype(np.float32),
        (rng.normal(size=(C, H)) * C ** -0.5).astype(np.float32),
        (0.02 * rng.normal(size=H)).astype(np.float32),
        (rng.normal(size=(H, C)) * H ** -0.5).astype(np.float32),
        (0.02 * rng.normal(size=C)).astype(np.float32),
    ]


def _mlp_both(args, act, apply_ln, dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    x, ls, lb, w1, b1, w2, b2 = args
    tx = [_t(a, tdt) for a in (x, w1, b1, w2, b2)]
    got = mlp_branch_reference(tx[0], _t(ls), _t(lb), *tx[1:], act, 1e-5,
                               apply_ln)
    jx = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    with pltpu.force_tpu_interpret_mode():
        want = mlp_branch_pallas_t(jx[0], jnp.asarray(ls), jnp.asarray(lb),
                                   *jx[1:], act, 1e-5, apply_ln)
    return _np(got), np.asarray(want, np.float32)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("apply_ln", [True, False])
def test_mlp_branch_reference_matches_pallas_interpret(act, apply_ln):
    got, want = _mlp_both(_mlp_args(9, 128, 48, 96), act, apply_ln, "f32")
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_mlp_branch_reference_bf16_matches_pallas_interpret():
    got, want = _mlp_both(_mlp_args(10, 128, 48, 192), "gelu", True, "bf16")
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_wrappers_on_cpu_tensors_take_the_plain_version():
    qkv = _t(np.random.default_rng(11).normal(size=(3, 4, 3 * 16)))
    n1 = grid_mhsa.launches
    torch.testing.assert_close(grid_mhsa(qkv, 2), grid_mhsa_reference(qkv, 2),
                               rtol=0, atol=0)
    args = [_t(a) for a in _mlp_args(12, 10, 16, 32)]
    n2 = mlp_branch.launches
    torch.testing.assert_close(mlp_branch(*args, "silu", 1e-5, True),
                               mlp_branch_reference(*args, "silu", 1e-5, True),
                               rtol=0, atol=0)
    # the counters count kernel launches only
    assert (grid_mhsa.launches, mlp_branch.launches) == (n1, n2)
