"""Port parity, kernel #5: the fused grid-attention branch's plain versions
(``outgridvit_tpu_torch/ops/attn_branch.py``) against
``outgridvit_tpu/ops/attn_branch_pallas.py:attn_branch_pallas`` in interpret
mode, forward and backward (all 7 gradients), on the same numpy inputs
(CPU).

Tolerances (``tests/test_attn_branch_pallas.py:65, 88, 101``): fp32 3e-5
forward and 2e-3 gradients; bf16 5e-2 (the plain versions keep the
kernel's rounding points, so a bf16 value differs only where an fp32 sum
taken in another order rounds the other way). bf16 parameter gradients are
sums over every token; they are held to 5e-2 of their largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.ops.attn_branch_pallas import attn_branch_pallas
from outgridvit_tpu_torch.ops.attn_branch import (
    attn_branch,
    attn_branch_autograd,
    attn_branch_backward,
    attn_branch_backward_reference,
    attn_branch_reference,
    smem_bytes,
)

GRADS = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj", "dbproj")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": (3e-5, 2e-3), "bf16": (5e-2, 5e-2)}  # (forward, gradients)


def _args(seed, G, N, C):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(G, N, C)).astype(np.float32),
        (1 + 0.1 * rng.normal(size=C)).astype(np.float32),
        (0.1 * rng.normal(size=C)).astype(np.float32),
        (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32),
        (0.02 * rng.normal(size=3 * C)).astype(np.float32),
        (rng.normal(size=(C, C)) * C ** -0.5).astype(np.float32),
        (0.02 * rng.normal(size=C)).astype(np.float32),
    ]


def _to(args, dtype):
    """numpy args -> (torch, jax) args; LN params stay fp32."""
    tdt, jdt = DTYPES[dtype]
    t = [torch.from_numpy(a).to(torch.float32 if i in (1, 2) else tdt)
         for i, a in enumerate(args)]
    j = [jnp.asarray(a, jnp.float32 if i in (1, 2) else jdt)
         for i, a in enumerate(args)]
    return t, j


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("G,N,C,heads", [(4, 64, 16, 2), (8, 16, 24, 3)])
def test_attn_branch_plain_matches_pallas_interpret(G, N, C, heads, apply_ln,
                                                    dtype):
    args = _args(G + N + C, G, N, C)
    dy = np.random.default_rng(1).normal(size=(G, N, C)).astype(np.float32)
    targs, jargs = _to(args, dtype)
    tdy, jdy = _to([dy], dtype)[0][0], jnp.asarray(dy, DTYPES[dtype][1])
    got = attn_branch_reference(*targs, heads, 1e-5, apply_ln)
    grads = attn_branch_backward_reference(*targs, tdy, heads, 1e-5,
                                           apply_ln)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda *a: attn_branch_pallas(*a, heads, 1e-5, apply_ln), *jargs)
        want_grads = vjp(jdy)
    ftol, gtol = TOL[dtype]
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ftol, rtol=ftol)
    for name, g, w in zip(GRADS, grads, want_grads):
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[str(w.dtype)], name
        w = np.asarray(w, np.float32)
        if dtype == "bf16" and name != "dx":
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(_np(g) - w).max()) <= gtol * scale, name
        else:
            np.testing.assert_allclose(_np(g), w, atol=gtol, rtol=gtol,
                                       err_msg=name)


def test_attn_branch_autograd_grads_equal_the_plain_backward():
    targs, _ = _to(_args(3, 2, 64, 8), "f32")
    dy = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 64, 8)).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in targs]
    y = attn_branch_autograd(*leaves, 2, 1e-5, True, False)
    got = torch.autograd.grad(y, leaves, dy)
    want = attn_branch_backward_reference(*targs, dy, 2, 1e-5, True)
    for name, g, w in zip(GRADS, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_attn_branch_wrappers_on_cpu_take_the_plain_version():
    targs, _ = _to(_args(5, 2, 64, 8), "f32")
    dy = torch.ones(2, 64, 8)
    n = (attn_branch.launches, attn_branch_backward.launches)
    torch.testing.assert_close(attn_branch(*targs, 2),
                               attn_branch_reference(*targs, 2), rtol=0,
                               atol=0)
    for g, w in zip(attn_branch_backward(*targs, dy, 2),
                    attn_branch_backward_reference(*targs, dy, 2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (attn_branch.launches, attn_branch_backward.launches) == n
    with pytest.raises(ValueError, match="divisible"):
        attn_branch(*targs, 3)


def test_attn_branch_shared_memory_fits_the_64px_shapes():
    # the 64px configs' stage 0 (N=64, C=64, 2 heads) and the 32px
    # cifar100_model_a stage 0 (N=64, C=80, 2 heads) fit one block
    for C in (64, 80):
        assert smem_bytes(64, C, 2, backward=False) < 227 * 1024
        assert smem_bytes(64, C, 2, backward=True) < 227 * 1024
    assert smem_bytes(64, 64, 2, backward=False) == 4 * 64 * (65 + 193 + 65)
