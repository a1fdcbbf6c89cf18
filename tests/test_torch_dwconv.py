"""Port parity, kernels #10 and #11: the depthwise 3x3's plain versions
(``outgridvit_tpu_torch/ops/dwconv.py``) against
``outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:dwconv3x3_t`` (#10) and
``dwconv_bwd_pallas.py:dwconv3x3`` (#11) in interpret mode, forward and both
gradients, on the same numpy inputs (CPU); the autograd op and the module's
single bf16 rounding of dw; and the port's MBConv in modes ``"t"`` and
``"bwd"`` against the JAX MBConv with ``OUTGRIDVIT_DW_T`` /
``OUTGRIDVIT_DW_BWD`` set and the backend patched to "tpu" around the
module alone (as ``tests/test_dwconv_bwd_pallas.py:66-79`` does).

Tolerances are the JAX kernel tests': forward 1e-5
(``tests/test_dwconv_pallas_t.py:34``); #11 dx 2e-5, dw 3e-4
(``tests/test_dwconv_bwd_pallas.py:44-47``); #10 dx 1e-4, dw 1e-3
(``tests/test_dwconv_pallas_t.py:56-59``). In bf16 fewer than 1% of y and dx
may differ from the JAX kernel, each by one bf16 rounding, and dw (an fp32
sum over every pixel, rounded once) is within one bf16 rounding of its
largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from outgridvit_tpu.models import layers as jlayers
from outgridvit_tpu.ops.experimental import dwconv_bwd_pallas as dwb
from outgridvit_tpu.ops.experimental import dwconv_pallas_t as dwt
from outgridvit_tpu.stage_config import MBConvConfig as JaxMBConvConfig
from outgridvit_tpu_torch.models.layers import DepthwiseConv3x3, MBConv
from outgridvit_tpu_torch.ops import dwconv as dw
from outgridvit_tpu_torch.stage_config import MBConvConfig
from outgridvit_tpu_torch.utils.port_jax import jax_tree_to_port

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [  # B, H, W, C
    (4, 8, 8, 16),    # the JAX tests' shape
    (2, 6, 10, 12),   # H != W, C not a multiple of 8
    (1, 8, 16, 8),    # H != W
]
# dx and dw bars of the two JAX kernels' tests
BWD_TOL = {"t": (1e-4, 1e-3), "bwd": (2e-5, 3e-4)}


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, W, C)).astype(np.float32),
            (0.3 * rng.normal(size=(9, C))).astype(np.float32),
            rng.normal(size=(B, H, W, C)).astype(np.float32))


def _jax_fn(variant):
    """(x, w9) -> y of the JAX kernel: #10 takes w as [3, 3, C]."""
    if variant == "t":
        return lambda x, w9: dwt.dwconv3x3_t(x, w9.reshape(3, 3, -1))
    return dwb.dwconv3x3


def _assert_one_rounding(name, got, want):
    """Fewer than 1% of the values differ, each by at most one bf16
    rounding (2^-7 of the larger value's magnitude)."""
    got, want = _np(got), np.asarray(want, np.float32)
    differ = got != want
    assert differ.mean() < 0.01, (name, differ.mean())
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want)[differ] <= bound[differ]).all(), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C", SHAPES)
def test_forward_matches_dwconv3x3_t(dtype, B, H, W, C):
    tdt, jdt = DTYPES[dtype]
    x, w9, _ = _inputs(B + H + C, B, H, W, C)
    got = dw.dwconv3x3_reference(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(w9).to(tdt))
    with pltpu.force_tpu_interpret_mode():
        want = _jax_fn("t")(jnp.asarray(x, jdt), jnp.asarray(w9, jdt))
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        _assert_one_rounding("y", got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["t", "bwd"])
@pytest.mark.parametrize("B,H,W,C", SHAPES)
def test_backward_matches_the_jax_kernel(dtype, variant, B, H, W, C):
    tdt, jdt = DTYPES[dtype]
    x, w9, g = _inputs(B + W + C + 1, B, H, W, C)
    dx, dw9 = dw.dwconv3x3_backward_reference(
        *(torch.from_numpy(a).to(tdt) for a in (x, w9, g)))
    fn, jg = _jax_fn(variant), jnp.asarray(g, jdt)

    def loss(x, w9):
        return jnp.sum((fn(x, w9) * jg).astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want_dx, want_dw = jax.grad(loss, (0, 1))(jnp.asarray(x, jdt),
                                                  jnp.asarray(w9, jdt))
    assert dx.dtype == dw9.dtype == tdt
    if dtype == "f32":
        tx, tw = BWD_TOL[variant]
        np.testing.assert_allclose(_np(dx), np.asarray(want_dx), atol=tx,
                                   rtol=tx)
        np.testing.assert_allclose(_np(dw9), np.asarray(want_dw), atol=tw,
                                   rtol=tw)
    else:
        _assert_one_rounding("dx", dx, want_dx)
        want_dw = np.asarray(want_dw, np.float32)
        assert np.abs(_np(dw9) - want_dw).max() <= \
            2.0 ** -7 * np.abs(want_dw).max()


@pytest.mark.parametrize("mode", ["t", "bwd"])
def test_autograd_takes_the_written_out_backward(mode):
    x, w9, g = (torch.from_numpy(a) for a in _inputs(3, 2, 6, 10, 12))
    leaves = [t.clone().requires_grad_(True) for t in (x, w9)]
    y = dw.dwconv3x3_autograd(*leaves, mode)
    fwd = dw.dwconv3x3_xla if mode == "bwd" else dw.dwconv3x3_reference
    torch.testing.assert_close(y, fwd(x, w9), rtol=0, atol=0)
    got = torch.autograd.grad(y, leaves, g)
    for a, b in zip(got, dw.dwconv3x3_backward_reference(x, w9, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the grouped conv and the written-out taps: one function
    torch.testing.assert_close(dw.dwconv3x3_xla(x, w9),
                               dw.dwconv3x3_reference(x, w9), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["t", "bwd"])
def test_bf16_weight_grad_is_rounded_once(mode):
    # the fp32 parameter's grad is the backward's bf16 dw, cast back
    # exactly: one rounding, not two
    conv = DepthwiseConv3x3(12, dtype=torch.bfloat16, mode=mode)
    x, w9, g = (torch.from_numpy(a) for a in _inputs(4, 2, 6, 10, 12))
    with torch.no_grad():
        conv.weight.copy_(w9.t().reshape(12, 1, 3, 3))
    y = conv(x)
    y.backward(g.bfloat16())
    _, dw9 = dw.dwconv3x3_backward_reference(
        x.bfloat16(), w9.bfloat16(), g.bfloat16())
    assert dw9.dtype == torch.bfloat16
    torch.testing.assert_close(conv.weight.grad,
                               dw9.float().t().reshape(12, 1, 3, 3),
                               rtol=0, atol=0)


def test_wrappers_on_cpu_take_the_plain_version():
    x, w9, g = (torch.from_numpy(a) for a in _inputs(5, 1, 4, 6, 20))
    n = (dw.dwconv3x3.launches, dw.dwconv3x3_backward.launches)
    torch.testing.assert_close(dw.dwconv3x3(x, w9),
                               dw.dwconv3x3_reference(x, w9), rtol=0, atol=0)
    for a, b in zip(dw.dwconv3x3_backward(x, w9, g, "bwd"),
                    dw.dwconv3x3_backward_reference(x, w9, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (dw.dwconv3x3.launches, dw.dwconv3x3_backward.launches) == n
    with pytest.raises(ValueError, match="variant"):
        dw.dwconv3x3_backward(x, w9, g, "xla")
    with pytest.raises(ValueError, match="w9"):
        dw.dwconv3x3(x, w9[:, :8])
    with pytest.raises(ValueError, match="dwconv mode"):
        DepthwiseConv3x3(8, mode="taps")


# ---- the MBConv against the JAX module ------------------------------------

def _port_tree(tree):
    """A JAX MBConv tree -> the port MBConv's state-dict names."""
    return {k[len("x.mbconv."):]: v
            for k, v in jax_tree_to_port({"x": {"mbconv": tree}}).items()}


def _jax_mbconv_env(monkeypatch, mode):
    """Route the JAX module's depthwise to the kernel of ``mode``; returns
    the list its calls are recorded in."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if mode == "t":
        monkeypatch.setenv("OUTGRIDVIT_DW_T", "1")
        module, name = dwt, "dwconv3x3_t"
    else:
        monkeypatch.setenv("OUTGRIDVIT_DW_BWD", "1")
        # the TPU compile probe has no CPU counterpart; the shape fits
        monkeypatch.setattr(dwb, "dwconv3x3_bwd_feasible", lambda *a: True)
        module, name = dwb, "dwconv3x3"
    calls, real = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["t", "bwd"])
def test_mbconv_depthwise_modes_match_jax(mode, dtype, monkeypatch):
    """Train mode (batch statistics): the output, dx and every parameter
    gradient of one MBConv whose mid width (20) is not a multiple of 8."""
    tdt, jdt = DTYPES[dtype]
    B, H, W, C = 2, 6, 10, 5
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jmod = jlayers.MBConv(C, C, 1, JaxMBConvConfig(), dtype=jdt)
    init = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, C)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rng.normal(size=a.shape).astype(
            np.float32), init["params"])
    stats = jax.tree_util.tree_map(np.asarray, init["batch_stats"])
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)

    calls = _jax_mbconv_env(monkeypatch, mode)

    def loss(params, x):
        out, _ = jmod.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), (want_dp, want_dx) = jax.value_and_grad(
            loss, (0, 1), has_aux=True)(params, jnp.asarray(x, jdt))
    monkeypatch.undo()
    assert calls == [(B, H, W, 4 * C)]

    port = MBConv(C, C, 1, MBConvConfig(), dtype=tdt, dwconv=mode).train()
    port.load_state_dict({k: torch.tensor(v) for k, v in
                          {**_port_tree(params), **_port_tree(stats)}.items()})
    assert port.depthwise[0].mode == mode
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = port(tx)
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    want_grads = _port_tree(want_dp)
    assert set(grads) == set(want_grads)
    pairs = [("out", out, want), ("dx", tx.grad, want_dx)] + [
        (k, grads[k], want_grads[k]) for k in sorted(grads)]
    for name, a, b in pairs:
        b = np.asarray(b, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(_np(a), b, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        else:
            # bf16 products and BN around the depthwise: within four bf16
            # roundings of the largest element (2.5% measured, the BN
            # scale grad of the expand stage)
            err = np.abs(_np(a) - b).max()
            assert err <= 2.0 ** -5 * np.abs(b).max(), (name, err)
