"""The forward kernels as ``torch.library`` custom ops, namespace ``ogvt``.

``torch.export`` (and ``torch.compile``) cannot trace through a kernel
wrapper: the tracer hands it tensors without data, so there is no pointer
to pass through ``ctypes`` and no launch plan to make. While tracing, each
forward wrapper therefore returns its op instead
(``ops/kernel_build.py:tracing``), and the traced graph holds one
``ogvt::<name>`` node per launch. Eager calls and CUDA graph captures never
see the ops: the wrappers launch as they always have.

Each op has

- a CUDA implementation: the wrapper's launcher, which picks the C entry
  point and launch plan as an eager call does and counts the launch on the
  wrapper (``grid_mhsa.launches``, ...);
- a CPU implementation: the kernel's plain PyTorch version;
- a fake implementation: the output's shape and dtype alone; it touches no
  ``ctypes`` library, plan or layout query.

Registering the ops is importing this module; it builds nothing. ``nvcc``
runs at the first CUDA launch, as for an eager call. A program exported with
these ops (``serving.py:export_predictor``) needs this module imported
before ``torch.export.load`` (``serving.py:load_predictor`` does it), and
the kernels built from ``csrc/`` at its first forward on the card; it needs
neither the model code nor a checkpoint.

Ops (the wrapper each stands for):

==========================  ==========================================
``ogvt::grid_mhsa``         ``grid_attention.py:grid_mhsa`` (#1, #3)
``ogvt::grid_mhsa_packed``  ``grid_attention.py:grid_mhsa_packed`` (#6)
``ogvt::attn_branch``       ``attn_branch.py:attn_branch`` (#5)
``ogvt::attn_branch_nhwc``  ``attn_branch.py:attn_branch_nhwc`` (#12)
``ogvt::mlp_branch``        ``mlp_branch.py:mlp_branch`` (#2, #4)
``ogvt::outlook_agg_proj``  ``outlook_agg.py:outlook_agg_proj`` (#7)
``ogvt::outlook_branch``    ``outlook_agg.py:outlook_branch`` (#8)
``ogvt::outlook_softmax_agg`` ``outlook_softmax.py:outlook_softmax_agg``
                            (#9)
``ogvt::dwconv3x3``         ``dwconv.py:dwconv3x3`` (#10)
==========================  ==========================================
"""

from __future__ import annotations

import torch

from outgridvit_tpu_torch.ops import attn_branch as ab
from outgridvit_tpu_torch.ops import dwconv as dw
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops import mlp_branch as mb
from outgridvit_tpu_torch.ops import outlook_agg as oa
from outgridvit_tpu_torch.ops import outlook_softmax as osm

NAMESPACE = "ogvt"
# Registered with the low-level ``Library`` API: ``torch.library.custom_op``
# runs each implementation under dynamo's "disable" frame hook, under which
# the launchers' Python took milliseconds a call with torch 2.11 on an H100
# machine (PERF.md §6)
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _define(name: str, schema: str, cpu, cuda, fake) -> None:
    """``ogvt::name`` of ``schema``: ``cpu`` (the plain version), ``cuda``
    (the launcher) and ``fake`` (shape and dtype) implementations."""
    _LIB.define(name + schema)
    _LIB.impl(name, lambda *a: cpu(*a).contiguous(), "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


_ATTN = ("(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, "
         "Tensor bqkv, Tensor wproj, Tensor bproj, int heads, ")


def _grid_fake(qkv, heads, *_):
    G, N, C3 = qkv.shape
    return qkv.new_empty((G, N, C3 // 3))


def _same_fake(x, *_):
    return x.new_empty(x.shape)


def _outlook_fake(x, a, *weights):
    return x.new_empty((*x.shape[:-1], weights[-2].shape[-1]))


# ---- grid attention cores (#1, #3; #6) -------------------------------------
_define("grid_mhsa", "(Tensor qkv, int heads, str variant) -> Tensor",
        lambda qkv, heads, variant: ga.grid_mhsa_reference(qkv, heads),
        lambda qkv, heads, variant: ga._launch(None, qkv, heads, variant),
        _grid_fake)
_define("grid_mhsa_packed", "(Tensor qkv, int heads) -> Tensor",
        ga.grid_mhsa_packed_reference, ga._launch_packed, _grid_fake)

# ---- fused attention branch (#5; #12) --------------------------------------
_define("attn_branch", _ATTN + "float eps, bool apply_ln) -> Tensor",
        ab.attn_branch_reference,
        lambda *a: ab._launch_forward(None, *a), _same_fake)
_define("attn_branch_nhwc",
        _ATTN + "int grid_size, float eps, bool apply_ln) -> Tensor",
        ab.attn_branch_nhwc_reference,
        lambda *a: ab._launch_nhwc_forward(None, *a), _same_fake)

# ---- MLP branch (#2, #4) ---------------------------------------------------
_define("mlp_branch", "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, "
        "Tensor b1, Tensor w2, Tensor b2, str act, float eps, bool apply_ln, "
        "str variant) -> Tensor",
        lambda *a: mb.mlp_branch_reference(*a[:-1]),
        lambda *a: mb._launch_forward(None, *a), _same_fake)

# ---- fused outlook projection (#7, #8) and softmax (#9) --------------------
_define("outlook_agg_proj", "(Tensor v, Tensor a, Tensor wp, Tensor bp) -> "
        "Tensor", oa.outlook_agg_proj_reference,
        lambda v, a, wp, bp: oa._launch_forward(
            None, "outlook_agg_proj", v, a, None, None, wp, bp),
        _outlook_fake)
_define("outlook_branch", "(Tensor x, Tensor a, Tensor wv, Tensor bv, "
        "Tensor wp, Tensor bp) -> Tensor", oa.outlook_branch_reference,
        lambda *a: oa._launch_forward(None, "outlook_branch", *a),
        _outlook_fake)
_define("outlook_softmax_agg",
        "(Tensor v, Tensor logits, int heads, int k) -> Tensor",
        osm.outlook_softmax_agg_reference,
        lambda *a: osm._launch(None, *a), _same_fake)

# ---- depthwise 3x3 (#10) ---------------------------------------------------
_define("dwconv3x3", "(Tensor x, Tensor w9) -> Tensor",
        dw.dwconv3x3_reference, dw._launch_forward, _same_fake)

# name -> the op (an OpOverloadPacket: ``OPS[name](*args)`` calls it)
OPS = {name: getattr(torch.ops.ogvt, name) for name in (
    "grid_mhsa", "grid_mhsa_packed", "attn_branch", "attn_branch_nhwc",
    "mlp_branch", "outlook_agg_proj", "outlook_branch", "outlook_softmax_agg",
    "dwconv3x3")}
