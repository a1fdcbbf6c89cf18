"""Model construction from a config dict (twin of ``outgridvit_tpu/models/
build.py``), with the same ``model.type`` aliases and the same reading of
``model.use_pallas`` and ``model.remat``."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import torch

from outgridvit_tpu_torch.models.blocks import OUTLOOK_MODES
from outgridvit_tpu_torch.models.layers import init_parameters
from outgridvit_tpu_torch.models.model_a import MaxOutNet
from outgridvit_tpu_torch.models.model_b import OutlookerFrontGridNet
from outgridvit_tpu_torch.stage_config import DownsampleConfig, build_stages

_MODEL_A_ALIASES = ("a", "model_a", "maxout", "outgrid")
_MODEL_B_ALIASES = ("b", "model_b", "outlooker_front", "front")
# ``model.remat`` values that mean off (``models/rematerialize.py:66``)
_REMAT_OFF = ("off", "none", "false", "0", "")


def outlook_mode(use_pallas: Any) -> str:
    """The outlook path ``model.use_pallas`` asks for
    (``outgridvit_tpu/models/blocks.py:89-156``): ``"xla"`` for None or a
    boolean, or the fused mode it names (``fused_agg`` #7, ``fused_agg_v``
    #8, ``fused_outlook`` #9); any other string is refused."""
    if use_pallas is None or isinstance(use_pallas, bool):
        return "xla"
    fused = OUTLOOK_MODES[1:]
    if use_pallas not in fused:
        raise ValueError(
            f"model.use_pallas {use_pallas!r} is not null, a boolean or one "
            f"of {fused}")
    return use_pallas


def _check_remat(remat: Any) -> None:
    if remat and str(remat).strip().lower() not in _REMAT_OFF:
        raise NotImplementedError(
            f"model.remat {remat!r}: per-block rematerialization is not "
            "ported yet (ROADMAP §1); set it off")


def build_model(model_cfg: Mapping[str, Any], dtype=torch.float32,
                use_kernels: Optional[bool] = None, device="cuda",
                seed: int = 0, dwconv: str = "xla", attn_nhwc: bool = False
                ) -> Union[MaxOutNet, OutlookerFrontGridNet]:
    """Build a model in eval mode with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (skipped on the ``meta``
    device). Parameters are fp32; ``dtype`` is the compute dtype.

    ``use_kernels``: None runs the CUDA kernels iff ``device`` is CUDA;
    False runs their plain PyTorch versions; True on a non-CUDA device
    raises. ``model.use_pallas`` picks the outlook path
    (:func:`outlook_mode`); ``false`` is the JAX package's XLA-only path
    (``outgridvit_tpu/models/build.py:28-32``): no kernel runs, whatever
    ``use_kernels`` says, and the grid attention and the MLPs take the XLA
    rounding points (``xla`` of
    :class:`~outgridvit_tpu_torch.models.blocks.MultiHeadSelfAttention` and
    :class:`~outgridvit_tpu_torch.models.layers.ChannelMLP`).
    ``model.remat`` other than off raises.

    ``dwconv`` picks every MBConv's depthwise 3x3, the port's one switch
    for the family that the JAX package opts into with ``OUTGRIDVIT_DW_T``
    and ``OUTGRIDVIT_DW_BWD`` (neither env var is read): ``"xla"`` the
    grouped conv, ``"t"`` TPU kernel #10's forward and backward, ``"bwd"``
    the conv forward and #11's backward
    (:class:`~outgridvit_tpu_torch.models.layers.DepthwiseConv3x3`).

    ``attn_nhwc`` runs the grids of N >= 64 tokens through TPU kernel #12,
    the fused branch on the NHWC map with the partition folded in, in place
    of partition -> #5 -> unpartition: the port's switch for the JAX
    package's ``OUTGRIDVIT_FUSED_ATTN_NHWC=1`` (not read). Off by default,
    as in JAX."""
    device = torch.device(device)
    xla = model_cfg.get("use_pallas") is False
    if xla:
        use_kernels = False
    elif use_kernels is None:
        use_kernels = device.type == "cuda"
    elif use_kernels and device.type != "cuda":
        raise ValueError(
            f"use_kernels=True needs a CUDA device; got {device}")
    mode = outlook_mode(model_cfg.get("use_pallas"))
    _check_remat(model_cfg.get("remat"))
    model_type = str(model_cfg.get("type", "model_a")).lower()
    common = dict(
        num_classes=int(model_cfg.get("num_classes", 100)),
        stages=build_stages(model_cfg.get("stages", [])),
        in_ch=int(model_cfg.get("in_ch", 3)),
        stem_dim=int(model_cfg.get("stem_dim", 64)),
        dpr_max=float(model_cfg.get("dpr_max", 0.1)),
        down_cfg=DownsampleConfig.from_dict(model_cfg.get("downsample", {})
                                            or {}),
        dtype=dtype, use_kernels=use_kernels, device=device,
        outlook_mode=mode, dwconv=dwconv, xla=xla, attn_nhwc=attn_nhwc)
    if model_type in _MODEL_A_ALIASES:
        model = MaxOutNet(**common)
    elif model_type in _MODEL_B_ALIASES:
        model = OutlookerFrontGridNet(
            outlooker_front_depth=int(model_cfg.get("outlooker_front_depth",
                                                    2)), **common)
    else:
        raise ValueError(
            f"Unknown model.type '{model_type}'. Use 'model_a' (MaxOutNet) or "
            f"'model_b' (OutlookerFrontGridNet)")
    if device.type != "meta":
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
