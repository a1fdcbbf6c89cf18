"""Attention blocks, NHWC (twins of ``outgridvit_tpu/models/blocks.py``):
outlook attention, grid MHSA, the outlooker block, the hybrid OutGrid block
and Model B's grid-only block. Drop-path runs in train mode with masks passed in
(:class:`~outgridvit_tpu_torch.ops.drop_path.DropPathMasks`); dropout is not
ported, and a nonzero dropout rate in train mode raises.

Attention capture (the JAX modules' ``sow`` into "intermediates" under
``capture=True``): inside :func:`recording`, an eval-mode forward stores
each outlooker's pre-softmax logits (fp32 ``[B, H, W, heads, K^2]``) under
``"<path>/outlook_logits"`` and each grid MHSA's fp32 probabilities
``[G, heads, N, N]`` under ``"<path>/attn"``, ``path`` being the module's
flax path (``stages_0_0/outlook/attn``, ``front_1/attn``,
``stages_0_0/grid_attn/mhsa``), and takes the paths JAX's capture takes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from outgridvit_tpu_torch.models.layers import (
    ChannelMLP,
    Dense,
    DropPath,
    LayerNorm,
    MBConv,
    layernorm_fp32,
)
from outgridvit_tpu_torch.ops.attention import mhsa
from outgridvit_tpu_torch.ops.attn_branch import (
    MIN_TOKENS,
    attn_branch_autograd,
    attn_branch_fits,
    attn_branch_nhwc_autograd,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.grid import grid_partition, grid_unpartition
from outgridvit_tpu_torch.ops.grid_attention import (
    MAX_TOKENS,
    grid_mhsa_autograd,
    grid_mhsa_packed_autograd,
    grid_mhsa_reference,
    grid_mhsa_variant,
)
from outgridvit_tpu_torch.ops.outlook import outlook_aggregate
from outgridvit_tpu_torch.ops.outlook_agg import (
    outlook_agg_proj_autograd,
    outlook_branch_autograd,
)
from outgridvit_tpu_torch.ops.outlook_softmax import outlook_softmax_autograd
from outgridvit_tpu_torch.stage_config import MBConvConfig, StageCfg


# the default first
OUTLOOK_MODES = ("xla", "fused_agg", "fused_agg_v", "fused_outlook")

_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "ogvt_capture", default=None)


@contextlib.contextmanager
def recording(store: Dict[str, torch.Tensor]) -> Iterator[dict]:
    """Capture attention into ``store`` during the forwards run inside."""
    token = _RECORDER.set(store)
    try:
        yield store
    finally:
        _RECORDER.reset(token)


def _recorder(module: nn.Module) -> Optional[dict]:
    store = _RECORDER.get()
    if store is not None and module.training:
        raise RuntimeError(
            f"attention capture at '{module.path}' needs eval mode (the JAX "
            "capture runs train=False)")
    return store


class OutlookAttention2d(nn.Module):
    """VOLO-style outlook attention, stride 1: a 1x1 projection gives
    heads*K^2 logits per pixel (heads-major), softmaxed in fp32 over the K^2
    taps; values from a 1x1 projection are aggregated, then projected.

    ``mode`` picks the value path as the JAX module's ``use_pallas`` does
    (``outgridvit_tpu/models/blocks.py:89-156``): ``"xla"`` aggregates
    with :func:`outlook_aggregate` and projects apart; ``"fused_agg"`` runs
    aggregate + projection as one op (TPU kernel #7) and ``"fused_agg_v"``
    folds the value projection in as well (#8), for K = 3 only (another K
    takes the ``"xla"`` path); ``"fused_outlook"`` (#9, any K) fuses the
    softmax of the raw logits with the aggregate and projects apart. A
    fused mode runs the CUDA kernels with ``use_kernels`` and their plain
    versions without: one function either way. ``xla`` as in
    :class:`~outgridvit_tpu_torch.models.layers.Dense`.

    Under capture (:func:`recording`) the fp32 logits are recorded before
    the softmax, and ``"fused_outlook"`` takes the ``"xla"`` path, as the
    JAX module does off its fused kernel under ``capture``
    (``blocks.py:89``); ``"fused_agg"`` and ``"fused_agg_v"`` keep their
    fused value path (``blocks.py:99-153``)."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 dtype=torch.float32, device=None, mode: str = "xla",
                 use_kernels: bool = False, xla: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        if kernel_size <= 0 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >0 (e.g., 3,5,7)")
        if mode not in OUTLOOK_MODES:
            raise ValueError(f"outlook mode {mode!r} is not one of "
                             f"{OUTLOOK_MODES}")
        self.heads, self.k = num_heads, kernel_size
        self.mode, self.use_kernels = mode, use_kernels
        self.path = ""  # the flax module path, set by the model
        kk = kernel_size * kernel_size
        self.attn = Dense(dim, num_heads * kk, dtype=dtype, device=device,
                          xla=xla)
        self.v = Dense(dim, dim, dtype=dtype, device=device, xla=xla)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, xla=xla)

    def forward(self, x):
        B, H, W, _ = x.shape
        store = _recorder(self)
        if self.mode == "fused_outlook" and store is None:
            y = outlook_softmax_autograd(
                self.v(x).contiguous(), self.attn(x).contiguous(), self.heads,
                self.k, self.use_kernels)
            return self.proj(y)
        a = self.attn(x).reshape(B, H, W, self.heads, self.k * self.k)
        if store is not None:
            store[f"{self.path}/outlook_logits"] = a.float()
        a = torch.softmax(a.float(), dim=-1).to(x.dtype)
        if self.mode in ("xla", "fused_outlook") or self.k != 3:
            y = outlook_aggregate(self.v(x), a, kernel_size=self.k, stride=1)
            return self.proj(y)
        dt = self.proj.dtype
        a = a.to(dt).reshape(B, H, W, self.heads * 9).contiguous()
        wp = self.proj.weight.to(dt).t().contiguous()
        bp = self.proj.bias.to(dt)
        if self.mode == "fused_agg_v":
            return outlook_branch_autograd(
                x.to(dt).contiguous(), a, self.v.weight.to(dt).t().contiguous(),
                self.v.bias.to(dt), wp, bp, self.use_kernels)
        return outlook_agg_proj_autograd(self.v(x).contiguous(), a, wp, bp,
                                         self.use_kernels)


class MultiHeadSelfAttention(nn.Module):
    """Grid MHSA on an NHWC map: partition into grids, pre-LN, qkv
    projection, the attention core, output projection, unpartition.

    The JAX dispatch by grid size N (``outgridvit_tpu/models/blocks.py:
    259-373``), on the kernel path and the plain path alike:

    - N >= 64 where the fused branch's kernels hold the grid
      (:func:`attn_branch_fits`, JAX's ``attn_branch_feasible``):
      :func:`attn_branch_autograd` (#5: LN, qkv, attention and proj in one
      kernel, norm2's LN passed in), or with ``attn_nhwc``
      :func:`attn_branch_nhwc_autograd` (#12: the same on the NHWC map, the
      partition folded into the kernel; the JAX package's
      ``OUTGRIDVIT_FUSED_ATTN_NHWC=1``, which the port does not read);
    - N <= 16: LN and qkv, the core :func:`grid_mhsa_autograd` (tagged
      ``"t"`` or ``"th"`` by :func:`grid_mhsa_variant`), proj;
    - 16 < N < 64, and N >= 64 where #5 does not fit: LN and qkv, the
      block-packed core :func:`grid_mhsa_packed_autograd` (#6), proj.

    ``xla`` takes the JAX package's XLA-only path instead (``use_pallas:
    false``, ``outgridvit_tpu/models/blocks.py:375-398``) at every N: LN
    cast to the compute dtype, ``qkv = x@W`` and ``+ b`` each rounded,
    fp32 logits and softmax, the probabilities cast before P.V, ``out@Wp``
    and ``+ bp`` each rounded; plain PyTorch under autograd, no kernel.
    Capture (:func:`recording`) takes that path at every N too, as JAX's
    ``capture`` leaves its kernels (``blocks.py:247``), and records the
    fp32 probabilities (:func:`~outgridvit_tpu_torch.ops.attention.mhsa`).

    qkv's last axis is laid out (3, heads, hd)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 use_kernels: bool = False, device=None, xla: bool = False,
                 attn_nhwc: bool = False):
        super().__init__()
        if dim <= 0 or num_heads <= 0 or dim % num_heads:
            raise ValueError(
                f"dim ({dim}) must be > 0 and divisible by num_heads "
                f"({num_heads})")
        self.heads, self.use_kernels = num_heads, use_kernels
        self.xla, self.attn_nhwc = xla, attn_nhwc
        self.path = ""  # the flax module path, set by the model
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device, xla=xla)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, xla=xla)

    def _branch_weights(self):
        dt = self.qkv.dtype
        return (self.qkv.weight.to(dt).t().contiguous(), self.qkv.bias.to(dt),
                self.proj.weight.to(dt).t().contiguous(),
                self.proj.bias.to(dt))

    def forward(self, x, ln: LayerNorm, grid_size: int):
        B, H, W, C = x.shape
        N = (H // grid_size) * (W // grid_size)
        dt = self.qkv.dtype
        store = _recorder(self)
        plain = self.xla or store is not None
        branch = N >= MIN_TOKENS and attn_branch_fits(N, C, self.heads)
        if branch and self.attn_nhwc and not plain:
            return attn_branch_nhwc_autograd(
                x.to(dt).contiguous(), ln.weight, ln.bias,
                *self._branch_weights(), self.heads, grid_size, ln.eps, True,
                self.use_kernels)
        grids, meta = grid_partition(x, grid_size)
        G, Hg, Wg, _ = grids.shape
        tokens = grids.reshape(G, N, C)
        if plain:
            out = self._xla(tokens, ln, store)
        elif branch:
            out = attn_branch_autograd(
                tokens.to(dt).contiguous(), ln.weight, ln.bias,
                *self._branch_weights(), self.heads, ln.eps, True,
                self.use_kernels)
        else:
            t = layernorm_fp32(tokens, ln.weight, ln.bias, ln.eps)
            qkv = self.qkv(t).contiguous()
            if N > MAX_TOKENS:
                core = grid_mhsa_packed_autograd(qkv, self.heads,
                                                 self.use_kernels)
            else:
                core = grid_mhsa_autograd(qkv, self.heads, self.use_kernels,
                                          grid_mhsa_variant(N, C))
            out = self.proj(core)
        return grid_unpartition(out.reshape(G, Hg, Wg, C), meta)

    def _xla(self, tokens, ln: LayerNorm, store: Optional[dict] = None):
        qkv = self.qkv(layernorm_fp32(tokens, ln.weight, ln.bias, ln.eps),
                       xla=True)
        if store is None:
            return self.proj(grid_mhsa_reference(qkv, self.heads,
                                                 round_probs=True))
        G, N, C3 = qkv.shape
        q, k, v = qkv.reshape(G, N, 3, self.heads,
                              C3 // (3 * self.heads)).permute(2, 0, 3, 1, 4)
        out, store[f"{self.path}/attn"] = mhsa(q, k, v, return_attn=True)
        return self.proj(out.transpose(1, 2).reshape(G, N, C3 // 3),
                         xla=True)


class GridAttention2D(nn.Module):
    """MaxViT-style dilated grid attention, NHWC in and out. Owns the grid
    size; its ``mhsa`` child keeps the JAX tree's ``grid_attn/mhsa`` path,
    which the weight bridge maps key for key."""

    def __init__(self, dim: int, num_heads: int, grid_size: int,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__()
        self.grid_size = grid_size
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, dtype, use_kernels,
                                           device, xla, attn_nhwc)

    def forward(self, x, ln: LayerNorm):
        if x.dim() != 4:
            raise ValueError(f"Expected NHWC. Got {tuple(x.shape)}")
        return self.mhsa(x, ln, self.grid_size)


class OutlookerBlock2d(nn.Module):
    """Pre-LN outlooker block: x + DP(attn(LN(x))); x + DP(mlp(LN(x))). LN
    eps is 1e-6 here."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 mlp_ratio: float = 2.0, act: str = "gelu",
                 norm_eps: float = 1e-6, drop_path: float = 0.0,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", xla: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, device)
        self.attn = OutlookAttention2d(dim, num_heads, kernel_size, dtype,
                                       device, outlook_mode, use_kernels, xla)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, device)
        self.mlp = ChannelMLP(dim, mlp_ratio, act, dtype, use_kernels, device,
                              xla)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        x = x + self.dp1(self.attn(self.norm1(x)), masks)
        return x + self.dp2(self.mlp(x, self.norm2), masks)


class OutGridBlock(nn.Module):
    """The hybrid block: outlooker -> MBConv -> grid attention -> MLP, with
    pre-LN residuals and drop-path at ``cfg.drop_path`` on the outlooker's
    two branches (dp1, dp2 inside it), the grid branch (dp2) and the MLP
    (dp3); MBConv's own drop-path is 0 here. ``outlook_heads == 0``,
    ``num_heads == 0`` and ``use_mbconv=False`` skip their branch. The grid
    and MLP norms use eps 1e-5. ``outlook_mode`` as in
    :class:`OutlookAttention2d`, ``dwconv`` as in
    :class:`~outgridvit_tpu_torch.models.layers.DepthwiseConv3x3`, ``xla``
    and ``attn_nhwc`` as in :class:`MultiHeadSelfAttention` (``xla`` also
    for the MLPs, :class:`~outgridvit_tpu_torch.models.layers.ChannelMLP`)."""

    def __init__(self, cfg: StageCfg, dtype=torch.float32,
                 use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__()
        C = cfg.dim
        self.dropout = {"attn_drop": cfg.attn_drop,
                        "proj_drop": cfg.proj_drop, "ffn_drop": cfg.ffn_drop}
        self.outlook = (OutlookerBlock2d(
            C, cfg.outlook_heads, cfg.outlook_kernel, cfg.outlook_mlp_ratio,
            cfg.mlp_act, drop_path=cfg.drop_path, dtype=dtype,
            use_kernels=use_kernels, device=device, outlook_mode=outlook_mode,
            xla=xla) if cfg.outlook_heads > 0 else None)
        self.mbconv = (MBConv(C, C, 1, MBConvConfig(
            expand_ratio=cfg.mbconv_expand_ratio, se_ratio=cfg.mbconv_se_ratio,
            act=cfg.mbconv_act, use_bn=cfg.use_bn), dtype, device, dwconv,
            use_kernels, xla) if cfg.use_mbconv else None)
        if cfg.num_heads > 0:
            self.norm2 = LayerNorm(C, 1e-5, device)
            self.grid_attn = GridAttention2D(C, cfg.num_heads, cfg.grid_size,
                                             dtype, use_kernels, device, xla,
                                             attn_nhwc)
            self.dp2 = DropPath(cfg.drop_path)
        else:
            self.norm2 = self.grid_attn = self.dp2 = None
        self.norm3 = LayerNorm(C, 1e-5, device)
        self.mlp = ChannelMLP(C, cfg.mlp_ratio, cfg.mlp_act, dtype,
                              use_kernels, device, xla)
        self.dp3 = DropPath(cfg.drop_path)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        if self.training:
            active = {k: v for k, v in self.dropout.items() if v > 0.0}
            if active:
                raise NotImplementedError(
                    f"dropout {active} in train mode is not ported yet "
                    "(ROADMAP §1); every shipped config sets it to 0")
        if self.outlook is not None:
            x = self.outlook(x, masks)
        if self.mbconv is not None:
            x = self.mbconv(x)
        if self.grid_attn is not None:
            x = x + self.dp2(self.grid_attn(x, self.norm2), masks)
        return x + self.dp3(self.mlp(x, self.norm3), masks)


class GridOnlyBlock(OutGridBlock):
    """Model B's unit (``outgridvit_tpu/models/blocks.py:583-637``): MBConv
    -> grid attention (dp2) -> MLP (dp3), the hybrid block without its
    outlooker; the submodule and drop-path names are the same."""

    def __init__(self, cfg: StageCfg, dtype=torch.float32,
                 use_kernels: bool = False, device=None, dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__(cfg.replace(outlook_heads=0), dtype, use_kernels,
                         device, dwconv=dwconv, xla=xla, attn_nhwc=attn_nhwc)
