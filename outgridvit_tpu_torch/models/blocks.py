"""Attention blocks, NHWC (twins of ``outgridvit_tpu/models/blocks.py``):
outlook attention, grid and window MHSA, the outlooker block, the hybrid
OutGrid block, Model B's grid-only block and the two composite stages.
Drop-path and dropout run in train mode with masks passed in
(:class:`~outgridvit_tpu_torch.ops.drop_path.DropPathMasks`; dropout sites
are named by flax path, ``ops/dropout.py``), and active dropout changes the
kernel dispatch as it does in JAX: ``attn_drop`` takes the outlook's fused
softmax (#9) and the grid attention's kernels (#1, #3, #5, #6, #12) off
their paths, ``ffn_drop`` the MLP's (#2, #4); the fused outlook value
paths (#7, #8) take the dropped probabilities.

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
import re
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from outgridvit_tpu_torch.models.layers import (
    ChannelMLP,
    Dense,
    DropPath,
    LayerNorm,
    MBConv,
    apply_dropout,
    avg_pool,
    layernorm_fp32,
    ln_identity,
    site_path,
)
from outgridvit_tpu_torch.ops.attention import mhsa
from outgridvit_tpu_torch.ops.attn_branch import (
    MIN_TOKENS,
    attn_branch_autograd,
    attn_branch_fits,
    attn_branch_nhwc_autograd,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks
from outgridvit_tpu_torch.ops.grid import (
    grid_partition,
    grid_unpartition,
    window_partition,
    window_unpartition,
)
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
    """VOLO-style outlook attention: a 1x1 projection gives heads*K^2
    logits per pixel (heads-major), average-pooled s x s at ``stride`` s
    (VALID), softmaxed in fp32 over the K^2 taps; values from a 1x1
    projection are aggregated at stride s, then projected. The output is
    ``[B, H // s, W // s, C]``; at s > 1 the aggregate's size
    ``(H - 1) // s + 1`` must equal the pool's ``H // s`` (it does not
    for odd H), or :func:`outlook_aggregate` raises, as the JAX function
    does.

    ``mode`` picks the value path as the JAX module's ``use_pallas`` does
    (``outgridvit_tpu/models/blocks.py:89-156``): ``"xla"`` aggregates
    with :func:`outlook_aggregate` and projects apart; ``"fused_agg"`` runs
    aggregate + projection as one op (TPU kernel #7) and ``"fused_agg_v"``
    folds the value projection in as well (#8), for K = 3 at stride 1 only
    (else the ``"xla"`` path); ``"fused_outlook"`` (#9, any K, stride 1)
    fuses the softmax of the raw logits with the aggregate and projects
    apart. A fused mode runs the CUDA kernels with ``use_kernels`` and
    their plain versions without: one function either way. ``xla`` as in
    :class:`~outgridvit_tpu_torch.models.layers.Dense`.

    Dropout in train mode (JAX ``blocks.py:105, 140-157``): ``attn_drop``
    on the softmaxed probabilities in x's dtype (site ``Dropout_0``), which
    takes ``"fused_outlook"`` to the ``"xla"`` path and feeds #7 / #8 the
    dropped probabilities; ``proj_drop`` on the output (``Dropout_1``, or
    ``Dropout_0`` after #9, which creates no probability dropout).

    Under capture (:func:`recording`) the fp32 logits are recorded before
    the softmax, and ``"fused_outlook"`` takes the ``"xla"`` path, as the
    JAX module does off its fused kernel under ``capture``
    (``blocks.py:89``); ``"fused_agg"`` and ``"fused_agg_v"`` keep their
    fused value path (``blocks.py:99-153``)."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 dtype=torch.float32, device=None, mode: str = "xla",
                 use_kernels: bool = False, xla: bool = False,
                 stride: int = 1, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        if kernel_size <= 0 or kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd and >0 (e.g., 3,5,7)")
        if stride <= 0:
            raise ValueError("stride must be > 0")
        if mode not in OUTLOOK_MODES:
            raise ValueError(f"outlook mode {mode!r} is not one of "
                             f"{OUTLOOK_MODES}")
        self.heads, self.k, self.stride = num_heads, kernel_size, stride
        self.mode, self.use_kernels = mode, use_kernels
        self.attn_drop, self.proj_drop = float(attn_drop), float(proj_drop)
        self.path = ""  # the flax module path, set by the model
        kk = kernel_size * kernel_size
        self.attn = Dense(dim, num_heads * kk, dtype=dtype, device=device,
                          xla=xla)
        self.v = Dense(dim, dim, dtype=dtype, device=device, xla=xla)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, xla=xla)

    def _drop(self, x, rate, site, masks):
        return apply_dropout(x, rate, masks, site_path(self.path, site),
                             self.training)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        B, H, W, _ = x.shape
        s = self.stride
        store = _recorder(self)
        attn_drop = self.training and self.attn_drop > 0.0
        if (self.mode == "fused_outlook" and s == 1 and store is None
                and not attn_drop):
            y = outlook_softmax_autograd(
                self.v(x).contiguous(), self.attn(x).contiguous(), self.heads,
                self.k, self.use_kernels)
            return self._drop(self.proj(y), self.proj_drop, "Dropout_0",
                              masks)
        a = self.attn(x)
        if s > 1:
            a = avg_pool(a, s)
        Hs, Ws = a.shape[1], a.shape[2]
        a = a.reshape(B, Hs, Ws, self.heads, self.k * self.k)
        if store is not None:
            store[f"{self.path}/outlook_logits"] = a.float()
        a = torch.softmax(a.float(), dim=-1).to(x.dtype)
        a = self._drop(a, self.attn_drop, "Dropout_0", masks)
        if self.mode in ("xla", "fused_outlook") or self.k != 3 or s != 1:
            y = outlook_aggregate(self.v(x), a, kernel_size=self.k, stride=s)
            return self._drop(self.proj(y), self.proj_drop, "Dropout_1",
                              masks)
        dt = self.proj.dtype
        a = a.to(dt).reshape(B, H, W, self.heads * 9).contiguous()
        wp = self.proj.weight.to(dt).t().contiguous()
        bp = self.proj.bias.to(dt)
        if self.mode == "fused_agg_v":
            y = outlook_branch_autograd(
                x.to(dt).contiguous(), a, self.v.weight.to(dt).t().contiguous(),
                self.v.bias.to(dt), wp, bp, self.use_kernels)
        else:
            y = outlook_agg_proj_autograd(self.v(x).contiguous(), a, wp, bp,
                                          self.use_kernels)
        return self._drop(y, self.proj_drop, "Dropout_1", masks)


class MultiHeadSelfAttention(nn.Module):
    """MHSA: pre-LN (when given one), qkv projection, the attention core,
    output projection; on an NHWC map partitioned into grids of
    ``grid_size`` (and unpartitioned after), or, without a grid size, on
    tokens ``[B, N, C]`` as they come (window attention, ViT blocks).

    The JAX dispatch by token count N (``outgridvit_tpu/models/blocks.py:
    259-373``), on the kernel path and the plain path alike:

    - N >= 64 where the fused branch's kernels hold the grid
      (:func:`attn_branch_fits`, JAX's ``attn_branch_feasible``):
      :func:`attn_branch_autograd` (#5: LN, qkv, attention and proj in one
      kernel, norm2's LN passed in), or with ``attn_nhwc`` on a grid map
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
    fp32 probabilities (:func:`~outgridvit_tpu_torch.ops.attention.mhsa`),
    and so does ``attn_drop`` in train mode (``blocks.py:246-247``), on
    the fp32 probabilities before their cast (site ``Dropout_0``).
    ``proj_drop`` drops the output, after the unpartition, on every path
    (``blocks.py:407``): site ``Dropout_1`` on the plain path, ``Dropout_0``
    on the kernel paths, which create no probability dropout.

    qkv's last axis is laid out (3, heads, hd)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 use_kernels: bool = False, device=None, xla: bool = False,
                 attn_nhwc: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if dim <= 0 or num_heads <= 0 or dim % num_heads:
            raise ValueError(
                f"dim ({dim}) must be > 0 and divisible by num_heads "
                f"({num_heads})")
        self.heads, self.use_kernels = num_heads, use_kernels
        self.xla, self.attn_nhwc = xla, attn_nhwc
        self.attn_drop, self.proj_drop = float(attn_drop), float(proj_drop)
        self.path = ""  # the flax module path, set by the model
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device, xla=xla)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, xla=xla)

    def _branch_weights(self):
        dt = self.qkv.dtype
        return (self.qkv.weight.to(dt).t().contiguous(), self.qkv.bias.to(dt),
                self.proj.weight.to(dt).t().contiguous(),
                self.proj.bias.to(dt))

    def forward(self, x, ln: Optional[LayerNorm] = None,
                grid_size: Optional[int] = None,
                masks: Optional[DropPathMasks] = None):
        dt = self.qkv.dtype
        if grid_size is None:
            B, N, C = x.shape
        else:
            B, H, W, C = x.shape
            N = (H // grid_size) * (W // grid_size)
        store = _recorder(self)
        attn_drop = self.training and self.attn_drop > 0.0
        plain = self.xla or store is not None or attn_drop
        branch = N >= MIN_TOKENS and attn_branch_fits(N, C, self.heads)
        lw, lb, eps = ((ln.weight, ln.bias, ln.eps) if ln is not None
                       else (*ln_identity(C, x.device), 1e-5))
        if branch and self.attn_nhwc and grid_size is not None and not plain:
            out = attn_branch_nhwc_autograd(
                x.to(dt).contiguous(), lw, lb, *self._branch_weights(),
                self.heads, grid_size, eps, ln is not None, self.use_kernels)
            return self._proj_drop(out, plain, masks)
        if grid_size is None:
            tokens = x
        else:
            grids, meta = grid_partition(x, grid_size)
            G, Hg, Wg, _ = grids.shape
            tokens = grids.reshape(G, N, C)
        if plain:
            out = self._xla(tokens, ln, store, masks)
        elif branch:
            out = attn_branch_autograd(
                tokens.to(dt).contiguous(), lw, lb, *self._branch_weights(),
                self.heads, eps, ln is not None, self.use_kernels)
        else:
            t = tokens if ln is None else layernorm_fp32(
                tokens, ln.weight, ln.bias, ln.eps)
            qkv = self.qkv(t).contiguous()
            if N > MAX_TOKENS:
                core = grid_mhsa_packed_autograd(qkv, self.heads,
                                                 self.use_kernels)
            else:
                core = grid_mhsa_autograd(qkv, self.heads, self.use_kernels,
                                          grid_mhsa_variant(N, C))
            out = self.proj(core)
        if grid_size is not None:
            out = grid_unpartition(out.reshape(G, Hg, Wg, C), meta)
        return self._proj_drop(out, plain, masks)

    def _proj_drop(self, out, plain: bool, masks):
        site = "Dropout_1" if plain else "Dropout_0"
        return apply_dropout(out, self.proj_drop, masks,
                             site_path(self.path, site), self.training)

    def _xla(self, tokens, ln: Optional[LayerNorm], store: Optional[dict]
             = None, masks: Optional[DropPathMasks] = None):
        t = tokens if ln is None else layernorm_fp32(tokens, ln.weight,
                                                     ln.bias, ln.eps)
        qkv = self.qkv(t, xla=True)
        if store is not None:
            G, N, C3 = qkv.shape
            q, k, v = qkv.reshape(G, N, 3, self.heads, C3 // (3 * self.heads)
                                  ).permute(2, 0, 3, 1, 4)
            out, store[f"{self.path}/attn"] = mhsa(q, k, v, return_attn=True)
            return self.proj(out.transpose(1, 2).reshape(G, N, C3 // 3),
                             xla=True)
        return self.proj(grid_mhsa_reference(
            qkv, self.heads, round_probs=True, probs=lambda a: apply_dropout(
                a, self.attn_drop, masks, site_path(self.path, "Dropout_0"),
                self.training)),
            xla=True)


class GridAttention2D(nn.Module):
    """MaxViT-style dilated grid attention, NHWC in and out. Owns the grid
    size; its ``mhsa`` child keeps the JAX tree's ``grid_attn/mhsa`` path,
    which the weight bridge maps key for key."""

    def __init__(self, dim: int, num_heads: int, grid_size: int,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 xla: bool = False, attn_nhwc: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.grid_size = grid_size
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, dtype, use_kernels,
                                           device, xla, attn_nhwc, attn_drop,
                                           proj_drop)

    def forward(self, x, ln: Optional[LayerNorm] = None,
                masks: Optional[DropPathMasks] = None):
        if x.dim() != 4:
            raise ValueError(f"Expected NHWC. Got {tuple(x.shape)}")
        return self.mhsa(x, ln, self.grid_size, masks)


class WindowAttention2D(nn.Module):
    """MaxViT-style block (window) attention (``outgridvit_tpu/models/
    blocks.py:691-724``): contiguous w x w windows
    (:func:`window_partition`), the MHSA on their ``[B*nW, w*w, C]``
    tokens (no LN inside; the grid core #1 / #3 at N = w*w <= 16 on the
    kernel path), unpartitioned. NHWC in and out; the ``mhsa`` child keeps
    the JAX tree's ``window_attn/mhsa`` path."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 xla: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, dtype, use_kernels,
                                           device, xla, False, attn_drop,
                                           proj_drop)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        if x.dim() != 4:
            raise ValueError(f"Expected NHWC. Got {tuple(x.shape)}")
        wins, meta = window_partition(x, self.window_size)
        Bw, wh, ww, C = wins.shape
        out = self.mhsa(wins.reshape(Bw, wh * ww, C), masks=masks)
        return window_unpartition(out.reshape(Bw, wh, ww, C), meta)


class OutlookerBlock2d(nn.Module):
    """Pre-LN outlooker block: x + DP(attn(LN(x))); x + DP(mlp(LN(x))). LN
    eps is 1e-6 here. ``stride`` > 1 shrinks the attention's output, so
    its residual add fails, as in JAX; ``attn_drop`` / ``proj_drop`` as in
    :class:`OutlookAttention2d`, ``mlp_drop`` the MLP's dropout."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 3,
                 mlp_ratio: float = 2.0, act: str = "gelu",
                 norm_eps: float = 1e-6, drop_path: float = 0.0,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", xla: bool = False,
                 stride: int = 1, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, mlp_drop: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, device)
        self.attn = OutlookAttention2d(dim, num_heads, kernel_size, dtype,
                                       device, outlook_mode, use_kernels, xla,
                                       stride, attn_drop, proj_drop)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, device)
        self.mlp = ChannelMLP(dim, mlp_ratio, act, dtype, use_kernels, device,
                              xla, mlp_drop)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        y = self.attn(self.norm1(x), masks)
        if y.shape != x.shape:
            raise ValueError(
                f"outlooker residual: attention output {tuple(y.shape)} "
                f"does not add to the input {tuple(x.shape)} (stride "
                f"{self.attn.stride})")
        x = x + self.dp1(y, masks)
        return x + self.dp2(self.mlp(x, self.norm2, masks), masks)


class OutGridBlock(nn.Module):
    """The hybrid block: outlooker -> MBConv -> grid attention -> MLP, with
    pre-LN residuals and drop-path at ``cfg.drop_path`` on the outlooker's
    two branches (dp1, dp2 inside it), the grid branch (dp2) and the MLP
    (dp3); MBConv's own drop-path is 0 here. ``outlook_heads == 0``,
    ``num_heads == 0`` and ``use_mbconv=False`` skip their branch. The grid
    and MLP norms use eps 1e-5. ``cfg.attn_drop`` / ``proj_drop`` reach the
    outlook and grid attentions, ``cfg.ffn_drop`` every MLP.
    ``outlook_mode`` as in :class:`OutlookAttention2d`, ``dwconv`` as in
    :class:`~outgridvit_tpu_torch.models.layers.DepthwiseConv3x3`, ``xla``
    and ``attn_nhwc`` as in :class:`MultiHeadSelfAttention` (``xla`` also
    for the MLPs, :class:`~outgridvit_tpu_torch.models.layers.ChannelMLP`)."""

    def __init__(self, cfg: StageCfg, dtype=torch.float32,
                 use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__()
        C = cfg.dim
        self.outlook = (OutlookerBlock2d(
            C, cfg.outlook_heads, cfg.outlook_kernel, cfg.outlook_mlp_ratio,
            cfg.mlp_act, drop_path=cfg.drop_path, dtype=dtype,
            use_kernels=use_kernels, device=device, outlook_mode=outlook_mode,
            xla=xla, attn_drop=cfg.attn_drop, proj_drop=cfg.proj_drop,
            mlp_drop=cfg.ffn_drop) if cfg.outlook_heads > 0 else None)
        self.mbconv = (MBConv(C, C, 1, MBConvConfig(
            expand_ratio=cfg.mbconv_expand_ratio, se_ratio=cfg.mbconv_se_ratio,
            act=cfg.mbconv_act, use_bn=cfg.use_bn), dtype, device, dwconv,
            use_kernels, xla) if cfg.use_mbconv else None)
        if cfg.num_heads > 0:
            self.norm2 = LayerNorm(C, 1e-5, device)
            self.grid_attn = GridAttention2D(C, cfg.num_heads, cfg.grid_size,
                                             dtype, use_kernels, device, xla,
                                             attn_nhwc, cfg.attn_drop,
                                             cfg.proj_drop)
            self.dp2 = DropPath(cfg.drop_path)
        else:
            self.norm2 = self.grid_attn = self.dp2 = None
        self.norm3 = LayerNorm(C, 1e-5, device)
        self.mlp = ChannelMLP(C, cfg.mlp_ratio, cfg.mlp_act, dtype,
                              use_kernels, device, xla, cfg.ffn_drop)
        self.dp3 = DropPath(cfg.drop_path)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        if self.outlook is not None:
            x = self.outlook(x, masks)
        if self.mbconv is not None:
            x = self.mbconv(x)
        if self.grid_attn is not None:
            x = x + self.dp2(self.grid_attn(x, self.norm2, masks), masks)
        return x + self.dp3(self.mlp(x, self.norm3, masks), masks)


class GridOnlyBlock(OutGridBlock):
    """Model B's unit (``outgridvit_tpu/models/blocks.py:583-637``): MBConv
    -> grid attention (dp2) -> MLP (dp3), the hybrid block without its
    outlooker; the submodule and drop-path names are the same."""

    def __init__(self, cfg: StageCfg, dtype=torch.float32,
                 use_kernels: bool = False, device=None, dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__(cfg.replace(outlook_heads=0), dtype, use_kernels,
                         device, dwconv=dwconv, xla=xla, attn_nhwc=attn_nhwc)


# the composite stages' flax module paths -> torch module paths
# (``utils/port_jax.py:torch_key``)
STAGE_RENAMES = (
    (r"^(blocks|outlookers)_(\d+)", r"\1.\2"),
    (r"\.mbconv\.(expand|depthwise|project)$", r".mbconv.\1.0"),
    (r"\.mbconv\.(expand|depthwise|project)_bn\.bn$", r".mbconv.\1.1"),
    (r"\.ln$", ""),
)


def _set_stage_paths(stage: nn.Module):
    """Give the stage's DropPaths, attentions and MLPs the flax paths the
    JAX stage gives them (``blocks_0/outlook/dp1``, ``outlookers_1/attn``)."""
    for name, m in stage.named_modules():
        if isinstance(m, (DropPath, OutlookAttention2d,
                          MultiHeadSelfAttention, ChannelMLP)):
            m.path = re.sub(r"^(blocks|outlookers)\.(\d+)", r"\1_\2",
                            name).replace(".", "/")


class MaxOutStage(nn.Module):
    """``depth`` OutGridBlocks in sequence (``outgridvit_tpu/models/
    blocks.py:640-657``; no model builds it): ``blocks.i``, the JAX tree's
    ``blocks_{i}``. Block arguments as in :class:`OutGridBlock`."""

    flax_renames = STAGE_RENAMES

    def __init__(self, cfg: StageCfg, depth: int, dtype=torch.float32,
                 use_kernels: bool = False, device=None, **kw):
        super().__init__()
        self.blocks = nn.ModuleList(
            OutGridBlock(cfg, dtype, use_kernels, device, **kw)
            for _ in range(depth))
        _set_stage_paths(self)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        for block in self.blocks:
            x = block(x, masks)
        return x


class StageOutThenGrid(nn.Module):
    """``out_depth`` outlookers, then ``depth`` GridOnlyBlocks
    (``outgridvit_tpu/models/blocks.py:660-688``; no model builds it):
    ``outlookers.i`` and ``blocks.i``, the JAX tree's ``outlookers_{i}``
    and ``blocks_{i}``. The outlookers take ``cfg``'s outlook settings,
    dropouts and drop-path."""

    flax_renames = STAGE_RENAMES

    def __init__(self, cfg: StageCfg, depth: int, out_depth: int = 1,
                 dtype=torch.float32, use_kernels: bool = False, device=None,
                 outlook_mode: str = "xla", dwconv: str = "xla",
                 xla: bool = False, attn_nhwc: bool = False):
        super().__init__()
        self.outlookers = nn.ModuleList(
            OutlookerBlock2d(cfg.dim, cfg.outlook_heads, cfg.outlook_kernel,
                             cfg.outlook_mlp_ratio, cfg.mlp_act,
                             drop_path=cfg.drop_path, dtype=dtype,
                             use_kernels=use_kernels, device=device,
                             outlook_mode=outlook_mode, xla=xla,
                             attn_drop=cfg.attn_drop,
                             proj_drop=cfg.proj_drop, mlp_drop=cfg.ffn_drop)
            for _ in range(out_depth))
        self.blocks = nn.ModuleList(
            GridOnlyBlock(cfg, dtype, use_kernels, device, dwconv, xla,
                          attn_nhwc)
            for _ in range(depth))
        _set_stage_paths(self)

    def forward(self, x, masks: Optional[DropPathMasks] = None):
        for block in (*self.outlookers, *self.blocks):
            x = block(x, masks)
        return x
