"""Multi-head self-attention as a plain function on token sequences (twin
of ``outgridvit_tpu/ops/attention.py``): the calling module projects q, k
and v; this runs scaled dot-product attention with fp32 logits and softmax,
the probabilities cast to v's dtype before P.V. Analysis only: the attention
capture (``models/blocks.py:MultiHeadSelfAttention``) calls it for the
probabilities; no train or serve path does.
"""

from __future__ import annotations

import torch


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         return_attn: bool = False):
    """q, k, v ``[B, heads, N, head_dim]`` -> out ``[B, heads, N,
    head_dim]`` in v's dtype (and the fp32 attention matrix ``[B, heads, N,
    N]`` with ``return_attn``). The products sum in fp32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    if return_attn:
        return out, attn
    return out
