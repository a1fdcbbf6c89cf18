"""Attention capture (twin of ``outgridvit_tpu/experiments/capture.py``).

The JAX models ``sow`` their attention tensors under ``capture=True``; the
port's blocks record the same tensors, keyed by the same flax module paths,
into the store of ``models/blocks.py:recording`` during one eval-mode
forward. This module runs that forward and keys the results as JAX does:

  {(stage, block): {
      "outlook_logits": [B, Hs, Ws, heads, K*K]   (pre-softmax, fp32),
      "grid_attn":      [B*g*g, heads, N, N]      (post-softmax, fp32),
      "grid_hw": (Hg, Wg), "g": int, "meta": (B, Hf, Wf, C, g),
  }}

Model B's front outlookers are keyed ("front", i). The arrays are numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from outgridvit_tpu_torch.models.blocks import recording


def capture_attention(model, x, grid_sizes=None) -> Dict[Tuple, dict]:
    """Run one forward with capture and key the results by (stage, block).

    Args:
      model: a ``MaxOutNet`` / ``OutlookerFrontGridNet`` of the port; it
        holds its weights, so no variables are passed. The forward runs in
        eval mode under ``torch.no_grad`` (the model's mode is restored).
      x: input batch [B, H, W, 3] (a tensor or an array), moved to the
        model's device.
      grid_sizes: optional {stage_idx: g}; defaults to the model's stage
        configs.
    Returns: dict keyed (stage:int|"front", block:int).
    """
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), recording({}) as store:
            model(x)
    finally:
        model.train(was_training)
    inter = {name: t.cpu().numpy() for name, t in store.items()}

    if grid_sizes is None:
        grid_sizes = {si: scfg.grid_size
                      for si, scfg in enumerate(model.stage_cfgs)}

    out: Dict[Tuple, dict] = {}

    def ensure(key):
        return out.setdefault(
            key, {"outlook_logits": None, "grid_attn": None,
                  "grid_hw": None, "g": None, "meta": None}
        )

    for name, arr in inter.items():
        m = re.match(r"stages_(\d+)_(\d+)/", name)
        key = None
        if m:
            key = (int(m.group(1)), int(m.group(2)))
        else:
            mf = re.match(r"front_(\d+)/", name)
            if mf:
                key = ("front", int(mf.group(1)))
        if key is None:
            continue
        slot = ensure(key)
        if name.endswith("outlook_logits"):
            slot["outlook_logits"] = arr  # [B, Hs, Ws, heads, kk]
        elif name.endswith("attn"):
            slot["grid_attn"] = arr  # [Bgrp, heads, N, N]

    for key, slot in out.items():
        if slot["grid_attn"] is not None and isinstance(key[0], int):
            g = grid_sizes[key[0]]
            Bgrp, _, N, _ = slot["grid_attn"].shape
            assert Bgrp % (g * g) == 0, (Bgrp, g)
            # token grids are square for square inputs; recover Hg, Wg
            hg = int(round(np.sqrt(N)))
            while N % hg != 0:
                hg -= 1
            Hg, Wg = hg, N // hg
            Hf, Wf = Hg * g, Wg * g
            C = None
            slot["grid_hw"] = (Hg, Wg)
            slot["g"] = g
            slot["meta"] = (Bgrp // (g * g), Hf, Wf, C, g)
    return out
