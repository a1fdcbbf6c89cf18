"""Attention visualization: outlooker locality maps + grid-attention query
heatmaps.

Clean-room equivalents of the reference's matplotlib pipelines
(`src/experiments/heat_map_att_outlooker.py:159-342`,
`heat_map_att_grid.py:117-348`), reading captured attention instead of
forward hooks.

Per stage, the outlooker figure shows: the input image, the head-mean CENTER
tap weight per pixel, the SPREAD (1 - max tap weight) per pixel, and the 3x3
kernels (deviation from uniform 1/9) at the center / max-spread / min-spread
positions. The grid figure shows one query row of attention scattered back to
full feature-map coordinates (interleaved (h%g, w%g) group math) for queries
at the map center / max attention energy / min energy, box-smoothed and
overlaid on the image.

The port's copy of ``outgridvit_tpu/experiments/heatmaps.py``: the same
helpers and figures, reading captures from
:mod:`outgridvit_tpu_torch.experiments.capture`. The plot functions take
the port's model, which holds its weights, in place of JAX's ``(model,
variables)``, and import matplotlib when called (the card has none: there
they raise ImportError).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from outgridvit_tpu_torch.experiments.mad_entropy import _outlook_weights


def _unnormalize(img, mean, std):
    x = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x, 0.0, 1.0)


def _pick_batch(loader, n_images, seed):
    rng = np.random.default_rng(seed)
    it = iter(loader)
    nb = len(loader) if hasattr(loader, "__len__") else 1
    for _ in range(int(rng.integers(0, nb))):
        next(it)
    x, _ = next(it)
    x = np.asarray(x)
    idxs = rng.choice(x.shape[0], size=min(n_images, x.shape[0]), replace=False)
    return x[idxs]


def _box_smooth(m: np.ndarray, k: int = 3) -> np.ndarray:
    if k <= 1:
        return m
    p = k // 2
    mp = np.pad(m, p, mode="edge")
    out = np.zeros_like(m)
    for dy in range(k):
        for dx in range(k):
            out += mp[dy : dy + m.shape[0], dx : dx + m.shape[1]]
    return out / (k * k)


def _upsample_map(m: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear upsample of a [Hf,Wf] map to the exact image size.

    align_corners=False pixel-center semantics — the reference's
    ``F.interpolate(..., mode="bilinear", align_corners=False)``
    (`heat_map_att_outlooker.py:68-71`). Exact for non-divisible shapes,
    unlike nearest-neighbour ``np.kron`` tiling.
    """
    Hf, Wf = m.shape
    Hi, Wi = int(out_hw[0]), int(out_hw[1])
    m = m.astype(np.float32)
    if (Hf, Wf) == (Hi, Wi):
        return m
    ys = (np.arange(Hi, dtype=np.float32) + 0.5) * (Hf / Hi) - 0.5
    xs = (np.arange(Wi, dtype=np.float32) + 0.5) * (Wf / Wi) - 0.5
    y0 = np.clip(np.floor(ys), 0, Hf - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, Wf - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, Hf - 1)
    x1 = np.minimum(x0 + 1, Wf - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = m[y0][:, x0] * (1.0 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1.0 - wx) + m[y1][:, x1] * wx
    return top * (1.0 - wy) + bot * wy


def _fm_to_img_xy(y_f: float, x_f: float, fm_hw, img_hw):
    """Center-of-cell featuremap→image coordinate mapping (reference
    `heat_map_att_outlooker.py:145-156`)."""
    y = (y_f + 0.5) / fm_hw[0] * img_hw[0]
    x = (x_f + 0.5) / fm_hw[1] * img_hw[1]
    return x, y


def _blocks_to_plot(captures, field, block_idx):
    """Normalize a block selector (int | sequence | 'all') to a sorted list
    of block indices that actually captured `field`."""
    have = sorted({k[1] for k in captures
                   if captures[k].get(field) is not None})
    if isinstance(block_idx, str):
        if block_idx != "all":
            raise ValueError(f"block_idx string must be 'all', got {block_idx!r}")
        return have
    if isinstance(block_idx, (list, tuple)):
        want = {int(b) for b in block_idx}
    else:
        want = {int(block_idx)}
    return [b for b in have if b in want]


def plot_outlooker_locality_random(
    model, loader,
    n_images: int = 2, seed: int = 0,
    mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
    out_dir: Optional[str] = None, block_idx: int = 0, show: bool = False,
):
    """One figure per stage; saves to out_dir/outlooker_stage{S}.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from outgridvit_tpu_torch.experiments.capture import capture_attention

    x = _pick_batch(loader, n_images, seed)
    captures = capture_attention(model, x)
    paths = []
    blocks = _blocks_to_plot(captures, "outlook_logits", block_idx)
    stage_keys = sorted(
        [k for k in captures if captures[k].get("outlook_logits") is not None
         and k[1] in blocks],
        key=lambda k: (str(k[0]), k[1]),
    )
    img_hw = (x.shape[1], x.shape[2])
    for key in stage_keys:
        logits = captures[key]["outlook_logits"]  # [B,Hs,Ws,heads,kk]
        w = _outlook_weights(logits)  # softmax over kk
        kk = w.shape[-1]
        k = int(round(np.sqrt(kk)))
        center_idx = kk // 2
        # per-stage adaptive kernel color scale, capped (reference
        # kernel_cap=0.15 semantics at our default cap 0.3)
        kdev_all = np.abs(w.mean(3) - 1.0 / kk)
        v_stage = max(min(float(kdev_all.max()), 0.3), 1e-6)
        fig, axes = plt.subplots(
            n_images, 6, figsize=(18, 3 * n_images), squeeze=False
        )
        for b in range(n_images):
            img = _unnormalize(x[b], mean, std)
            wm = w[b].mean(2)  # [Hs, Ws, kk] head-mean
            center = wm[..., center_idx]
            spread = 1.0 - wm.max(-1)

            axes[b][0].imshow(img)
            axes[b][0].set_title("input")
            axes[b][1].imshow(img)
            axes[b][1].imshow(_upsample_map(center, img_hw),
                              alpha=0.6, cmap="magma")
            axes[b][1].set_title("center weight")
            axes[b][2].imshow(img)
            axes[b][2].imshow(_upsample_map(spread, img_hw),
                              alpha=0.6, cmap="viridis")
            axes[b][2].set_title("spread (1-max)")

            ys, xs = np.unravel_index(np.argmax(spread), spread.shape)
            ymn, xmn = np.unravel_index(np.argmin(spread), spread.shape)
            yc, xc = spread.shape[0] // 2, spread.shape[1] // 2
            for j, (yy, xx, ttl) in enumerate(
                [(yc, xc, "kernel@center"), (ys, xs, "kernel@max-spread"),
                 (ymn, xmn, "kernel@min-spread")]
            ):
                kern = wm[yy, xx].reshape(k, k) - 1.0 / kk
                im = axes[b][3 + j].imshow(kern, cmap="coolwarm",
                                           vmin=-v_stage, vmax=v_stage)
                axes[b][3 + j].set_title(f"{ttl} ({yy},{xx})")
                fig.colorbar(im, ax=axes[b][3 + j], fraction=0.046)
        fig.suptitle(f"Outlooker locality — stage {key[0]} block {key[1]}")
        fig.tight_layout()
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            suffix = "" if key[1] == 0 else f"_block{key[1]}"
            p = Path(out_dir) / f"outlooker_stage{key[0]}{suffix}.png"
            fig.savefig(p, dpi=110)
            paths.append(str(p))
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
    return paths


def _grid_query_heatmap(attn, Hg, Wg, g, b, gy, gx, q_idx):
    """Scatter one query's attention row back to full feature-map coords
    (reference `heat_map_att_grid.py:117-163`)."""
    A = attn[b * g * g + gy * g + gx].mean(0)  # head-mean [N, N]
    row = A[q_idx]
    Hf, Wf = Hg * g, Wg * g
    out = np.zeros((Hf, Wf), dtype=np.float32)
    ky = np.repeat(np.arange(Hg), Wg)
    kx = np.tile(np.arange(Wg), Hg)
    out[ky * g + gy, kx * g + gx] = row
    return out


def plot_grid_attention_random(
    model, loader,
    n_images: int = 2, seed: int = 0,
    mean=(0.5071, 0.4867, 0.4408), std=(0.2675, 0.2565, 0.2761),
    out_dir: Optional[str] = None, block_idx: int = 0, smooth_k: int = 3,
    show: bool = False,
):
    """One figure per stage with query heatmaps at center / max-energy /
    min-energy queries; saves to out_dir/grid_stage{S}.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from outgridvit_tpu_torch.experiments.capture import capture_attention

    x = _pick_batch(loader, n_images, seed)
    captures = capture_attention(model, x)
    paths = []
    blocks = _blocks_to_plot(captures, "grid_attn", block_idx)
    stage_keys = sorted(
        [k for k in captures if captures[k].get("grid_attn") is not None
         and k[1] in blocks and isinstance(k[0], int)],
        key=lambda k: k,
    )
    img_hw = (x.shape[1], x.shape[2])
    for key in stage_keys:
        pack = captures[key]
        attn = pack["grid_attn"]
        Hg, Wg = pack["grid_hw"]
        g = pack["g"]
        N = Hg * Wg
        fig, axes = plt.subplots(
            n_images, 4, figsize=(13, 3.2 * n_images), squeeze=False
        )
        for b in range(n_images):
            img = _unnormalize(x[b], mean, std)
            A = attn[b * g * g].mean(0)  # group (0,0), head-mean
            energy = A.sum(0)  # column energy per key
            q_center = (Hg // 2) * Wg + (Wg // 2)
            q_max = int(np.argmax(energy))
            q_min = int(np.argmin(energy))
            axes[b][0].imshow(img)
            axes[b][0].set_title("input")
            for j, (q, ttl) in enumerate(
                [(q_center, "query@center"), (q_max, "query@maxE"),
                 (q_min, "query@minE")]
            ):
                hm = _grid_query_heatmap(attn, Hg, Wg, g, b, 0, 0, q)
                hm = _box_smooth(hm, smooth_k)
                fm_hw = hm.shape
                axes[b][1 + j].imshow(img)
                axes[b][1 + j].imshow(_upsample_map(hm, img_hw),
                                      alpha=0.6, cmap="magma")
                qy, qx = (q // Wg) * g, (q % Wg) * g
                mx, my = _fm_to_img_xy(qy, qx, fm_hw, img_hw)
                axes[b][1 + j].scatter([mx], [my], c="cyan", s=30,
                                       marker="x")
                axes[b][1 + j].set_title(ttl)
        fig.suptitle(f"Grid attention — stage {key[0]} block {key[1]} (g={g})")
        fig.tight_layout()
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            suffix = "" if key[1] == 0 else f"_block{key[1]}"
            p = Path(out_dir) / f"grid_stage{key[0]}{suffix}.png"
            fig.savefig(p, dpi=110)
            paths.append(str(p))
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
    return paths
