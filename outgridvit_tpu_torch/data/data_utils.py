"""Loader diagnostics and batch plots (twin of
``outgridvit_tpu/data/data_utils.py``). ``matplotlib`` is imported only by
:func:`show_batch`."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def describe_loader(loader, name: str = "loader", n_batches: int = 2) -> dict:
    """Print and return shape, dtype and range statistics of a few
    batches."""
    info = {"name": name,
            "num_batches": len(loader) if hasattr(loader, "__len__") else None}
    it = iter(loader)
    xs, ys = [], []
    for _ in range(n_batches):
        try:
            x, y = next(it)
        except StopIteration:
            break
        xs.append(np.asarray(x))
        ys.append(np.asarray(y))
    if not xs:
        print(f"[{name}] empty loader")
        return info
    x, y = xs[0], np.concatenate(ys)
    info.update(
        batch_shape=tuple(x.shape),
        image_dtype=str(x.dtype),
        label_dtype=str(ys[0].dtype),
        pixel_min=float(min(a.min() for a in xs)),
        pixel_max=float(max(a.max() for a in xs)),
        pixel_mean=float(np.mean([a.mean() for a in xs])),
        pixel_std=float(np.mean([a.std() for a in xs])),
        label_min=int(y.min()),
        label_max=int(y.max()),
        n_unique_labels=int(len(np.unique(y))),
    )
    print(f"[{name}] batches={info['num_batches']} shape={info['batch_shape']} "
          f"dtype={info['image_dtype']}")
    print(f"[{name}] pixels: min {info['pixel_min']:.3f} max "
          f"{info['pixel_max']:.3f} mean {info['pixel_mean']:.3f} std "
          f"{info['pixel_std']:.3f}")
    print(f"[{name}] labels: [{info['label_min']}, {info['label_max']}] "
          f"({info['n_unique_labels']} unique)")
    return info


def unnormalize(x: np.ndarray, mean: Sequence[float],
                std: Sequence[float]) -> np.ndarray:
    """Invert Normalize for display, clipped to [0, 1]."""
    img = (np.asarray(x) * np.asarray(std, np.float32)
           + np.asarray(mean, np.float32))
    return np.clip(img, 0.0, 1.0)


def show_batch(loader, mean: Sequence[float], std: Sequence[float],
               n: int = 16, ncols: int = 8,
               class_names: Optional[Sequence[str]] = None,
               save_path: Optional[str] = None):
    """Grid-plot one batch (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y = next(iter(loader))
    x, y = np.asarray(x), np.asarray(y)
    n = min(n, x.shape[0])
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(1.6 * ncols, 1.8 * nrows))
    axes = np.atleast_2d(axes)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(unnormalize(x[i], mean, std))
            label = int(y[i])
            ax.set_title(class_names[label] if class_names else str(label),
                         fontsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return fig
