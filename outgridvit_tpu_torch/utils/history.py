"""Training history on disk, and convergence plots (twin of
``outgridvit_tpu/utils/history.py``). ``matplotlib`` is imported only by
:func:`plot_convergence`."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence


def save_history(history: Dict[str, list], path: str) -> None:
    """Pickle ``train_model``'s history dict to ``path``."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        pickle.dump(history, f)


def load_history(path: str) -> Dict[str, list]:
    with open(path, "rb") as f:
        return pickle.load(f)


def plot_convergence(
    histories: Dict[str, Dict[str, list]],
    keys: Sequence[str] = ("train_loss", "val_loss", "train_top1", "val_top1"),
    save_path: Optional[str] = None,
):
    """Overlay the convergence curves of several runs ({run name:
    history})."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in keys
            if any(len(h.get(k, [])) > 0 for h in histories.values())]
    if not keys:
        raise ValueError("no non-empty keys to plot")
    ncols = min(2, len(keys))
    nrows = (len(keys) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 4 * nrows),
                             squeeze=False)
    for i, key in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        for name, h in histories.items():
            ys = h.get(key, [])
            if ys:
                ax.plot(range(1, len(ys) + 1), ys, label=name)
        ax.set_title(key)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return fig
