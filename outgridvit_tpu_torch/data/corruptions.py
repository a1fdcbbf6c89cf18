"""Corruption-robustness datasets and evaluation suites: CIFAR-100-C and
Tiny-ImageNet-C (twin of ``outgridvit_tpu/data/corruptions.py``, on the
port's ``ArrayDataLoader``, ``RawTransform`` and ``EvalTransform``: for the
same files the loaders yield the JAX loaders' batches bit for bit, on the
uint8 wire (``device_normalize``) and normalized on the host).

Offline-first equivalents of the reference loaders
(`src/data/load_cifrar100_C.py`, `src/data/load_tinyimagenet_C.py`):

- CIFAR-100-C reads the canonical Zenodo numpy layout
  (``CIFAR-100-C/<corruption>.npy`` [50000, 32, 32, 3] with severities 1..5
  stacked 10k each, plus ``labels.npy``).
- Tiny-ImageNet-C reads the extracted Zenodo tree
  (``Tiny-ImageNet-C/<corruption>/<severity>/<wnid>/*.JPEG``) with the
  reference's wnid-intersection + label-remap semantics
  (`load_tinyimagenet_C.py:172-244`): only classes present in BOTH the clean
  training set and the corruption set are evaluated, remapped onto the clean
  label indices.

Evaluation sweeps mirror `evaluate_tinyc_suite` / `summarize_tinyc_results`
(`load_tinyimagenet_C.py:266-332`).

The Tiny-ImageNet-C loaders decode JPEGs with PIL, imported lazily; where
PIL is absent (the GPU machine) making such a loader raises an ImportError
that says so.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from outgridvit_tpu_torch.data.datasets import (
    CIFAR100_MEAN,
    CIFAR100_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    _ImageFileView,
    pil_image,
)
from outgridvit_tpu_torch.data.pipeline import ArrayDataLoader
from outgridvit_tpu_torch.data.transforms import EvalTransform, RawTransform

CIFAR100C_CORRUPTIONS = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression", "speckle_noise", "gaussian_blur", "spatter",
    "saturate",
)

TINYC_CORRUPTIONS_DEFAULT = (
    "gaussian_noise", "defocus_blur", "brightness", "contrast", "pixelate",
)


# ----------------------------------------------------------- CIFAR-100-C

def _find_cifar100c_dir(data_dir: str) -> Path:
    root = Path(data_dir)
    for cand in (root, root / "CIFAR-100-C", root / "cifar-100-c"):
        if (cand / "labels.npy").exists():
            return cand
    raise FileNotFoundError(
        f"CIFAR-100-C not found under {data_dir}. Expected "
        f"{data_dir}/CIFAR-100-C/{{<corruption>.npy, labels.npy}} "
        f"(Zenodo 3555552 layout); no network egress to download."
    )


def get_cifar100c_loader(
    corruption: str,
    severity: int,
    data_dir: str = "./data",
    batch_size: int = 256,
    img_size: int = 32,
    num_workers: int = 8,
    device_normalize: bool = False,
):
    """One (corruption, severity) split — exactly 10k images (the reference
    hard-checks this, `load_cifrar100_C.py:30-41`).

    ``device_normalize=True`` keeps batches uint8 on the wire (4x less
    host->device traffic) and tags the loader with the (mean, std) for the
    eval step to normalize on the device — same contract as the main
    eval loaders (`datasets.py` device_augment path)."""
    if not (1 <= severity <= 5):
        raise ValueError("severity must be in 1..5")
    base = _find_cifar100c_dir(data_dir)
    path = base / f"{corruption}.npy"
    if not path.exists():
        raise FileNotFoundError(f"missing corruption file {path}")
    images = np.load(path, mmap_mode="r")
    labels = np.load(base / "labels.npy")
    lo, hi = (severity - 1) * 10000, severity * 10000
    images = np.ascontiguousarray(images[lo:hi])
    labels = np.asarray(labels[lo:hi], dtype=np.int64)
    if len(images) != 10000:
        raise ValueError(
            f"expected exactly 10000 rows for {corruption}@{severity}, got "
            f"{len(images)}"
        )
    tf = (RawTransform(img_size) if device_normalize
          else EvalTransform(img_size, CIFAR100_MEAN, CIFAR100_STD))
    loader = ArrayDataLoader(images, labels, batch_size=batch_size,
                             shuffle=False, transform=tf,
                             num_threads=max(1, num_workers))
    loader.device_normalize = ((CIFAR100_MEAN, CIFAR100_STD)
                               if device_normalize else None)
    return loader


def evaluate_cifar100c_suite(
    evaluate_one_epoch_fn: Callable,
    data_dir: str = "./data",
    corruptions: Optional[Sequence[str]] = None,
    severities: Sequence[int] = (1, 2, 3, 4, 5),
    batch_size: int = 256,
    verbose: bool = True,
    device_normalize: bool = False,
) -> List[dict]:
    """Sweep corruptions x severities (reference `load_cifrar100_C.py:106-152`).
    ``evaluate_one_epoch_fn(loader) -> (loss, {"top1": ..., ...})``."""
    if corruptions is None:
        base = _find_cifar100c_dir(data_dir)
        corruptions = sorted(
            p.stem for p in base.glob("*.npy") if p.stem != "labels"
        )
    results = []
    for corruption in corruptions:
        for severity in severities:
            loader = get_cifar100c_loader(
                corruption, severity, data_dir, batch_size,
                device_normalize=device_normalize)
            loss, metrics = evaluate_one_epoch_fn(loader)
            row = {"corruption": corruption, "severity": int(severity),
                   "loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
            results.append(row)
            if verbose:
                print(f"[C100-C] {corruption}@{severity}: "
                      f"top1 {row.get('top1', float('nan')):.2f}%")
    return results


def summarize_corruption_results(results: List[dict]) -> dict:
    """Means overall / by severity / by corruption (reference
    `load_cifrar100_C.py:155-179`, `load_tinyimagenet_C.py:313-332`)."""
    def mean_of(rows, key="top1"):
        vals = [r[key] for r in rows if key in r]
        return float(np.mean(vals)) if vals else float("nan")

    by_sev: Dict[int, list] = {}
    by_corr: Dict[str, list] = {}
    for r in results:
        by_sev.setdefault(r["severity"], []).append(r)
        by_corr.setdefault(r["corruption"], []).append(r)
    return {
        "overall_top1": mean_of(results),
        "overall_top5": mean_of(results, "top5"),
        "by_severity": {s: mean_of(rows) for s, rows in sorted(by_sev.items())},
        "by_corruption": {c: mean_of(rows) for c, rows in sorted(by_corr.items())},
        "n_settings": len(results),
    }


# --------------------------------------------------------- Tiny-ImageNet-C

def _find_tinyc_dir(data_dir: str) -> Path:
    root = Path(data_dir)
    for cand in (root, root / "Tiny-ImageNet-C", root / "tiny-imagenet-c"):
        if cand.is_dir() and any(cand.glob("*/1")):
            return cand
    raise FileNotFoundError(
        f"Tiny-ImageNet-C not found under {data_dir}. Expected "
        f"{data_dir}/Tiny-ImageNet-C/<corruption>/<severity>/<wnid>/*.JPEG "
        f"(Zenodo 2536630 layout); no network egress to download."
    )


def list_tinyc_corruptions(data_dir: str) -> List[str]:
    base = _find_tinyc_dir(data_dir)
    return sorted(p.name for p in base.iterdir() if p.is_dir())


def get_tinyimagenet200c_loader_intersection(
    corruption: str,
    severity: int,
    data_dir: str,
    clean_wnid_to_label: Dict[str, int],
    batch_size: int = 256,
    img_size: int = 64,
    num_workers: int = 8,
    device_normalize: bool = False,
):
    """Loader over the intersection of C-set wnids and clean-train wnids,
    remapped onto the clean label indices (reference
    `load_tinyimagenet_C.py:172-244`). Returns (loader, kept_wnids)."""
    pil_image()  # the JPEGs are read in the loader's threads: fail here
    base = _find_tinyc_dir(data_dir)
    sev_dir = base / corruption / str(severity)
    if not sev_dir.is_dir():
        raise FileNotFoundError(f"missing {sev_dir}")
    paths, labels, kept = [], [], []
    for wnid_dir in sorted(sev_dir.iterdir()):
        wnid = wnid_dir.name
        if wnid not in clean_wnid_to_label:
            continue
        kept.append(wnid)
        label = clean_wnid_to_label[wnid]
        for img in sorted(wnid_dir.glob("*.JPEG")):
            paths.append(img)
            labels.append(label)
    if not paths:
        raise ValueError(
            f"no overlapping classes between clean set and {corruption}@{severity}"
        )
    tf = (RawTransform(img_size) if device_normalize
          else EvalTransform(img_size, IMAGENET_MEAN, IMAGENET_STD))
    loader = ArrayDataLoader(
        _ImageFileView(paths), np.asarray(labels, dtype=np.int64),
        batch_size=batch_size, shuffle=False, transform=tf,
        num_threads=max(1, num_workers))
    loader.device_normalize = ((IMAGENET_MEAN, IMAGENET_STD)
                               if device_normalize else None)
    return loader, kept


def evaluate_tinyc_suite(
    evaluate_one_epoch_fn: Callable,
    clean_wnid_to_label: Dict[str, int],
    data_dir: str = "./data",
    corruptions: Optional[Sequence[str]] = None,
    severities: Sequence[int] = (1, 3, 5),
    batch_size: int = 256,
    img_size: int = 64,
    verbose: bool = True,
    device_normalize: bool = False,
) -> List[dict]:
    """Reference `evaluate_tinyc_suite` (`load_tinyimagenet_C.py:266-311`)."""
    if corruptions is None:
        corruptions = list_tinyc_corruptions(data_dir)
    results = []
    for corruption in corruptions:
        for severity in severities:
            loader, kept = get_tinyimagenet200c_loader_intersection(
                corruption, severity, data_dir, clean_wnid_to_label,
                batch_size=batch_size, img_size=img_size,
                device_normalize=device_normalize)
            loss, metrics = evaluate_one_epoch_fn(loader)
            row = {"corruption": corruption, "severity": int(severity),
                   "n_classes": len(kept), "loss": float(loss),
                   **{k: float(v) for k, v in metrics.items()}}
            results.append(row)
            if verbose:
                print(f"[TinyC] {corruption}@{severity}: "
                      f"top1 {row.get('top1', float('nan')):.2f}% "
                      f"({len(kept)} classes)")
    return results


summarize_tinyc_results = summarize_corruption_results


def get_tiny_clean_intersection_loader(
    clean_test_loader_images,
    clean_test_labels,
    clean_wnid_to_label: Dict[str, int],
    data_dir: str,
    batch_size: int = 256,
    img_size: int = 64,
    num_workers: int = 8,
    device_normalize: bool = False,
):
    """Clean Tiny-ImageNet test set filtered to the classes that also exist
    in the corruption set (reference `load_tinyimagenet_C.py:334-398` — the
    "clean-182" baseline row in the published robustness table).

    Args:
      clean_test_loader_images: indexable uint8 image source for the clean
        test split.
      clean_test_labels: int array aligned with it.
    Returns (loader, kept_label_set).
    """
    base = _find_tinyc_dir(data_dir)
    c_wnids = set()
    for corr in base.iterdir():
        if not corr.is_dir():
            continue
        for sev in corr.iterdir():
            if sev.is_dir():
                c_wnids.update(p.name for p in sev.iterdir() if p.is_dir())
        break  # one corruption is enough to enumerate the class set
    kept_labels = sorted(
        clean_wnid_to_label[w] for w in c_wnids if w in clean_wnid_to_label
    )
    kept_set = set(kept_labels)
    labels = np.asarray(clean_test_labels)
    idxs = np.nonzero(np.isin(labels, kept_labels))[0]
    if len(idxs) == 0:
        raise ValueError("no clean-test samples overlap the corruption classes")

    class _Sub:
        def __getitem__(self, i):
            return np.asarray(clean_test_loader_images[int(idxs[i])])

        def __len__(self):
            return len(idxs)

    tf = (RawTransform(img_size) if device_normalize
          else EvalTransform(img_size, IMAGENET_MEAN, IMAGENET_STD))
    loader = ArrayDataLoader(
        _Sub(), labels[idxs].astype(np.int64), batch_size=batch_size,
        shuffle=False, transform=tf, num_threads=max(1, num_workers))
    loader.device_normalize = ((IMAGENET_MEAN, IMAGENET_STD)
                               if device_normalize else None)
    return loader, kept_set


def crosscheck_cifar100c_labels(data_dir: str, cifar_data_dir: str) -> bool:
    """Sanity utility (reference `load_cifrar100_C.py:182-206`): CIFAR-100-C
    labels.npy severity-1 slice must equal the clean CIFAR-100 test labels."""
    from outgridvit_tpu_torch.data.datasets import _load_cifar100_raw

    base = _find_cifar100c_dir(data_dir)
    c_labels = np.load(base / "labels.npy")[:10000]
    (_, _), (_, te_labels) = _load_cifar100_raw(cifar_data_dir)
    ok = bool(np.array_equal(np.asarray(c_labels), np.asarray(te_labels)))
    print(f"CIFAR-100-C label cross-check: {'OK' if ok else 'MISMATCH'}")
    return ok
