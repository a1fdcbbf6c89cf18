"""Dataset loaders (twin of ``outgridvit_tpu/data/datasets.py``): CIFAR-100,
SVHN, Tiny-ImageNet-200, Food-101, Oxford-IIIT Pets and two synthetic
sets.

Each ``get_*_dataloaders`` returns ``(train_loader, val_loader_or_None,
test_loader)`` of :class:`~outgridvit_tpu_torch.data.pipeline.ArrayDataLoader`
with the JAX package's recipe, seed-stable train/val split and per-image
generators, so that for the same files and seed the loaders yield the
JAX loaders' batches bit for bit: NHWC float32 (normalized on the host) or,
with ``device_augment``, raw uint8 with the train loader carrying its
:class:`~outgridvit_tpu_torch.ops.augment.AugmentConfig`
(``loader.device_augment``) and the eval loaders their ``(mean, std)``
(``loader.device_normalize``); int32 labels.

Every loader reads an on-disk layout from ``data_dir`` and raises a
``FileNotFoundError`` naming it when the files are absent; nothing
downloads. ``scipy`` (SVHN), ``datasets`` (Tiny-ImageNet, Food-101) and PIL
(Pets, host augmentation) are imported only by the loaders that need them.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from outgridvit_tpu_torch.data.pipeline import ArrayDataLoader
from outgridvit_tpu_torch.data.transforms import (
    EvalTransform,
    RawTransform,
    TrainTransform,
)
from outgridvit_tpu_torch.ops.augment import AugmentConfig

CIFAR100_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR100_STD = (0.2675, 0.2565, 0.2761)
SVHN_MEAN = (0.4377, 0.4438, 0.4728)
SVHN_STD = (0.1980, 0.2010, 0.1970)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _split_train_val(n: int, val_split: float,
                     seed: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Seed-stable random train/val split."""
    if val_split <= 0.0:
        return np.arange(n), None
    n_val = int(n * val_split)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[n_val:], perm[:n_val]


def _make_loaders(train_images, train_labels, test_images, test_labels, *,
                  native_size: int, mean, std, batch_size: int,
                  val_split: float, seed: int, img_size: int,
                  ra_num_ops: int = 2, ra_magnitude: int = 7,
                  random_erasing_p: float = 0.25,
                  crop_pad: Optional[int] = None, num_threads: int = 8,
                  drop_last: bool = False, enable_augs: bool = True,
                  device_augment: bool = False):
    pad = crop_pad if crop_pad is not None else max(4, img_size // 8)
    if device_augment:
        # the host only resizes; the recipe runs in the train step and the
        # eval step normalizes
        train_tf = eval_tf = RawTransform(img_size)
        aug_cfg = AugmentConfig(
            mean=tuple(mean), std=tuple(std), crop_pad=pad,
            ra_num_ops=ra_num_ops, ra_magnitude=ra_magnitude,
            random_erasing_p=random_erasing_p, enable_augs=enable_augs)
        norm_cfg = (tuple(mean), tuple(std))
    else:
        train_tf = TrainTransform(
            img_size, native_size, mean, std, ra_num_ops, ra_magnitude,
            random_erasing_p, crop_pad=crop_pad, enable_augs=enable_augs)
        eval_tf = EvalTransform(img_size, mean, std)
        aug_cfg = norm_cfg = None

    def subset(idx):
        if isinstance(train_images, np.ndarray):
            return train_images[idx]
        return _Subset(train_images, idx)

    tr_idx, va_idx = _split_train_val(len(train_labels), val_split, seed)
    train_loader = ArrayDataLoader(
        subset(tr_idx), np.asarray(train_labels)[tr_idx],
        batch_size=batch_size, shuffle=True, transform=train_tf, seed=seed,
        drop_last=drop_last, num_threads=num_threads)
    train_loader.device_augment = aug_cfg
    val_loader = None
    if va_idx is not None:
        val_loader = ArrayDataLoader(
            subset(va_idx), np.asarray(train_labels)[va_idx],
            batch_size=batch_size, shuffle=False, transform=eval_tf,
            seed=seed, num_threads=num_threads)
        val_loader.device_normalize = norm_cfg
    test_loader = ArrayDataLoader(
        test_images, np.asarray(test_labels), batch_size=batch_size,
        shuffle=False, transform=eval_tf, seed=seed, num_threads=num_threads)
    test_loader.device_normalize = norm_cfg
    return train_loader, val_loader, test_loader


class _Subset:
    def __init__(self, base, idxs):
        self.base = base
        self.idxs = np.asarray(idxs)

    def __getitem__(self, i):
        return self.base[int(self.idxs[i])]

    def __len__(self):
        return len(self.idxs)


def pil_image():
    """PIL's ``Image`` module, or an ImportError that says the image-file
    readers need it (the GPU machine has no PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading JPEG / PNG image files needs PIL "
                          "(Pillow), which is not installed here") from e
    return Image


class _ImageFileView:
    """Lazy uint8 RGB view over a list of image files (PIL)."""

    def __init__(self, paths: List[Path]):
        self.paths = paths

    def __getitem__(self, i):
        return np.asarray(pil_image().open(self.paths[int(i)]).convert("RGB"))

    def __len__(self):
        return len(self.paths)


# ----------------------------------------------------------------- CIFAR-100

def _load_cifar100_raw(data_dir: str):
    root = Path(data_dir)
    base = None
    for cand in (root / "cifar-100-python", root):
        if (cand / "train").exists() and (cand / "test").exists():
            base = cand
            break
    if base is None:
        raise FileNotFoundError(
            f"CIFAR-100 python pickles not found under {data_dir}. Expected "
            f"{data_dir}/cifar-100-python/{{train,test}} (standard "
            f"cifar-100-python.tar.gz layout); nothing is downloaded.")

    def load(split):
        with open(base / split, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = np.asarray(d[b"fine_labels"], dtype=np.int64)
        return np.ascontiguousarray(imgs), labels

    return load("train"), load("test")


def get_cifar100_dataloaders(batch_size: int = 128, data_dir: str = "./data",
                             num_workers: int = 8, val_split: float = 0.0,
                             pin_memory: bool = True, ra_num_ops: int = 2,
                             ra_magnitude: int = 7,
                             random_erasing_p: float = 0.25,
                             img_size: int = 32, seed: int = 7,
                             device_augment: bool = False):
    """``pin_memory`` is accepted for config compatibility (the
    ``Prefetcher`` pins)."""
    if img_size < 32:
        raise ValueError("img_size must be >= 32 for CIFAR-100")
    (xtr, ytr), (xte, yte) = _load_cifar100_raw(data_dir)
    return _make_loaders(
        xtr, ytr, xte, yte, native_size=32, mean=CIFAR100_MEAN,
        std=CIFAR100_STD, batch_size=batch_size, val_split=val_split,
        seed=seed, img_size=img_size, ra_num_ops=ra_num_ops,
        ra_magnitude=ra_magnitude, random_erasing_p=random_erasing_p,
        num_threads=max(1, num_workers), device_augment=device_augment)


# ----------------------------------------------------------------- SVHN

def _load_svhn_raw(data_dir: str):
    try:
        import scipy.io
    except ImportError as e:
        raise ImportError("the SVHN loader reads .mat files with scipy") from e
    root = Path(data_dir)

    def load(split):
        path = None
        for cand in (root / f"{split}_32x32.mat",
                     root / "svhn" / f"{split}_32x32.mat"):
            if cand.exists():
                path = cand
                break
        if path is None:
            raise FileNotFoundError(
                f"SVHN {split}_32x32.mat not found under {data_dir}; "
                f"nothing is downloaded.")
        d = scipy.io.loadmat(str(path))
        imgs = np.ascontiguousarray(d["X"].transpose(3, 0, 1, 2))
        labels = d["y"].reshape(-1).astype(np.int64)
        labels[labels == 10] = 0  # the digit 0 is stored as 10
        return imgs, labels

    return load("train"), load("test")


def get_svhn_dataloaders(batch_size: int = 128, data_dir: str = "./data",
                         num_workers: int = 8, val_split: float = 0.0,
                         pin_memory: bool = True, ra_num_ops: int = 2,
                         ra_magnitude: int = 7,
                         random_erasing_p: float = 0.25, img_size: int = 32,
                         seed: int = 7, device_augment: bool = False):
    (xtr, ytr), (xte, yte) = _load_svhn_raw(data_dir)
    return _make_loaders(
        xtr, ytr, xte, yte, native_size=32, mean=SVHN_MEAN, std=SVHN_STD,
        batch_size=batch_size, val_split=val_split, seed=seed,
        img_size=img_size, ra_num_ops=ra_num_ops, ra_magnitude=ra_magnitude,
        random_erasing_p=random_erasing_p, num_threads=max(1, num_workers),
        device_augment=device_augment)


# ------------------------------------------- Hugging Face datasets on disk

def _load_hf_dataset(hf_name: str, data_dir: str):
    """A Hugging Face dataset from a ``save_to_disk`` directory under
    ``data_dir``: named after the dataset, or ``data_dir`` itself. The JAX
    package also tries the hub cache, which may download; the port reads
    only what is on disk."""
    try:
        import datasets as hf_datasets
    except ImportError as e:
        raise ImportError(
            f"the '{hf_name}' loader needs the Hugging Face 'datasets' "
            "package") from e
    root = Path(data_dir)
    cands = (root / hf_name.replace("/", "___"),
             root / hf_name.split("/")[-1], root)
    for cand in cands:
        if (cand / "dataset_dict.json").exists():
            return hf_datasets.load_from_disk(str(cand))
    raise FileNotFoundError(
        f"no DatasetDict.save_to_disk tree (dataset_dict.json) for "
        f"'{hf_name}' in any of {[str(c) for c in cands]} (see "
        "scripts/prepare_data.py); nothing is downloaded")


class _HFImageView:
    """Lazy uint8 view over a Hugging Face image dataset split."""

    def __init__(self, split, image_key="image"):
        self.split = split
        self.image_key = image_key

    def __getitem__(self, i):
        return np.asarray(self.split[int(i)][self.image_key].convert("RGB"))

    def __len__(self):
        return len(self.split)


def get_tinyimagenet200_hf_dataloaders(
        batch_size: int = 128, data_dir: str = "./data",
        hf_name: str = "zh-plus/tiny-imagenet", num_workers: int = 8,
        val_split: float = 0.0, pin_memory: bool = True, ra_num_ops: int = 2,
        ra_magnitude: int = 7, random_erasing_p: float = 0.25,
        img_size: int = 64, drop_last: bool = True, seed: int = 7,
        enable_augs: bool = True, device_augment: bool = False):
    """Tiny-ImageNet-200 from a Hugging Face dataset on disk. ``val_split``
    carves val from train; the 'valid' split is the test set."""
    ds = _load_hf_dataset(hf_name, data_dir)
    train_split = ds["train"]
    test_split = ds["valid"] if "valid" in ds else ds["validation"]
    ytr = np.asarray(train_split["label"], dtype=np.int64)
    yte = np.asarray(test_split["label"], dtype=np.int64)
    return _make_loaders(
        _HFImageView(train_split), ytr, _HFImageView(test_split), yte,
        native_size=64, mean=IMAGENET_MEAN, std=IMAGENET_STD,
        batch_size=batch_size, val_split=val_split, seed=seed,
        img_size=img_size, ra_num_ops=ra_num_ops, ra_magnitude=ra_magnitude,
        random_erasing_p=random_erasing_p, crop_pad=max(8, img_size // 8),
        num_threads=max(1, num_workers), drop_last=drop_last,
        enable_augs=enable_augs, device_augment=device_augment)


def get_food101_dataloaders(batch_size: int = 128, data_dir: str = "./data",
                            hf_name: str = "food101", num_workers: int = 8,
                            val_split: float = 0.0, img_size: int = 64,
                            seed: int = 7, **_):
    """Food-101 from a Hugging Face dataset on disk; resize and normalize
    only (no augmentation)."""
    ds = _load_hf_dataset(hf_name, data_dir)
    train_split = ds["train"]
    test_split = ds["validation"] if "validation" in ds else ds["test"]
    ytr = np.asarray(train_split["label"], dtype=np.int64)
    yte = np.asarray(test_split["label"], dtype=np.int64)
    return _make_loaders(
        _HFImageView(train_split), ytr, _HFImageView(test_split), yte,
        native_size=img_size, mean=IMAGENET_MEAN, std=IMAGENET_STD,
        batch_size=batch_size, val_split=val_split, seed=seed,
        img_size=img_size, num_threads=max(1, num_workers),
        enable_augs=False)


# ------------------------------------------------ Oxford-IIIT Pets

def get_oxfordpets_dataloaders(batch_size: int = 128,
                               data_dir: str = "./data",
                               num_workers: int = 8, val_split: float = 0.0,
                               img_size: int = 64, seed: int = 7, **_):
    """Oxford-IIIT Pets from the official layout (``images/`` and
    ``annotations/{trainval,test}.txt``), official splits, no
    augmentation."""
    root = Path(data_dir)
    base = None
    for cand in (root, root / "oxford-iiit-pet"):
        if (cand / "annotations" / "trainval.txt").exists():
            base = cand
            break
    if base is None:
        raise FileNotFoundError(
            f"Oxford-IIIT Pets not found under {data_dir}. Expected "
            f"{data_dir}/oxford-iiit-pet/{{images/, annotations/trainval.txt,"
            f" annotations/test.txt}}; nothing is downloaded.")

    def load_split(name):
        paths, labels = [], []
        for line in (base / "annotations"
                     / f"{name}.txt").read_text().splitlines():
            if not line.strip():
                continue
            stem, class_id = line.split()[0], int(line.split()[1])
            img = base / "images" / f"{stem}.jpg"
            if img.exists():
                paths.append(img)
                labels.append(class_id - 1)
        return paths, np.asarray(labels, dtype=np.int64)

    tr_paths, ytr = load_split("trainval")
    te_paths, yte = load_split("test")
    return _make_loaders(
        _ImageFileView(tr_paths), ytr, _ImageFileView(te_paths), yte,
        native_size=img_size, mean=IMAGENET_MEAN, std=IMAGENET_STD,
        batch_size=batch_size, val_split=val_split, seed=seed,
        img_size=img_size, num_threads=max(1, num_workers),
        enable_augs=False)


def tinyimagenet_wnid_to_label(
    data_dir: str = "./data", hf_name: str = "zh-plus/tiny-imagenet"
) -> dict:
    """wnid -> clean label index map, needed by the Tiny-ImageNet-C
    intersection loaders (``data/corruptions.py``): the names of the HF
    ``ClassLabel`` feature of the clean train split, read from the
    ``save_to_disk`` tree under ``data_dir`` (the HF ``datasets`` package is
    imported here)."""
    ds = _load_hf_dataset(hf_name, data_dir)
    names = ds["train"].features["label"].names
    return {wnid: i for i, wnid in enumerate(names)}


# ----------------------------------------------------------------- synthetic

def _structured_protos(rng: np.random.Generator, num_classes: int,
                       img_size: int) -> np.ndarray:
    """Low-frequency class prototypes: upsampled 8x8 noise."""
    small = rng.uniform(40, 215, (num_classes, 8, 8, 3))
    reps = img_size // 8 + (img_size % 8 > 0)
    return np.kron(small, np.ones((1, reps, reps, 1)))[:, :img_size,
                                                       :img_size]


def _structured_draw(protos: np.ndarray, n: int, r: np.random.Generator,
                     num_classes: int, noise: float):
    """n samples: the class prototype under pixel noise, a brightness shift
    and a random roll."""
    y = r.integers(0, num_classes, size=(n,)).astype(np.int64)
    x = protos[y]
    x = x + r.normal(0.0, noise, x.shape)
    x = x + r.uniform(-25, 25, (n, 1, 1, 1))
    shift = r.integers(-4, 5, size=(n, 2))
    x = np.stack([np.roll(im, tuple(s), axis=(0, 1))
                  for im, s in zip(x, shift)])
    return np.clip(x, 0, 255).astype(np.uint8), y


def synth_structured_arrays(num_samples: int, img_size: int = 32,
                            num_classes: int = 100, seed: int = 7,
                            noise: float = 80.0, proto_seed: int = 7):
    """Raw uint8 draws of the structured generator with the prototypes from
    ``(proto_seed, "prot")`` and the samples from ``seed``."""
    protos = _structured_protos(np.random.default_rng(
        np.random.SeedSequence((proto_seed, 0x70726F74))), num_classes,
        img_size)
    return _structured_draw(protos, num_samples,
                            np.random.default_rng(seed), num_classes, noise)


def get_synthetic_structured_dataloaders(
        batch_size: int = 128, num_samples: int = 51200, img_size: int = 32,
        num_classes: int = 100, seed: int = 7, val_split: float = 0.1,
        noise: float = 80.0, device_augment: bool = True, **_):
    """A learnable synthetic set: each class a fixed low-frequency
    prototype, each sample its prototype under heavy noise, a brightness
    shift and a roll; train/val and test are disjoint draws of one
    process."""
    rng = np.random.default_rng(seed)
    protos = _structured_protos(rng, num_classes, img_size)
    xtr, ytr = _structured_draw(protos, num_samples, rng, num_classes, noise)
    xte, yte = _structured_draw(protos, max(1000, num_samples // 10),
                                np.random.default_rng(seed + 1), num_classes,
                                noise)
    return _make_loaders(
        xtr, ytr, xte, yte, native_size=img_size,
        mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
        batch_size=batch_size, val_split=val_split, seed=seed,
        img_size=img_size, device_augment=device_augment)


def get_synthetic_dataloaders(batch_size: int = 64, num_samples: int = 256,
                              img_size: int = 32, num_classes: int = 100,
                              seed: int = 7, device_augment: bool = False):
    """Random-tensor dataset for smoke runs; with ``device_augment`` the
    images are raw uint8 and the loader carries an AugmentConfig."""
    rng = np.random.default_rng(seed)
    if device_augment:
        images = rng.integers(0, 255, (num_samples, img_size, img_size, 3),
                              dtype=np.uint8)
    else:
        images = rng.standard_normal(
            (num_samples, img_size, img_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(num_samples,)).astype(
        np.int64)
    loader = ArrayDataLoader(images, labels, batch_size=batch_size,
                             shuffle=True, transform=None, seed=seed,
                             num_threads=1)
    if device_augment:
        loader.device_augment = AugmentConfig(
            mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
            crop_pad=max(4, img_size // 8))
        loader.device_normalize = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    return loader, None, None
