"""Dataset registry (twin of ``outgridvit_tpu/data/registry.py``): the
``data:`` section of a config -> ``(train, val, test)`` loaders."""

from __future__ import annotations

from typing import Any, Mapping, Optional


def build_dataloaders(data_cfg: Mapping[str, Any], num_classes: int,
                      seed: Optional[int] = None):
    from outgridvit_tpu_torch.data import datasets as D

    dataset = str(data_cfg.get("dataset", "cifar100")).lower()
    batch_size = int(data_cfg.get("batch_size", 128))
    num_workers = int(data_cfg.get("num_workers", 8))
    data_seed = data_cfg.get("seed", seed if seed is not None else 7)
    if data_seed is None:
        data_seed = seed if seed is not None else 7
    data_seed = int(data_seed)

    common = dict(
        batch_size=batch_size,
        data_dir=str(data_cfg.get("data_dir", "./data")),
        num_workers=num_workers,
        val_split=float(data_cfg.get("val_split", 0.0)),
        ra_num_ops=int(data_cfg.get("ra_num_ops", 2)),
        ra_magnitude=int(data_cfg.get("ra_magnitude", 7)),
        random_erasing_p=float(data_cfg.get("random_erasing_p", 0.25)),
        seed=data_seed,
        device_augment=bool(data_cfg.get("device_augment", False)),
    )

    if dataset == "cifar100":
        return D.get_cifar100_dataloaders(
            img_size=int(data_cfg.get("img_size", 32)), **common)
    if dataset == "svhn":
        return D.get_svhn_dataloaders(
            img_size=int(data_cfg.get("img_size", 32)), **common)
    if dataset in ("tinyimagenet200", "tinyimagenet", "tiny-imagenet"):
        return D.get_tinyimagenet200_hf_dataloaders(
            hf_name=str(data_cfg.get("hf_name", "zh-plus/tiny-imagenet")),
            img_size=int(data_cfg.get("img_size", 64)),
            drop_last=bool(data_cfg.get("drop_last", True)), **common)
    if dataset == "food101":
        return D.get_food101_dataloaders(
            hf_name=str(data_cfg.get("hf_name", "food101")),
            img_size=int(data_cfg.get("img_size", 64)), **common)
    if dataset in ("oxfordpets", "oxford-iiit-pet", "pets"):
        return D.get_oxfordpets_dataloaders(
            img_size=int(data_cfg.get("img_size", 64)), **common)
    if dataset == "synthetic":
        return D.get_synthetic_dataloaders(
            batch_size=batch_size,
            num_samples=int(data_cfg.get("num_samples", 256)),
            img_size=int(data_cfg.get("img_size", 32)),
            num_classes=num_classes, seed=data_seed,
            device_augment=bool(data_cfg.get("device_augment", False)))
    if dataset == "synthetic_structured":
        return D.get_synthetic_structured_dataloaders(
            batch_size=batch_size,
            num_samples=int(data_cfg.get("num_samples", 51200)),
            img_size=int(data_cfg.get("img_size", 32)),
            num_classes=num_classes, seed=data_seed,
            val_split=float(data_cfg.get("val_split", 0.1)),
            noise=float(data_cfg.get("noise", 80.0)),
            device_augment=bool(data_cfg.get("device_augment", True)))
    raise ValueError(
        "data.dataset must be 'cifar100', 'svhn', 'tinyimagenet200', "
        "'food101', 'oxfordpets', 'synthetic', or 'synthetic_structured'")
