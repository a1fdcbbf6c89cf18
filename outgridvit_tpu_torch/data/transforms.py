"""Host-side image transforms (twin of ``outgridvit_tpu/data/transforms.py``),
numpy and PIL, the same operations in the same order so that a transform
given the same ``numpy.random.Generator`` gives the same pixels:

  Resize(bicubic, if img_size != native) -> RandomCrop(pad=max(4, img/8)) ->
  RandomHorizontalFlip -> RandAugment(num_ops, magnitude) -> Normalize ->
  RandomErasing(p, scale=(0.02, 0.20), ratio=(0.3, 3.3), value=random)

PIL is imported only by what needs it (a resize, RandAugment): the raw
uint8 path of on-device augmentation (:class:`RawTransform` at the native
size) runs without it, as the GPU machine has no PIL.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np


def _pil():
    try:
        from PIL import Image, ImageEnhance, ImageOps
    except ImportError as e:
        raise ImportError(
            "the host image transforms (a resize, RandAugment) need PIL "
            "(pip package 'pillow'); with data.device_augment on and images "
            "at their native size the loaders need none") from e
    return Image, ImageEnhance, ImageOps


# ---------------------------------------------------------------- geometric

def resize(img: np.ndarray, size: int, method=None) -> np.ndarray:
    """Bicubic resize to ``size`` x ``size`` (PIL's filter ``method``)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    Image = _pil()[0]
    if method is None:
        method = Image.BICUBIC
    return np.asarray(Image.fromarray(img).resize((size, size), method))


def random_crop(img: np.ndarray, rng: np.random.Generator,
                padding: int) -> np.ndarray:
    h, w = img.shape[:2]
    padded = np.pad(img, ((padding, padding), (padding, padding), (0, 0)),
                    mode="constant")
    top = int(rng.integers(0, 2 * padding + 1))
    left = int(rng.integers(0, 2 * padding + 1))
    return padded[top:top + h, left:left + w]


def random_hflip(img: np.ndarray, rng: np.random.Generator,
                 p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


# ---------------------------------------------------------------- RandAugment

_NUM_BINS = 31


def _ra_space(num_bins: int, image_size: int):
    """(name -> magnitudes over the bins or None, signed), in the op order
    that the op draw indexes."""
    lin = np.linspace
    return {
        "Identity": (None, False),
        "ShearX": (lin(0.0, 0.3, num_bins), True),
        "ShearY": (lin(0.0, 0.3, num_bins), True),
        "TranslateX": (lin(0.0, 150.0 / 331.0 * image_size, num_bins), True),
        "TranslateY": (lin(0.0, 150.0 / 331.0 * image_size, num_bins), True),
        "Rotate": (lin(0.0, 30.0, num_bins), True),
        "Brightness": (lin(0.0, 0.9, num_bins), True),
        "Color": (lin(0.0, 0.9, num_bins), True),
        "Contrast": (lin(0.0, 0.9, num_bins), True),
        "Sharpness": (lin(0.0, 0.9, num_bins), True),
        "Posterize": (8 - (np.arange(num_bins)
                           / ((num_bins - 1) / 4)).round(), False),
        "Solarize": (lin(255.0, 0.0, num_bins), False),
        "AutoContrast": (None, False),
        "Equalize": (None, False),
    }


@lru_cache(maxsize=None)
def _ra_fns():
    """name -> (PIL image, magnitude) -> PIL image."""
    Image, ImageEnhance, ImageOps = _pil()

    def affine(coeffs):
        return lambda im, v: im.transform(im.size, Image.AFFINE, coeffs(v),
                                          resample=Image.NEAREST)

    def enhance(factory):
        return lambda im, v: factory(im).enhance(1.0 + v)

    return {
        "Identity": lambda im, v: im,
        "ShearX": affine(lambda v: (1, v, 0, 0, 1, 0)),
        "ShearY": affine(lambda v: (1, 0, 0, v, 1, 0)),
        "TranslateX": affine(lambda v: (1, 0, v, 0, 1, 0)),
        "TranslateY": affine(lambda v: (1, 0, 0, 0, 1, v)),
        "Rotate": lambda im, v: im.rotate(v, resample=Image.NEAREST),
        "Brightness": enhance(ImageEnhance.Brightness),
        "Color": enhance(ImageEnhance.Color),
        "Contrast": enhance(ImageEnhance.Contrast),
        "Sharpness": enhance(ImageEnhance.Sharpness),
        "Posterize": lambda im, v: ImageOps.posterize(im, int(v)),
        "Solarize": lambda im, v: ImageOps.solarize(im, int(v)),
        "AutoContrast": lambda im, v: ImageOps.autocontrast(im),
        "Equalize": lambda im, v: ImageOps.equalize(im),
    }


_RA_SPACE_CACHE: dict = {}


def rand_augment(img: np.ndarray, rng: np.random.Generator,
                 num_ops: int = 2, magnitude: int = 7) -> np.ndarray:
    """torchvision-style RandAugment: ``num_ops`` ops drawn uniformly from
    the 14-op space at the fixed ``magnitude`` bin (of 31), signs random."""
    size = img.shape[1]
    space = _RA_SPACE_CACHE.get(size)
    if space is None:
        space = _RA_SPACE_CACHE.setdefault(size, _ra_space(_NUM_BINS, size))
    fns = _ra_fns()
    names = list(space.keys())
    im = _pil()[0].fromarray(img)
    for _ in range(num_ops):
        name = names[int(rng.integers(0, len(names)))]
        mags, signed = space[name]
        v = float(mags[magnitude]) if mags is not None else 0.0
        if signed and rng.random() < 0.5:
            v = -v
        im = fns[name](im, v)
    return np.asarray(im)


# ---------------------------------------------------------------- tensorize

def normalize(img: np.ndarray, mean: Sequence[float],
              std: Sequence[float]) -> np.ndarray:
    """uint8 HWC -> float32 HWC in normalized units (ToTensor + Normalize)."""
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def random_erasing(img: np.ndarray, rng: np.random.Generator,
                   p: float = 0.25,
                   scale: Tuple[float, float] = (0.02, 0.20),
                   ratio: Tuple[float, float] = (0.3, 3.3)) -> np.ndarray:
    """RandomErasing with value='random' on a normalized float image: a
    rectangle filled with N(0, 1) noise."""
    if rng.random() >= p:
        return img
    h, w, c = img.shape
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(target_area * aspect)))
        ew = int(round(np.sqrt(target_area / aspect)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            top = int(rng.integers(0, h - eh + 1))
            left = int(rng.integers(0, w - ew + 1))
            img = img.copy()
            img[top:top + eh, left:left + ew] = rng.standard_normal(
                (eh, ew, c)).astype(np.float32)
            return img
    return img


# ---------------------------------------------------------------- pipelines

class TrainTransform:
    """The full train recipe on the host, as a picklable callable."""

    def __init__(self, img_size: int, native_size: int,
                 mean: Sequence[float], std: Sequence[float],
                 ra_num_ops: int = 2, ra_magnitude: int = 7,
                 random_erasing_p: float = 0.25,
                 crop_pad: Optional[int] = None, enable_augs: bool = True):
        self.img_size = img_size
        self.native_size = native_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.ra_num_ops = ra_num_ops
        self.ra_magnitude = ra_magnitude
        self.random_erasing_p = random_erasing_p
        self.crop_pad = (crop_pad if crop_pad is not None
                         else max(4, img_size // 8))
        self.enable_augs = enable_augs

    def __call__(self, img: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        if self.img_size != img.shape[0]:
            img = resize(img, self.img_size)
        if self.enable_augs:
            img = random_crop(img, rng, self.crop_pad)
            img = random_hflip(img, rng)
            if self.ra_num_ops > 0:
                img = rand_augment(img, rng, self.ra_num_ops,
                                   self.ra_magnitude)
        x = normalize(np.ascontiguousarray(img), self.mean, self.std)
        if self.enable_augs and self.random_erasing_p > 0:
            x = random_erasing(x, rng, p=self.random_erasing_p)
        return x


class RawTransform:
    """Resize (if needed) only; uint8 HWC out, for the recipe on the card
    (``ops/augment.py``)."""

    def __init__(self, img_size: int):
        self.img_size = img_size

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        if self.img_size != img.shape[0]:
            img = resize(img, self.img_size)
        return np.ascontiguousarray(img)


class EvalTransform:
    """Resize (if needed) + normalize."""

    def __init__(self, img_size: int, mean: Sequence[float],
                 std: Sequence[float]):
        self.img_size = img_size
        self.mean = tuple(mean)
        self.std = tuple(std)

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        if self.img_size != img.shape[0]:
            img = resize(img, self.img_size)
        return normalize(np.ascontiguousarray(img), self.mean, self.std)
