"""Host-side image transforms: resize the shorter side, center crop,
RandAugment, CLIP-normalise.

Port of ``distillclip_tpu/data/transforms.py`` (the reference's torchvision
stacks, data/component/ms_coco.py:16-27, and its vendored RandAugment), on
PIL, to HWC float32 numpy (the NHWC layout the towers take).  Given the same
``random.Random``, :class:`RandAugment` draws the same ops and magnitudes as
the JAX package's and returns the same pixels.  PIL is imported where an
image is transformed, so the module imports without it.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shorter(img, size: int):
    """torchvision Resize(size): scale the shorter side to ``size`` (bicubic)."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img, size: int):
    from PIL import Image

    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    if left < 0 or top < 0:  # pad-then-crop for small images
        padded = Image.new(img.mode, (max(w, size), max(h, size)))
        padded.paste(img, ((max(w, size) - w) // 2, (max(h, size) - h) // 2))
        img, (w, h) = padded, padded.size
        left = (w - size) // 2
        top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_normalized_array(img) -> np.ndarray:
    """PIL image -> HWC float32, CLIP-normalised."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return (arr - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(IMAGE_STD, np.float32)


# -- RandAugment (the reference's rand_augment.py:90-166; torchvision's op space) --


def _affine(img, matrix):
    from PIL import Image

    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.NEAREST)


def _apply_op(img, op_name: str, magnitude: float):
    from PIL import Image, ImageEnhance, ImageOps

    if op_name == "ShearX":
        return _affine(img, (1, -magnitude, 0, 0, 1, 0))
    if op_name == "ShearY":
        return _affine(img, (1, 0, 0, -magnitude, 1, 0))
    if op_name == "TranslateX":
        return _affine(img, (1, 0, -int(magnitude), 0, 1, 0))
    if op_name == "TranslateY":
        return _affine(img, (1, 0, 0, 0, 1, -int(magnitude)))
    if op_name == "Rotate":
        return img.rotate(magnitude, resample=Image.NEAREST)
    if op_name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + magnitude)
    if op_name == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + magnitude)
    if op_name == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + magnitude)
    if op_name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + magnitude)
    if op_name == "Posterize":
        return ImageOps.posterize(img, int(magnitude))
    if op_name == "Solarize":
        return ImageOps.solarize(img, int(magnitude))
    if op_name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if op_name == "Equalize":
        return ImageOps.equalize(img)
    if op_name == "Invert":
        return ImageOps.invert(img)
    if op_name == "Identity":
        return img
    raise ValueError(f"unknown RandAugment op {op_name}")


class RandAugment:
    """Torchvision-style RandAugment: ``num_ops`` ops drawn from ``rng`` at
    the fixed magnitude bin ``magnitude``, each signed op negated with
    probability 1/2."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9, num_magnitude_bins: int = 31,
                 rng: Optional[random.Random] = None):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.num_bins = num_magnitude_bins
        self.rng = rng or random.Random()

    def _space(self, image_size: Tuple[int, int]):
        W, H = image_size
        n = self.num_bins
        lin = lambda hi: np.linspace(0.0, hi, n)
        return {
            "Identity": (np.zeros(n), False),
            "ShearX": (lin(0.3), True),
            "ShearY": (lin(0.3), True),
            "TranslateX": (lin(150.0 / 331.0 * W), True),
            "TranslateY": (lin(150.0 / 331.0 * H), True),
            "Rotate": (lin(30.0), True),
            "Brightness": (lin(0.9), True),
            "Color": (lin(0.9), True),
            "Contrast": (lin(0.9), True),
            "Sharpness": (lin(0.9), True),
            "Posterize": (8 - (np.arange(n) / ((n - 1) / 4)).round(), False),
            "Solarize": (np.linspace(255.0, 0.0, n), False),
            "AutoContrast": (np.zeros(n), False),
            "Equalize": (np.zeros(n), False),
        }

    def __call__(self, img):
        space = self._space(img.size)
        names = list(space)
        for _ in range(self.num_ops):
            name = names[self.rng.randrange(len(names))]
            magnitudes, signed = space[name]
            mag = float(magnitudes[self.magnitude])
            if signed and self.rng.random() < 0.5:
                mag = -mag
            img = _apply_op(img, name, mag)
        return img


def train_image_transform(size: int = 224, rand_augment_ops: int = 4,
                          rng: Optional[random.Random] = None):
    """resize -> center crop -> RandAugment(``rand_augment_ops``) -> normalise."""
    ra = RandAugment(num_ops=rand_augment_ops, rng=rng)

    def apply(img) -> np.ndarray:
        return to_normalized_array(ra(center_crop(resize_shorter(img.convert("RGB"), size),
                                                  size)))

    return apply


def eval_image_transform(size: int = 224):
    """resize -> center crop -> normalise."""

    def apply(img) -> np.ndarray:
        return to_normalized_array(center_crop(resize_shorter(img.convert("RGB"), size), size))

    return apply
