"""Host-side eval image transform: resize the shorter side, center crop,
CLIP-normalise.

Port of the eval part of ``distillclip_tpu/data/transforms.py`` (the
reference's torchvision stack, data/component/ms_coco.py:23-27), on PIL, to
HWC float32 numpy (the NHWC layout the towers take).  PIL is imported where
an image is transformed, so the module imports without it.  The train-time
transforms (RandAugment) wait for the data path (ROADMAP queue 1: real datasets
and multi-GPU).
"""

from __future__ import annotations

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


def eval_image_transform(size: int = 224):
    """resize -> center crop -> normalise."""

    def apply(img) -> np.ndarray:
        return to_normalized_array(center_crop(resize_shorter(img.convert("RGB"), size), size))

    return apply
