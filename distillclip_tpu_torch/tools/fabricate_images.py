"""Fabricate an on-disk image corpus in the layout of the real datasets.

Port of ``distillclip_tpu/tools/fabricate_images.py`` (the same files, bit
for bit, from the same seed): a stand-in for MSCOCO and ImageNet, written as
real JPEG files so that the decoders, RandAugment and the ``prepare()``
caches run the true host path.  The layout is what ``combine_image_dataset``
and ``ms_coco`` read (reference combine_image_dataset.py:85-92):

    <out>/combined/0...jpg          # coco-prefixed train images
    <out>/combined/imagenet_...jpg  # imagenet-prefixed train images
    <out>/mscoco/val2017/*.jpg
    <out>/mscoco/annotations/captions_val2017.json
    <out>/mscoco/train2017/*.jpg    # with --coco-train N
    <out>/mscoco/annotations/captions_train2017.json

Usage:
    python -m distillclip_tpu_torch.tools.fabricate_images --out .cache/fab_images \
        --n-train 2048 --n-val 128
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

WORDS = (
    "a red bus parked near the station", "two dogs running on wet sand",
    "a bowl of fruit on a wooden table", "people crossing a busy street",
    "an airplane flying over snowy mountains", "a cat sleeping on a keyboard",
    "surfers waiting for the next wave", "a plate of pasta with basil",
)


def _write_jpeg(path: str, rng: np.random.Generator, size: int):
    # smooth random field -> JPEG-friendly content with non-trivial decode cost
    low = rng.integers(0, 255, size=(size // 8, size // 8, 3), dtype=np.uint8)
    img = Image.fromarray(low).resize((size, size), Image.BICUBIC)
    img.save(path, format="JPEG", quality=88)


def fabricate(out: str, n_train: int = 2048, n_val: int = 128,
              size: int = 224, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    combined = os.path.join(out, "combined")
    val_dir = os.path.join(out, "mscoco", "val2017")
    ann_dir = os.path.join(out, "mscoco", "annotations")
    for d in (combined, val_dir, ann_dir):
        os.makedirs(d, exist_ok=True)

    for i in range(n_train):
        # half coco-prefixed ('0...'), half imagenet-prefixed
        name = (f"{i:012d}.jpg" if i % 2 == 0 else f"imagenet_{i:08d}.jpg")
        _write_jpeg(os.path.join(combined, name), rng, size)

    images, annotations = [], []
    for i in range(n_val):
        name = f"{i:012d}.jpg"
        _write_jpeg(os.path.join(val_dir, name), rng, size)
        images.append({"id": i, "file_name": name})
        annotations.append({
            "id": 10_000 + i, "image_id": i,
            "caption": WORDS[i % len(WORDS)] + f" number {i}",
        })
    with open(os.path.join(ann_dir, "captions_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print(f"fabricated {n_train} train + {n_val} val JPEGs under {out}")


def fabricate_coco_train(out: str, n_train: int = 256, size: int = 224,
                         seed: int = 1) -> None:
    """Also emit a train2017 split (stage-3 COCODataset shape): the tiny
    corpus behind the cached-teachers quality A/B (BENCH_NOTES round 4)."""
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(out, "mscoco", "train2017")
    ann_dir = os.path.join(out, "mscoco", "annotations")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_train):
        name = f"{i:012d}.jpg"
        _write_jpeg(os.path.join(train_dir, name), rng, size)
        images.append({"id": i, "file_name": name})
        annotations.append({
            "id": 20_000 + i, "image_id": i,
            "caption": WORDS[i % len(WORDS)] + f" number {i}",
        })
    with open(os.path.join(ann_dir, "captions_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print(f"fabricated {n_train} train2017 JPEGs under {out}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--n-val", type=int, default=128)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coco-train", type=int, default=0,
                   help="also emit a train2017 split with N images "
                        "(stage-3 COCODataset shape)")
    a = p.parse_args()
    fabricate(a.out, a.n_train, a.n_val, a.size, a.seed)
    if a.coco_train:
        fabricate_coco_train(a.out, a.coco_train, a.size, a.seed + 1)


if __name__ == "__main__":
    main()
