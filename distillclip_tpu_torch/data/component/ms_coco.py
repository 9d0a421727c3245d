"""MSCOCO captions, the stage-3 dataset (``configs/final/l_clip.yaml``).

Port of ``distillclip_tpu/data/component/ms_coco.py``: the COCO annotation
JSON read directly (the reference's torchvision ``CocoCaptions``), the
train2017 / val2017 split, the first caption of each image, RandAugment on
the train images, and the optional teacher caches that ``prepare`` builds on
the run's device:

* ``cache_caption_reps``: the text teacher's representations of the train
  captions, so that the stage-3 step runs with the text teacher cached;
* ``cache_image_reps``: the image teacher's representations of the train
  images under the eval transform, valid only without augmentation (the
  all-cached step).

Items: ``{'images': [224, 224, 3] f32, 'tokens': [77] i32}`` (+ ``tea_rep``,
``tea_img_rep`` from the caches); under ``need_type`` 'text' / 'image' a
train item holds one of the two.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from distillclip_tpu_torch.data.loader import MapDataset
from distillclip_tpu_torch.data.tokenizer import build_tokenizer
from distillclip_tpu_torch.data.transforms import eval_image_transform, train_image_transform


def load_coco_index(annotation_file: str):
    """[(file_name, [captions...])] sorted by image id (CocoCaptions' order);
    images without a caption are left out."""
    with open(annotation_file) as f:
        data = json.load(f)
    id2file = {img["id"]: img["file_name"] for img in data["images"]}
    id2captions = {}
    for ann in data["annotations"]:
        id2captions.setdefault(ann["image_id"], []).append(ann["caption"])
    return [(id2file[i], id2captions[i]) for i in sorted(id2file) if id2captions.get(i)]


def _caption_rep_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'coco-caption-reps-train2017-{teacher_name.replace("/", "-")}.npz'


def _image_rep_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'coco-image-reps-train2017-{teacher_name.replace("/", "-")}.npz'


def prepare(prepare_args: dict) -> None:
    """Pre-encode the train2017 first captions (``cache_caption_reps``) and
    images (``cache_image_reps``) with the frozen teacher on
    ``prepare_args['device']``; a cache that exists is kept unless
    ``overwrite``."""
    if not (prepare_args.get("cache_caption_reps") or prepare_args.get("cache_image_reps")):
        return
    from distillclip_tpu_torch.data.component.utils import (
        encode_images,
        encode_texts,
        encoder_args,
    )

    cache_dir = prepare_args.get("cache_dir", "./.cache")
    teacher_name = prepare_args["teacher_name"]
    overwrite = prepare_args.get("overwrite", False)
    enc = encoder_args(prepare_args)
    os.makedirs(cache_dir, exist_ok=True)
    index = load_coco_index(
        os.path.join(prepare_args["annotation_path"], "captions_train2017.json"))

    if prepare_args.get("cache_caption_reps"):
        cache = _caption_rep_cache(cache_dir, teacher_name)
        if overwrite or not cache.exists():
            reps = encode_texts([caps[0] for _, caps in index], teacher_name,
                                bpe_path=prepare_args.get("bpe_path"), **enc)
            np.savez(cache, caption_rep=reps)

    if prepare_args.get("cache_image_reps"):
        cache = _image_rep_cache(cache_dir, teacher_name)
        if overwrite or not cache.exists():
            root = os.path.join(prepare_args["root_path"], "train2017")
            reps = encode_images([os.path.join(root, fn) for fn, _ in index], teacher_name,
                                 **enc)
            np.savez(cache, image_rep=reps)


def _load_rep_cache(cache: Path, key: str, rows: int, flag: str) -> np.ndarray:
    if not cache.exists():
        raise FileNotFoundError(f"{cache} not found: run prepare with {flag}=true to "
                                "pre-encode the train split")
    rep = np.load(cache)[key]
    if len(rep) != rows:
        raise ValueError(f"{key.replace('_', '-')} cache rows ({len(rep)}) != dataset size "
                         f"({rows}); re-run prepare with overwrite=true")
    return rep


class COCODataset(MapDataset):
    def __init__(self, root_path: str, annotation_path: str, need_type: str = "all",
                 train: bool = True, image_size: int = 224, context_length: int = 77,
                 bpe_path: Optional[str] = None, rand_augment_ops: int = 4,
                 cached_text_teacher_reps: bool = False,
                 cached_image_teacher_reps: bool = False, augment_train: bool = True,
                 cache_dir: str = "./.cache", teacher_name: str = "ViT-B/32"):
        if need_type not in ("all", "text", "image"):
            raise ValueError(
                "the mscoco dataset need_type parameter should is ['all', 'text', "
                f"'image'], bug get {need_type}")
        self.need_type = need_type
        self.train = train
        split = "train2017" if train else "val2017"
        self.root = os.path.join(root_path, split)
        self.index = load_coco_index(os.path.join(annotation_path, f"captions_{split}.json"))
        self.tokenizer = build_tokenizer(bpe_path, context_length=context_length)
        self.context_length = context_length
        self.transform = (train_image_transform(image_size, rand_augment_ops)
                          if train and augment_train else eval_image_transform(image_size))
        self.caption_rep = None
        self.image_rep = None
        if cached_image_teacher_reps and train:
            if augment_train:
                raise ValueError(
                    "cached_image_teacher_reps requires augment_train: false "
                    "— RandAugmented pixels change every epoch, so the "
                    "teacher image reps are not per-sample constants "
                    "(reference keeps the image teacher live for exactly "
                    "this reason, ms_coco.py:15-21)")
            self.image_rep = _load_rep_cache(_image_rep_cache(cache_dir, teacher_name),
                                             "image_rep", len(self.index), "cache_image_reps")
        if cached_text_teacher_reps and train:
            self.caption_rep = _load_rep_cache(_caption_rep_cache(cache_dir, teacher_name),
                                               "caption_rep", len(self.index),
                                               "cache_caption_reps")

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx):
        from PIL import Image

        file_name, captions = self.index[idx]
        tokens = self.tokenizer.tokenize(captions[0], context_length=self.context_length)[0]
        if self.need_type == "text" and self.train:
            return {"tokens": tokens}
        image = self.transform(Image.open(os.path.join(self.root, file_name)))
        if self.need_type == "image" and self.train:
            return {"images": image}
        item = {"images": image, "tokens": tokens}
        if self.caption_rep is not None:
            item["tea_rep"] = self.caption_rep[idx]
        if self.image_rep is not None:
            item["tea_img_rep"] = self.image_rep[idx]
        return item
