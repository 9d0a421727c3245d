"""Stage-1 image-distillation data: MSCOCO and ImageNet in one flat folder
(``configs/final/image.yaml``).

Port of ``distillclip_tpu/data/component/combine_image_dataset.py``:

* ``prepare``: the COCO val2017 captions encoded by the teacher's text tower
  on the run's device, cached with their image paths (the validation set);
  with ``cache_train_image_reps`` also the train images by the image tower
  (the stage-1 all-cached step, valid only without augmentation);
* train items: images of the combined folder whose names start with the
  prefixes of ``image_use`` (coco '0', imagenet 'imagenet'), decoded by the
  native library to uint8 (PIL where it does not load: it warns once),
  RandAugmented, then normalised, or left uint8 under ``device_normalize``
  for the step to normalise on the device;
* validation items: the image and its caption's teacher representation.

A train-representation cache is checked against ``image_use``: every
requested corpus must occur in its paths and no other may.  (The JAX package
checks only the second half, so a cache built from fewer corpora than asked
passes there; the port refuses it.)

Items: train ``{'inputs': img}`` (+ ``tea_rep``), validation ``{'inputs':
img, 'contrary': rep}``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from distillclip_tpu_torch.data.component.ms_coco import load_coco_index
from distillclip_tpu_torch.data.component.utils import IMAGE_DATASET_NAME, IMAGE_PREFIX
from distillclip_tpu_torch.data.loader import MapDataset
from distillclip_tpu_torch.data.transforms import (
    RandAugment,
    center_crop,
    eval_image_transform,
    resize_shorter,
    to_normalized_array,
    train_image_transform,
)

log = logging.getLogger(__name__)


def _cache_path(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'image-cache-val-{teacher_name.replace("/", "-")}.npz'


def _train_rep_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'image-cache-train-reps-{teacher_name.replace("/", "-")}.npz'


def _train_paths(combine_dataset_path, image_use) -> List[str]:
    """The combined folder's train paths of the ``image_use`` corpora, sorted
    (the rep cache is keyed by row, so the order must be stable)."""
    prefixes = tuple(IMAGE_PREFIX[n] for n in image_use)
    return sorted(str(p) for p in Path(combine_dataset_path).iterdir()
                  if p.name.startswith(prefixes))


def prepare(prepare_args: dict) -> None:
    """The validation caption cache, and the train image cache under
    ``cache_train_image_reps``, encoded on ``prepare_args['device']``."""
    from distillclip_tpu_torch.data.component.utils import (
        encode_images,
        encode_texts,
        encoder_args,
    )

    raw_data_dir = Path(prepare_args["raw_data_dir"])
    cache_dir = Path(prepare_args["cache_dir"])
    teacher_name = prepare_args["teacher_name"]
    overwrite = prepare_args.get("overwrite", False)
    enc = encoder_args(prepare_args)
    cache_dir.mkdir(parents=True, exist_ok=True)

    cache_path = _cache_path(cache_dir, teacher_name)
    if overwrite or not cache_path.exists():
        # not an early return: the train-rep cache below still builds when
        # the validation cache exists
        val_dir = raw_data_dir / "mscoco" / "val2017"
        index = load_coco_index(
            str(raw_data_dir / "mscoco" / "annotations" / "captions_val2017.json"))
        captions = [caps[0] for _, caps in index]
        captions_rep = encode_texts(captions, teacher_name,
                                    bpe_path=prepare_args.get("bpe_path"), **enc)
        np.savez(cache_path, paths=np.asarray([str(val_dir / name) for name, _ in index]),
                 captions_rep=captions_rep, captions=np.asarray(captions))
        log.info("cache data saved in %s", cache_path)

    if prepare_args.get("cache_train_image_reps"):
        rep_cache = _train_rep_cache(cache_dir, teacher_name)
        if overwrite or not rep_cache.exists():
            paths = _train_paths(prepare_args["combine_dataset_path"],
                                 prepare_args.get("image_use") or ["coco", "imagenet"])
            reps = encode_images(paths, teacher_name, **enc)
            np.savez(rep_cache, paths=np.asarray(paths), train_rep=reps)


def check_cache_corpora(rep_cache, paths: List[str], image_use: List[str]) -> None:
    """Every path of the cache belongs to a corpus of ``image_use``, and every
    corpus of ``image_use`` has a path in the cache."""
    names = [os.path.basename(p) for p in paths]
    prefixes = tuple(IMAGE_PREFIX[n] for n in image_use)
    bad = [n for n in names if not n.startswith(prefixes)]
    if bad:
        raise ValueError(f"teacher-rep cache {rep_cache} was built from a different image_use "
                         f"than {image_use} (e.g. {bad[0]!r}); re-run prepare with "
                         "overwrite=true")
    missing = [u for u in image_use if not any(n.startswith(IMAGE_PREFIX[u]) for n in names)]
    if missing:
        raise ValueError(f"teacher-rep cache {rep_cache} holds no image of {missing}, which "
                         f"image_use {image_use} asks for; re-run prepare with overwrite=true")


class CombineImageDataset(MapDataset):
    _warned_pil_fallback = False

    def __init__(self, combine_dataset_path: str, train: bool = True,
                 image_use: Optional[List[str]] = None, cache_dir: str = "./.cache",
                 teacher_name: str = "ViT-B/32", image_size: int = 224,
                 rand_augment_ops: int = 4, use_native_decode: bool = True,
                 device_normalize: bool = False, augment_train: bool = True,
                 cached_teacher_reps: bool = False):
        self.device_normalize = device_normalize
        if image_use is None:
            image_use = ["coco", "imagenet"]
        for i in image_use:
            assert i in IMAGE_DATASET_NAME, (
                f"the {i} dataset name is not exists in {IMAGE_DATASET_NAME}")
        self.train = train
        self.augment_train = augment_train
        self.train_rep = None
        if not train:
            data = np.load(_cache_path(cache_dir, teacher_name), allow_pickle=False)
            self.path_list = [str(p) for p in data["paths"]]
            self.captions_rep = data["captions_rep"]
            self.captions = data["captions"]
            self.transform = eval_image_transform(image_size)
            return
        if cached_teacher_reps:
            if augment_train:
                raise ValueError(
                    "cached_teacher_reps requires augment_train: false "
                    "— RandAugmented pixels change every epoch, so the "
                    "teacher image reps are not per-sample constants "
                    "(reference keeps the image teacher live for exactly "
                    "this reason, combine_image_dataset.py:85-117)")
            rep_cache = _train_rep_cache(cache_dir, teacher_name)
            if not rep_cache.exists():
                raise FileNotFoundError(
                    f"{rep_cache} not found: run prepare with cache_train_image_reps=true "
                    "to pre-encode the train images")
            data = np.load(rep_cache, allow_pickle=False)
            self.path_list = [str(p) for p in data["paths"]]
            self.train_rep = data["train_rep"]
            check_cache_corpora(rep_cache, self.path_list, image_use)
        else:
            self.path_list = _train_paths(combine_dataset_path, image_use)
        self.transform = (train_image_transform(image_size, rand_augment_ops)
                          if augment_train else eval_image_transform(image_size))
        self.captions_rep = None
        self.image_size = image_size
        self.use_native_decode = use_native_decode
        self._rand_augment = RandAugment(num_ops=rand_augment_ops) if augment_train else None

    def __len__(self):
        return len(self.path_list)

    def _train_item(self, image, idx):
        item = {"inputs": image}
        if self.train_rep is not None:
            item["tea_rep"] = self.train_rep[idx]
        return item

    def _augmented(self, img):
        return self._rand_augment(img) if self._rand_augment is not None else img

    def __getitem__(self, idx):
        from PIL import Image

        from distillclip_tpu_torch.data import native_loader

        path = self.path_list[idx]
        if self.train and self.use_native_decode:
            raw = native_loader.decode_raw_file(path, self.image_size)
            if raw is not None:
                augmented = self._augmented(Image.fromarray(raw))
                if self.device_normalize:
                    return self._train_item(np.asarray(augmented.convert("RGB"), np.uint8), idx)
                return self._train_item(to_normalized_array(augmented), idx)
            if not CombineImageDataset._warned_pil_fallback:
                # the native path resizes bilinear / area, PIL bicubic: the
                # train pixels' statistics differ slightly
                CombineImageDataset._warned_pil_fallback = True
                log.warning("native decode unavailable/failed for %s; falling back to PIL "
                            "(bicubic resample — pixel statistics differ slightly from the "
                            "native bilinear/area path)", path)
        img = Image.open(path).convert("RGB")
        if self.train and self.device_normalize:
            sized = center_crop(resize_shorter(img, self.image_size), self.image_size)
            return self._train_item(np.asarray(self._augmented(sized).convert("RGB"), np.uint8),
                                    idx)
        image = self.transform(img)
        if self.train:
            return self._train_item(image, idx)
        return {"inputs": image, "contrary": self.captions_rep[idx]}
