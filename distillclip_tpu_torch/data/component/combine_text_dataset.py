"""Stage-2 text-distillation data: Conceptual Captions and COCO captions
(``configs/final/text.yaml``).

Port of ``distillclip_tpu/data/component/combine_text_dataset.py``:

* ``prepare``: the train captions of ``text_use`` (the CC3M tsv's first
  column, COCO train2017's captions) tokenised into one token cache; with
  ``cache_train_reps`` the text teacher's representations of those tokens
  (the stage-2 cached step drops the teacher); and a validation cache of the
  COCO val2017 first captions, their tokens and the image teacher's
  representations of their images.  The teacher runs on the run's device.
* train items: one token row (+ ``tea_rep``); validation items: tokens and
  the image teacher's representation.

Items: train ``{'inputs': tokens}``, validation ``{'inputs': tokens,
'contrary': image_rep}``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from distillclip_tpu_torch.data.component.ms_coco import load_coco_index
from distillclip_tpu_torch.data.loader import MapDataset
from distillclip_tpu_torch.data.tokenizer import build_tokenizer

log = logging.getLogger(__name__)


def _train_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'text-cache-train-{teacher_name.replace("/", "-")}.npz'


def _val_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'text-cache-val-{teacher_name.replace("/", "-")}.npz'


def _train_rep_cache(cache_dir, teacher_name) -> Path:
    return Path(cache_dir) / f'text-cache-train-reps-{teacher_name.replace("/", "-")}.npz'


def prepare(prepare_args: dict) -> None:
    from distillclip_tpu_torch.data.component.utils import (
        encode_images,
        encode_tokens,
        encoder_args,
    )

    cache_dir = Path(prepare_args["cache_dir"])
    raw_data_dir = Path(prepare_args["raw_data_dir"])
    teacher_name = prepare_args["teacher_name"]
    overwrite = prepare_args.get("overwrite", False)
    text_use = prepare_args.get("text_use", ["cc"])
    context_length = prepare_args.get("context_length", 77)
    enc = encoder_args(prepare_args)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tokenizer = build_tokenizer(prepare_args.get("bpe_path"), context_length=context_length)

    train_cache = _train_cache(cache_dir, teacher_name)
    if overwrite or not train_cache.exists():
        raw_text = []
        if "cc" in text_use:
            with (raw_data_dir / "cc" / "train_cc3m.tsv").open("r", encoding="utf8") as f:
                raw_text.extend(line.split("\t")[0] for line in f)
        if "coco" in text_use:
            coco = raw_data_dir / "mscoco" / "annotations" / "captions_train2017.json"
            with coco.open("r", encoding="utf8") as f:
                raw_text.extend(ann["caption"] for ann in json.load(f)["annotations"])
        log.info("All data: %d. Begin tokenizing...", len(raw_text))
        np.savez(train_cache, tokens=tokenizer.tokenize(raw_text, context_length=context_length))

    if prepare_args.get("cache_train_reps"):
        rep_cache = _train_rep_cache(cache_dir, teacher_name)
        if overwrite or not rep_cache.exists():
            reps = encode_tokens(np.load(train_cache)["tokens"], teacher_name, **enc)
            np.savez(rep_cache, train_rep=reps)

    val_cache = _val_cache(cache_dir, teacher_name)
    if overwrite or not val_cache.exists():
        val_dir = raw_data_dir / "mscoco" / "val2017"
        index = load_coco_index(
            str(raw_data_dir / "mscoco" / "annotations" / "captions_val2017.json"))
        captions = [caps[0] for _, caps in index]
        paths = [str(val_dir / name) for name, _ in index]
        np.savez(val_cache, captions=np.asarray(captions),
                 tokens=tokenizer.tokenize(captions, context_length=context_length),
                 paths=np.asarray(paths), image_rep=encode_images(paths, teacher_name, **enc))


class CombineTextDataset(MapDataset):
    def __init__(self, cache_dir: str = "./.cache", train: bool = True,
                 teacher_name: str = "ViT-B/32", cached_teacher_reps: bool = False):
        self.train = train
        self.train_rep = None
        if not train:
            data = np.load(_val_cache(cache_dir, teacher_name), allow_pickle=False)
            self.tokens = data["tokens"]
            self.image_rep = data["image_rep"]
            return
        self.tokens = np.load(_train_cache(cache_dir, teacher_name))["tokens"]
        if cached_teacher_reps:
            rep_cache = _train_rep_cache(cache_dir, teacher_name)
            if not rep_cache.exists():
                raise FileNotFoundError(f"{rep_cache} not found: run prepare with "
                                        "cache_train_reps=true to pre-encode the train corpus")
            self.train_rep = np.load(rep_cache)["train_rep"]
            if len(self.train_rep) != len(self.tokens):
                raise ValueError(f"teacher-rep cache rows ({len(self.train_rep)}) != train "
                                 f"tokens ({len(self.tokens)}); re-run prepare with "
                                 "overwrite=true")

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, idx):
        if not self.train:
            return {"inputs": self.tokens[idx], "contrary": self.image_rep[idx]}
        if self.train_rep is not None:
            return {"inputs": self.tokens[idx], "tea_rep": self.train_rep[idx]}
        return {"inputs": self.tokens[idx]}
