"""Synthetic datasets for tests, smoke configs and benchmarks.

Port of ``distillclip_tpu/data/component/synthetic.py`` (framework-free, so a
copy): deterministic, correctly shaped items from seeded numpy generators, the
same items bit for bit as the JAX package's, so that every stage runs without
the real corpora.
"""

from __future__ import annotations

import numpy as np

from distillclip_tpu_torch.data.loader import MapDataset


class SyntheticTextDataset(MapDataset):
    """Stage-2-shaped data: tokens (+ fake contrary reps for val)."""

    def __init__(self, size: int = 256, context_length: int = 77,
                 vocab_size: int = 49408, embed_dim: int = 512, train: bool = True,
                 seed: int = 0):
        rng = np.random.default_rng(seed + (0 if train else 1))
        self.tokens = rng.integers(
            1, vocab_size - 2, size=(size, context_length), dtype=np.int32
        )
        self.tokens[:, 0] = vocab_size - 2  # sot
        eot_pos = rng.integers(2, context_length, size=(size,))
        for i, p in enumerate(eot_pos):
            self.tokens[i, p] = vocab_size - 1  # eot = max id (argmax pooling)
            self.tokens[i, p + 1 :] = 0
        self.train = train
        self.contrary = rng.normal(size=(size, embed_dim)).astype(np.float32)

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, idx):
        if self.train:
            return {"inputs": self.tokens[idx]}
        return {"inputs": self.tokens[idx], "contrary": self.contrary[idx]}


class SyntheticImageDataset(MapDataset):
    """Stage-1-shaped data: images (+ fake contrary reps for val)."""

    def __init__(self, size: int = 256, image_size: int = 224, embed_dim: int = 512,
                 train: bool = True, seed: int = 0):
        self.size = size
        self.image_size = image_size
        self.train = train
        self.seed = seed + (0 if train else 1)
        rng = np.random.default_rng(self.seed)
        self.contrary = rng.normal(size=(size, embed_dim)).astype(np.float32)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img = rng.normal(size=(self.image_size, self.image_size, 3)).astype(np.float32)
        if self.train:
            return {"inputs": img}
        return {"inputs": img, "contrary": self.contrary[idx]}


class SyntheticPairDataset(MapDataset):
    """Stage-3-shaped data: (image, tokens) pairs.

    Perf-measurement extras (used by the bench-shaped hardware fit,
    configs/bench_fit_lclip.yaml):

    * ``uint8=True`` emits raw uint8 pixels (the production wire format —
      native JPEG decode emits uint8, normalization happens on device);
    * ``image_pool`` pre-generates that many distinct images at
      construction and serves zero-copy views, so a single-core host can
      feed bench-scale batches without the input pipeline becoming the
      bottleneck being measured;
    * ``cached_text_rep_dim`` adds a per-sample 'tea_rep' (fp32 [D]) so
      the trainer auto-selects the cached-text-teacher step — the bench
      headline configuration.
    """

    def __init__(self, size: int = 256, image_size: int = 224, context_length: int = 77,
                 vocab_size: int = 49408, train: bool = True, seed: int = 0,
                 uint8: bool = False, image_pool: int = 0,
                 cached_text_rep_dim: int = 0):
        self.size = size
        self.image_size = image_size
        self.uint8 = uint8
        self.seed = seed + (0 if train else 1)
        rng = np.random.default_rng(self.seed)
        self.tokens = rng.integers(
            1, vocab_size - 2, size=(size, context_length), dtype=np.int32
        )
        self.tokens[:, -1] = vocab_size - 1
        self.pool = None
        if image_pool:
            n = min(image_pool, size)
            shape = (n, image_size, image_size, 3)
            self.pool = (
                rng.integers(0, 256, size=shape, dtype=np.uint8)
                if uint8 else rng.normal(size=shape).astype(np.float32)
            )
        self.tea_rep = None
        if cached_text_rep_dim:
            self.tea_rep = rng.normal(
                size=(size, cached_text_rep_dim)).astype(np.float32)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        if self.pool is not None:
            img = self.pool[idx % len(self.pool)]
        else:
            rng = np.random.default_rng(self.seed * 100003 + idx)
            if self.uint8:
                img = rng.integers(
                    0, 256, size=(self.image_size, self.image_size, 3),
                    dtype=np.uint8)
            else:
                img = rng.normal(
                    size=(self.image_size, self.image_size, 3)).astype(np.float32)
        item = {"images": img, "tokens": self.tokens[idx]}
        if self.tea_rep is not None:
            item["tea_rep"] = self.tea_rep[idx]
        return item
