"""Image-text pairs in WebDataset-format tar shards.

Port of ``distillclip_tpu/data/component/text_image_webdataset.py`` (the
reference's data/text_image_datamodule.py): shards of jpg + txt members, a
shard-level train / validation split (10% validation), decode -> resize /
crop -> RandAugment(4) -> normalise for training, tokenised captions, and
batches of a fixed size (the partial batch dropped).  Under data parallelism
each process decodes its own batch of each run of ``world_size`` batches of
the shared stream, and yields it once the run is complete, so every process
runs the same number of batches.  The tar files are read directly (the
webdataset package is not a dependency): members are grouped by key, decoded
with PIL and streamed through a shuffle buffer.
"""

from __future__ import annotations

import io
import random
import tarfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from distillclip_tpu_torch.data.tokenizer import build_tokenizer
from distillclip_tpu_torch.data.transforms import eval_image_transform, train_image_transform
from distillclip_tpu_torch.parallel import rank as process_rank
from distillclip_tpu_torch.parallel import world_size


def iter_tar_samples(tar_path: str) -> Iterator[Tuple[bytes, bytes]]:
    """(jpg bytes, txt bytes) of each sample key that has both, in order."""
    with tarfile.open(tar_path, "r|*") as tf:
        current_key, parts = None, {}
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name)
            key, ext = name.stem, name.suffix.lower().lstrip(".")
            if key != current_key:
                if current_key is not None and "jpg" in parts and "txt" in parts:
                    yield parts["jpg"], parts["txt"]
                current_key, parts = key, {}
            data = tf.extractfile(member).read()
            if ext in ("jpg", "jpeg", "png"):
                parts["jpg"] = data
            elif ext in ("txt", "text", "caption"):
                parts["txt"] = data
        if current_key is not None and "jpg" in parts and "txt" in parts:
            yield parts["jpg"], parts["txt"]


class TextImageDataModule:
    """Tar-shard data module with the reference's split and shuffle."""

    def __init__(self, image_path: str, batch_size: int = 64, workers: int = 4,
                 image_size: int = 224, context_length: int = 77,
                 bpe_path: Optional[str] = None, val_fraction: float = 0.1,
                 shuffle_buffer: int = 5000, seed: int = 2022,
                 dataset_size: Optional[int] = None):
        # the reference hardcodes its dataset sizes; here the size is a knob
        # that fixes the schedule's length
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.image_size = image_size
        self.context_length = context_length
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        urls = sorted(str(p) for p in Path(image_path).glob("*.tar"))
        if not urls:
            raise ValueError(f"no .tar shards under {image_path}")
        random.Random(seed).shuffle(urls)
        n_val = max(1, int(len(urls) * val_fraction))
        self.val_url = urls[:n_val]
        self.train_url = urls[n_val:]
        self.tokenizer = build_tokenizer(bpe_path, context_length=context_length)
        print(f"len(train) == {len(self.train_url)}, len(val) == {len(self.val_url)}")

    def prepare_data(self, device=None):
        pass

    def setup(self, stage=None):
        pass

    def steps_per_epoch(self) -> Optional[int]:
        """The schedule's length in batches (the partial batch dropped)."""
        if self.dataset_size is None:
            return None
        return max(1, self.dataset_size // self.batch_size)

    def _iter_batches(self, urls: List[str], is_train: bool, epoch: int = 0):
        from PIL import Image

        transform = (train_image_transform(self.image_size, rand_augment_ops=4) if is_train
                     else eval_image_transform(self.image_size))
        rng = random.Random(self.seed + epoch)
        urls = list(urls)
        if is_train:
            rng.shuffle(urls)

        def samples():
            buf = []
            for url in urls:
                for jpg, txt in iter_tar_samples(url):
                    if is_train and self.shuffle_buffer > 1:
                        buf.append((jpg, txt))
                        if len(buf) >= self.shuffle_buffer:
                            yield buf.pop(rng.randrange(len(buf)))
                    else:
                        yield jpg, txt
            while buf:
                yield buf.pop(rng.randrange(len(buf)))

        # every process reads the same stream and decodes its own batch of
        # each run of world_size batches; the batch is yielded when the run
        # is complete, so every process yields the same number of batches
        group = world_size() * self.batch_size
        rank = process_rank()
        images, texts = [], []
        for i, (jpg, txt) in enumerate(samples()):
            if (i % group) // self.batch_size == rank:
                images.append(transform(Image.open(io.BytesIO(jpg))))
                texts.append(txt.decode("utf-8", errors="replace").strip())
            if (i + 1) % group == 0:
                yield {"images": np.stack(images),
                       "tokens": self.tokenizer.tokenize(texts,
                                                         context_length=self.context_length)}
                images, texts = [], []

    def train_dataloader(self, epoch: int = 0):
        return self._iter_batches(self.train_url, is_train=True, epoch=epoch)

    def val_dataloader(self, epoch: int = 0):
        return self._iter_batches(self.val_url, is_train=False)
