"""Host input pipeline: shuffling, batching, threaded prefetch.

Port of ``distillclip_tpu/data/loader.py`` (framework-free, so a copy): a
seeded per-epoch permutation (``default_rng(seed + epoch)``), drop-remainder
batching, worker threads that decode the items of a batch, and one producer
thread that keeps the batches in order behind a bounded prefetch queue.
Batches are trees of numpy arrays; the trainer moves them to the device
(``training.trainer.to_device``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Optional

import numpy as np


class MapDataset:
    """Protocol: __len__ + __getitem__ -> tree of numpy arrays/scalars."""

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - interface
        raise NotImplementedError


def _stack_tree(items: List[Any]):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree([it[i] for it in items]) for i in range(len(first)))
    if isinstance(first, str):
        return list(items)
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:
    """Epoch-based loader over a MapDataset.

    * ``shuffle``: per-epoch permutation from a generator seeded with
      ``seed + epoch`` (:meth:`set_epoch`).
    * ``drop_last`` defaults to ``shuffle``: every train batch has one shape.
    * ``num_threads`` workers decode the items of a batch; one producer thread
      keeps the batches in order whatever the workers' timing.
    * ``num_shards`` / ``shard_index``: each process loads its interleaved
      slice of the epoch's permutation, every shard the same number of
      batches; under data parallelism the data module sets them from the
      process group (``parallel.shard_kwargs``).
    """

    def __init__(self, dataset: MapDataset, batch_size: int, shuffle: bool = False,
                 drop_last: Optional[bool] = None, seed: int = 2022, num_threads: int = 8,
                 prefetch: int = 4, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            indices = np.arange(n)
        if self.num_shards > 1:
            usable = (n // self.num_shards) * self.num_shards
            indices = indices[:usable][self.shard_index::self.num_shards]
        return indices

    def batch_indices(self) -> List[np.ndarray]:
        """The dataset indices of each batch of the current epoch, in order."""
        indices = self._epoch_indices()
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _load(self, batch_idx: np.ndarray) -> List[Any]:
        if self.num_threads == 1 or len(batch_idx) == 1:
            return [self.dataset[int(i)] for i in batch_idx]
        items: List[Any] = [None] * len(batch_idx)

        def work(lo, hi):
            for j in range(lo, hi):
                items[j] = self.dataset[int(batch_idx[j])]

        chunk = -(-len(batch_idx) // self.num_threads)
        threads = [threading.Thread(target=work, args=(lo, min(lo + chunk, len(batch_idx))))
                   for lo in range(0, len(batch_idx), chunk)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return items

    def __iter__(self) -> Iterator[Any]:
        batches = self.batch_indices()
        if not batches:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early (the trainer's first-batch peek)
            # must not leave the producer blocked on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for batch_idx in batches:
                    if not put(_stack_tree(self._load(batch_idx))):
                        return
                put(None)
            except BaseException as e:  # surface worker errors to the consumer
                put(e)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
