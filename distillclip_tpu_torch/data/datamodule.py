"""Reflection-driven data module.

Port of ``distillclip_tpu/data/datamodule.py``: ``dataset`` names a module
under ``distillclip_tpu_torch.data.component``, ``dataset_name`` the class in
it; constructor arguments are taken from ``dataset_para`` by the class's
signature, and a module-level ``prepare(args)`` hook runs once before setup,
on the run's device (:meth:`MainDataModule.prepare_data`; the trainer calls
it on the first rank only).

One process drives one device.  Under data parallelism each process's
loaders read its shard of every epoch (``{"num_shards": world_size(),
"shard_index": rank()}`` from ``torch.distributed``); a launcher's
``WORLD_SIZE`` > 1 without a process group is an error.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch

from distillclip_tpu_torch.data.loader import DataLoader
from distillclip_tpu_torch.parallel import shard_kwargs


def _to_device_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    return tree


def _take(tree, idx: torch.Tensor, idx_np: np.ndarray):
    if isinstance(tree, dict):
        return {k: _take(v, idx, idx_np) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx)
    return [tree[int(i)] for i in idx_np]


class DevicePrestagedLoader:
    """A DataLoader whose dataset lives on the device.

    The first pass reads every item of the dataset once (in index order) and
    uploads the stacked items to ``device``; each epoch's batches are then
    gathered on the device from that epoch's permutation (the wrapped
    loader's, so :meth:`set_epoch` reshuffles exactly as the host loader
    would).  No batch crosses from the host after the first pass.

    The JAX package's loader of the same name caches the first epoch's
    device batches and replays them in that order every epoch; the port
    reshuffles, which is what training needs (ROADMAP §3, deliberate
    differences).

    Under data parallelism every rank stages the whole dataset once and
    gathers its batches from its own shard of each epoch's permutation (the
    wrapped loader's ``batch_indices``).
    """

    def __init__(self, loader: DataLoader, device):
        self._loader = loader
        self.device = torch.device(device)
        self._items = None

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch: int):
        self._loader.set_epoch(epoch)

    def _stage(self):
        everything = DataLoader(self._loader.dataset, batch_size=len(self._loader.dataset),
                                shuffle=False, drop_last=False,
                                num_threads=self._loader.num_threads)
        self._items = _to_device_tree(next(iter(everything)), self.device)

    def __iter__(self):
        if self._items is None:
            self._stage()
        for batch_idx in self._loader.batch_indices():
            idx = torch.from_numpy(batch_idx.astype(np.int64)).to(self.device)
            yield _take(self._items, idx, batch_idx)


class MainDataModule:
    def __init__(self, dataset_para: Dict[str, Any], dataset: str, dataset_name: str,
                 prepare_para: Optional[Dict[str, Any]] = None, num_workers: int = 8,
                 train_batch_size: int = 128, val_batch_size: int = 1250, seed: int = 2022,
                 prestage_device: bool = False):
        self.prestage_device = prestage_device
        self.num_workers = num_workers
        self.dataset = dataset
        self.dataset_para = dataset_para
        self.dataset_name = dataset_name
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.seed = seed

        self.data_module = self.load_data_module()
        self.prepare_function = self.load_prepare()
        self.prepare_function_args = prepare_para
        if self.prepare_function_args:
            self.prepare_function_args.update(dataset_para)
        self.trainset = None
        self.valset = None

    # -- reflection ----------------------------------------------------------

    def _module(self):
        return importlib.import_module("distillclip_tpu_torch.data.component." + self.dataset)

    def load_prepare(self):
        return getattr(self._module(), "prepare", None)

    def load_data_module(self):
        try:
            return getattr(self._module(), self.dataset_name)
        except (ImportError, AttributeError):
            raise ValueError(f"Invalid Dataset File Name or Invalid Class Name "
                             f"data.{self.dataset}.{self.dataset_name}")

    def instancialize(self, **other_args):
        class_args = inspect.signature(self.data_module.__init__).parameters
        args = {k: self.dataset_para[k] for k in class_args if k in self.dataset_para}
        args.update(other_args)
        return self.data_module(**args)

    # -- lifecycle -------------------------------------------------------------

    def prepare_data(self, device=None) -> None:
        """Run the dataset's ``prepare`` hook.  ``device`` is the run's: a hook
        that encodes with the teacher runs there, and refuses to run without
        one."""
        if self.prepare_function and self.prepare_function_args is not None:
            args = dict(self.prepare_function_args)
            if device is not None:
                args["device"] = str(device)
            self.prepare_function(args)

    def setup(self, stage: Optional[str] = None):
        if stage in ("fit", None):
            self.trainset = self.instancialize(train=True)
            self.valset = self.instancialize(train=False)

    @staticmethod
    def _shard_kwargs() -> dict:
        """This process's shard (``parallel.shard_kwargs``)."""
        return shard_kwargs()

    def train_dataloader(self) -> DataLoader:
        """The host loader; a run with ``prestage_device`` wraps it in
        :class:`DevicePrestagedLoader` on its own device
        (``training.trainer.fit_loaders``)."""
        return DataLoader(self.trainset, batch_size=self.train_batch_size, shuffle=True,
                          drop_last=True, seed=self.seed, num_threads=self.num_workers,
                          **self._shard_kwargs())

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.valset, batch_size=self.val_batch_size, shuffle=False,
                          drop_last=True, num_threads=self.num_workers, **self._shard_kwargs())
