"""The port's single-process data path against the JAX package's: the loader,
the synthetic datasets and the data module give the same batches, bit for
bit; the device-prestaged loader reshuffles every epoch (the JAX one replays
the first epoch's order)."""

import numpy as np
import pytest
import torch

from distillclip_tpu.data import loader as jax_loader
from distillclip_tpu.data.component import synthetic as jax_synthetic
from distillclip_tpu.data.datamodule import MainDataModule as JaxDataModule
from distillclip_tpu_torch.data import loader
from distillclip_tpu_torch.data.component import synthetic
from distillclip_tpu_torch.data.datamodule import DevicePrestagedLoader, MainDataModule
from distillclip_tpu_torch.training.trainer import fit_loaders


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


class _Items:
    """A map dataset of mixed leaves: an array, a scalar and a string."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.int32), "y": float(i) / 7, "name": f"item{i}"}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, True),
                                               (False, False)])
@pytest.mark.parametrize("threads", [1, 3])
def test_loader_gives_jax_batches(shuffle, drop_last, threads):
    data = _Items(23)
    ours = loader.DataLoader(data, batch_size=5, shuffle=shuffle, drop_last=drop_last,
                             seed=11, num_threads=threads, prefetch=2)
    ref = jax_loader.DataLoader(data, batch_size=5, shuffle=shuffle, drop_last=drop_last,
                                seed=11, num_threads=threads, prefetch=2)
    assert len(ours) == len(ref)
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)


def test_loader_shards_and_early_stop_match_jax():
    data = _Items(22)
    for shard in range(3):
        ours = loader.DataLoader(data, 4, shuffle=True, seed=3, num_shards=3, shard_index=shard)
        ref = jax_loader.DataLoader(data, 4, shuffle=True, seed=3, num_shards=3,
                                    shard_index=shard)
        for a, b in zip(list(ours), list(ref)):
            _assert_tree_equal(a, b)
    # a consumer that stops after one batch leaves no producer blocked
    ours = loader.DataLoader(data, 2, shuffle=True, prefetch=1)
    first = next(iter(ours))
    _assert_tree_equal(first, next(iter(jax_loader.DataLoader(data, 2, shuffle=True,
                                                              prefetch=1))))


SYNTHETIC_CASES = [
    ("SyntheticTextDataset", dict(size=12, context_length=9, vocab_size=50, embed_dim=6)),
    ("SyntheticImageDataset", dict(size=5, image_size=8, embed_dim=4)),
    ("SyntheticPairDataset", dict(size=7, image_size=8, context_length=9, vocab_size=50)),
    ("SyntheticPairDataset", dict(size=7, image_size=8, context_length=9, vocab_size=50,
                                  uint8=True)),
    ("SyntheticPairDataset", dict(size=7, image_size=8, context_length=9, vocab_size=50,
                                  uint8=True, image_pool=3, cached_text_rep_dim=5)),
    ("SyntheticPairDataset", dict(size=7, image_size=8, context_length=9, vocab_size=50,
                                  image_pool=4)),
]


@pytest.mark.parametrize("name,kwargs", SYNTHETIC_CASES,
                         ids=[f"{n}-{'-'.join(k for k in kw if k not in ('size', 'image_size', 'context_length', 'vocab_size', 'embed_dim')) or 'plain'}"
                              for n, kw in SYNTHETIC_CASES])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_items_are_jax_items(name, kwargs, train):
    ours = getattr(synthetic, name)(train=train, seed=4, **kwargs)
    ref = getattr(jax_synthetic, name)(train=train, seed=4, **kwargs)
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        _assert_tree_equal(ours[i], ref[i])


def _module_args(**over):
    args = dict(dataset_para={"size": 20, "image_size": 8, "context_length": 9,
                              "vocab_size": 50, "uint8": True, "cached_text_rep_dim": 4,
                              "not_an_argument": 1},
                dataset="synthetic", dataset_name="SyntheticPairDataset", num_workers=2,
                train_batch_size=6, val_batch_size=4, seed=9)
    return {**args, **over}


def test_datamodule_reflection_gives_jax_loaders():
    ours, ref = MainDataModule(**_module_args()), JaxDataModule(**_module_args())
    for dm in (ours, ref):
        dm.prepare_data()
        dm.setup("fit")
    assert type(ours.trainset).__name__ == type(ref.trainset).__name__ == "SyntheticPairDataset"
    for make in ("train_dataloader", "val_dataloader"):
        a, b = getattr(ours, make)(), getattr(ref, make)()
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got, want = list(a), list(b)
            assert len(got) == len(want) > 0
            for x, y in zip(got, want):
                _assert_tree_equal(x, y)


DATASET_CLASSES = {"ms_coco": "COCODataset", "combine_image_dataset": "CombineImageDataset",
                   "combine_text_dataset": "CombineTextDataset",
                   "text_image_webdataset": "TextImageDataModule"}


@pytest.mark.parametrize("dataset", sorted(DATASET_CLASSES))
def test_each_dataset_module_builds_its_class_and_prepare(dataset):
    """The reflection finds each corpus's class and ``prepare`` hook in the
    port's module, as the JAX package's finds its own (the webdataset module
    has no hook in either)."""
    args = {**_module_args(), "dataset": dataset, "dataset_name": DATASET_CLASSES[dataset]}
    ours, ref = MainDataModule(**args), JaxDataModule(**args)
    assert ours.data_module.__module__ == f"distillclip_tpu_torch.data.component.{dataset}"
    assert ours.data_module.__name__ == ref.data_module.__name__ == DATASET_CLASSES[dataset]
    assert (ours.prepare_function is None) == (ref.prepare_function is None)
    if ours.prepare_function is not None:
        assert ours.prepare_function.__module__ == ours.data_module.__module__


def test_invalid_dataset_class_raises_like_jax():
    with pytest.raises(ValueError, match="Invalid Dataset File Name"):
        MainDataModule(**{**_module_args(), "dataset_name": "NoSuchDataset"})


def test_world_size_above_one_needs_a_process_group(monkeypatch):
    """A launcher's WORLD_SIZE without a process group is an error, never
    every process on the whole epoch; inside one, each loader reads the
    rank's shard."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dm = MainDataModule(**_module_args())
    dm.setup("fit")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        dm.train_dataloader()
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=2)
    try:
        assert dm._shard_kwargs() == {"num_shards": 2, "shard_index": 1}
        for loader in (dm.train_dataloader(), dm.val_dataloader()):
            assert (loader.num_shards, loader.shard_index) == (2, 1)
    finally:
        dist.destroy_process_group()


def test_the_run_device_is_not_a_datamodule_argument():
    """The trainer gives the data its device (``fit_loaders``); a config that
    sets one on the datamodule is refused, not ignored."""
    from distillclip_tpu_torch.config import instantiate

    with pytest.raises(TypeError, match="unexpected config argument 'device'"):
        instantiate({"class_path": "MainDataModule",
                     "init_args": _module_args(prestage_device=True, device="cpu")})


def test_prestaged_loader_reshuffles_where_jax_replays():
    """The deliberate fix: each epoch's device batches follow that epoch's
    permutation, as the host loader's do; the JAX loader repeats epoch 0."""
    # batches of 8: the JAX loader shards them over the 8 test devices
    dm = MainDataModule(**_module_args(prestage_device=True, train_batch_size=8))
    staged, _ = fit_loaders(dm, "cpu")
    assert isinstance(staged, DevicePrestagedLoader) and len(staged) == 2
    host = MainDataModule(**_module_args(train_batch_size=8))
    host.setup("fit")
    host_loader = host.train_dataloader()
    epochs = []
    for epoch in range(3):
        staged.set_epoch(epoch)
        host_loader.set_epoch(epoch)
        got = list(staged)
        for a, b in zip(got, list(host_loader)):
            assert set(a) == set(b)
            for k in a:
                assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), b[k])
        epochs.append(np.concatenate([b["tokens"].numpy() for b in got]))
    assert not np.array_equal(epochs[0], epochs[1])
    assert not np.array_equal(epochs[1], epochs[2])

    jax_dm = JaxDataModule(**_module_args(prestage_device=True, train_batch_size=8))
    jax_dm.setup("fit")
    jax_staged = jax_dm.train_dataloader()
    replay = []
    for epoch in range(2):
        if hasattr(jax_staged, "set_epoch"):
            jax_staged.set_epoch(epoch)
        replay.append(np.concatenate([np.asarray(b["tokens"]) for b in jax_staged]))
    np.testing.assert_array_equal(replay[0], replay[1])
    np.testing.assert_array_equal(replay[0], epochs[0])
