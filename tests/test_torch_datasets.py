"""The port's dataset components against the JAX package's, on a fabricated
corpus of a few dozen JPEGs and the fabricated tiny teacher, on the CPU.

Each ``prepare`` builds its caches with both packages (the port's teacher on
the CPU in fp32; the JAX towers on their XLA path, ``DISTILLCLIP_FLASH=0``):
cache keys, paths, captions and token arrays equal, teacher representations
within the fp32 tolerance of ``tests/test_torch_teacher.py`` (1e-5).  Each
dataset's items equal the JAX items (the eval transform, and RandAugment
from the same seeded ``random.Random``).  Every refusal of the JAX package
is the port's, and the port also refuses a train-representation cache
built from fewer corpora than ``image_use`` asks for, which the JAX package
passes.  ``TextImageDataModule`` runs on ``tests/test_webdataset.py``'s shards.
"""

import importlib
import random
import shutil

import numpy as np
import pytest
import torch

from distillclip_tpu.tools import fabricate_images as jax_fab
from distillclip_tpu_torch.data import transforms as tf
from distillclip_tpu_torch.tools import fabricate_images as fab
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

SIZE = 32
COMPONENTS = ("ms_coco", "combine_image_dataset", "combine_text_dataset")


def _mods(name):
    return (importlib.import_module(f"distillclip_tpu_torch.data.component.{name}"),
            importlib.import_module(f"distillclip_tpu.data.component.{name}"))


def _corpus(root):
    fab.fabricate(str(root), n_train=12, n_val=6, size=SIZE, seed=0)
    fab.fabricate_coco_train(str(root), n_train=8, size=SIZE, seed=1)
    (root / "cc").mkdir()
    (root / "cc" / "train_cc3m.tsv").write_text(
        "".join(f"{fab.WORDS[i % len(fab.WORDS)]} cc {i}\thttp://x/{i}.jpg\n" for i in range(10)))


def _args(root, cache, teacher, **over):
    return {"raw_data_dir": str(root), "cache_dir": str(cache), "teacher_name": teacher,
            "root_path": str(root / "mscoco"), "annotation_path": str(root / "mscoco" / "annotations"),
            "combine_dataset_path": str(root / "combined"), "image_use": ["coco", "imagenet"],
            "cache_caption_reps": True, "cache_image_reps": True,
            "cache_train_image_reps": True, "cache_train_reps": True,
            "text_use": ["cc", "coco"], **over}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(corpus root, port cache dir, JAX cache dir, teacher path), each
    ``prepare`` run by both packages."""
    import os

    root = tmp_path_factory.mktemp("corpus")
    _corpus(root)
    teacher = str(root / "tiny_clip.pt")
    torch.save(make_clip_state_dict(), teacher)
    old = os.environ.get("DISTILLCLIP_FLASH")
    os.environ["DISTILLCLIP_FLASH"] = "0"
    try:
        for name in COMPONENTS:
            ours, ref = _mods(name)
            ours.prepare(_args(root, root / "cache_port", teacher, device="cpu"))
            ref.prepare(_args(root, root / "cache_jax", teacher))
    finally:
        if old is None:
            os.environ.pop("DISTILLCLIP_FLASH")
        else:
            os.environ["DISTILLCLIP_FLASH"] = old
    return root, root / "cache_port", root / "cache_jax", teacher


def test_fabricated_corpus_is_jax_s(tmp_path):
    fab.fabricate(str(tmp_path / "a"), n_train=4, n_val=3, size=SIZE, seed=5)
    fab.fabricate_coco_train(str(tmp_path / "a"), n_train=3, size=SIZE, seed=6)
    jax_fab.fabricate(str(tmp_path / "b"), n_train=4, n_val=3, size=SIZE, seed=5)
    jax_fab.fabricate_coco_train(str(tmp_path / "b"), n_train=3, size=SIZE, seed=6)
    a = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*") if p.is_file())
    b = sorted(p.relative_to(tmp_path / "b") for p in (tmp_path / "b").rglob("*") if p.is_file())
    assert a == b and len(a) == 4 + 3 + 3 + 2
    for p in a:
        assert (tmp_path / "a" / p).read_bytes() == (tmp_path / "b" / p).read_bytes()


@pytest.mark.parametrize("cache_file", [
    "coco-caption-reps-train2017-{t}.npz", "coco-image-reps-train2017-{t}.npz",
    "image-cache-val-{t}.npz", "image-cache-train-reps-{t}.npz",
    "text-cache-train-{t}.npz", "text-cache-train-reps-{t}.npz", "text-cache-val-{t}.npz"])
def test_prepare_caches_equal_jax(corpus, cache_file):
    root, port, jax_dir, teacher = corpus
    name = cache_file.format(t=teacher.replace("/", "-"))
    with np.load(port / name) as a, np.load(jax_dir / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prepare_without_a_device_is_refused(corpus, tmp_path):
    root, _, _, teacher = corpus
    ours, _ = _mods("ms_coco")
    with pytest.raises(ValueError, match="the run's device"):
        ours.prepare(_args(root, tmp_path, teacher))


def test_datamodule_prepare_encodes_on_the_device_it_is_given(corpus, tmp_path):
    from distillclip_tpu_torch.data.datamodule import MainDataModule

    root, port, _, teacher = corpus
    para = {k: v for k, v in _args(root, tmp_path, teacher).items()
            if k in ("raw_data_dir", "cache_dir", "teacher_name", "text_use", "cache_train_reps")}
    dm = MainDataModule(dataset_para=para, dataset="combine_text_dataset",
                        dataset_name="CombineTextDataset", prepare_para={"overwrite": False})
    with pytest.raises(ValueError, match="the run's device"):
        dm.prepare_data()
    dm.prepare_data("cpu")
    name = f"text-cache-train-reps-{teacher.replace('/', '-')}.npz"
    np.testing.assert_array_equal(np.load(tmp_path / name)["train_rep"],
                                  np.load(port / name)["train_rep"])


def _seed_transforms(ds, seed, augment):
    """The dataset's RandAugment draws from ``random.Random(seed)``."""
    if getattr(ds, "_rand_augment", None) is not None:
        ds._rand_augment.rng = random.Random(seed)
    if ds.train and augment:
        mod = tf if type(ds).__module__.startswith("distillclip_tpu_torch") else \
            importlib.import_module("distillclip_tpu.data.transforms")
        ds.transform = mod.train_image_transform(SIZE, 4, rng=random.Random(seed + 1))


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


DATASETS = {
    "coco train": ("ms_coco", "COCODataset", dict(train=True)),
    "coco train cached text": ("ms_coco", "COCODataset",
                               dict(train=True, cached_text_teacher_reps=True)),
    "coco train all cached": ("ms_coco", "COCODataset",
                              dict(train=True, cached_text_teacher_reps=True,
                                   cached_image_teacher_reps=True, augment_train=False)),
    "coco train text only": ("ms_coco", "COCODataset", dict(train=True, need_type="text")),
    "coco train image only": ("ms_coco", "COCODataset", dict(train=True, need_type="image")),
    "coco val": ("ms_coco", "COCODataset", dict(train=False)),
    "image train": ("combine_image_dataset", "CombineImageDataset", dict(train=True)),
    "image train uint8": ("combine_image_dataset", "CombineImageDataset",
                          dict(train=True, device_normalize=True)),
    "image train PIL": ("combine_image_dataset", "CombineImageDataset",
                        dict(train=True, use_native_decode=False)),
    "image train PIL uint8": ("combine_image_dataset", "CombineImageDataset",
                              dict(train=True, use_native_decode=False, device_normalize=True)),
    "image train cached": ("combine_image_dataset", "CombineImageDataset",
                           dict(train=True, cached_teacher_reps=True, augment_train=False)),
    "image val": ("combine_image_dataset", "CombineImageDataset", dict(train=False)),
    "text train": ("combine_text_dataset", "CombineTextDataset", dict(train=True)),
    "text train cached": ("combine_text_dataset", "CombineTextDataset",
                          dict(train=True, cached_teacher_reps=True)),
    "text val": ("combine_text_dataset", "CombineTextDataset", dict(train=False)),
}


def _dataset_kwargs(root, cache, teacher, cls_name, **kw):
    if cls_name == "COCODataset":
        base = {"root_path": str(root / "mscoco"),
                "annotation_path": str(root / "mscoco" / "annotations"), "image_size": SIZE}
    elif cls_name == "CombineImageDataset":
        base = {"combine_dataset_path": str(root / "combined"), "image_size": SIZE}
    else:
        base = {}
    return {**base, "cache_dir": str(cache), "teacher_name": teacher, **kw}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_items_equal_jax(corpus, case):
    """Both read the port's caches, so the items compare exactly."""
    root, port, _, teacher = corpus
    name, cls_name, kw = DATASETS[case]
    ours_mod, ref_mod = _mods(name)
    args = _dataset_kwargs(root, port, teacher, cls_name, **kw)
    ours, ref = getattr(ours_mod, cls_name)(**args), getattr(ref_mod, cls_name)(**args)
    assert len(ours) == len(ref) > 0
    for i in range(len(ours)):
        _seed_transforms(ours, i, kw.get("augment_train", True))
        _seed_transforms(ref, i, kw.get("augment_train", True))
        _assert_items_equal(ours[i], ref[i])


REFUSALS = {
    "coco need_type": ("ms_coco", "COCODataset", dict(need_type="both"), ValueError,
                       "need_type"),
    "coco image reps with augmentation": ("ms_coco", "COCODataset",
                                          dict(cached_image_teacher_reps=True), ValueError,
                                          "augment_train: false"),
    "coco caption cache missing": ("ms_coco", "COCODataset",
                                   dict(cached_text_teacher_reps=True, teacher_name="other"),
                                   FileNotFoundError, "cache_caption_reps=true"),
    "coco image cache missing": ("ms_coco", "COCODataset",
                                 dict(cached_image_teacher_reps=True, augment_train=False,
                                      teacher_name="other"), FileNotFoundError,
                                 "cache_image_reps=true"),
    "image unknown corpus": ("combine_image_dataset", "CombineImageDataset",
                             dict(image_use=["laion"]), AssertionError, "not exists"),
    "image reps with augmentation": ("combine_image_dataset", "CombineImageDataset",
                                     dict(cached_teacher_reps=True), ValueError,
                                     "augment_train: false"),
    "image cache missing": ("combine_image_dataset", "CombineImageDataset",
                            dict(cached_teacher_reps=True, augment_train=False,
                                 teacher_name="other"), FileNotFoundError,
                            "cache_train_image_reps=true"),
    "image cache of another corpus": ("combine_image_dataset", "CombineImageDataset",
                                      dict(cached_teacher_reps=True, augment_train=False,
                                           image_use=["imagenet"]), ValueError,
                                      "different image_use"),
    "text cache missing": ("combine_text_dataset", "CombineTextDataset",
                           dict(cached_teacher_reps=True, teacher_name="other"),
                           FileNotFoundError, "cache_train_reps=true"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_are_jax_s(corpus, case, tmp_path):
    root, port, _, teacher = corpus
    name, cls_name, kw, exc, match = REFUSALS[case]
    if kw.get("teacher_name") == "other" or name == "combine_text_dataset":
        # a cache directory with the token cache but none of the others
        for f in port.glob("text-cache-train-*.npz"):
            if "reps" not in f.name:
                shutil.copy(f, tmp_path / f.name.replace(teacher.replace("/", "-"), "other"))
        port = tmp_path
    for mod in _mods(name):
        with pytest.raises(exc, match=match):
            getattr(mod, cls_name)(**_dataset_kwargs(root, port, teacher, cls_name,
                                                     **{"teacher_name": teacher, **kw}))


@pytest.mark.parametrize("name,cls_name,cache,key", [
    ("ms_coco", "COCODataset", "coco-caption-reps-train2017-{t}.npz", "caption_rep"),
    ("ms_coco", "COCODataset", "coco-image-reps-train2017-{t}.npz", "image_rep"),
    ("combine_text_dataset", "CombineTextDataset", "text-cache-train-reps-{t}.npz",
     "train_rep")])
def test_a_cache_of_other_rows_is_refused_like_jax(corpus, tmp_path, name, cls_name, cache,
                                                  key):
    root, port, _, teacher = corpus
    for f in port.iterdir():
        shutil.copy(f, tmp_path / f.name)
    path = tmp_path / cache.format(t=teacher.replace("/", "-"))
    np.savez(path, **{key: np.load(path)[key][:-1]})
    kw = {"cached_text_teacher_reps": True} if key == "caption_rep" else \
        {"cached_image_teacher_reps": True, "augment_train": False} if key == "image_rep" else \
        {"cached_teacher_reps": True}
    for mod in _mods(name):
        with pytest.raises(ValueError, match="re-run prepare with overwrite=true"):
            getattr(mod, cls_name)(**_dataset_kwargs(root, tmp_path, teacher, cls_name,
                                                     train=True, **kw))


def test_a_cache_narrower_than_image_use_is_refused_where_jax_passes(corpus, tmp_path):
    """A train-representation cache built from coco alone, read under
    image_use [coco, imagenet]: the JAX package serves it silently (ADVICE
    r5), the port refuses it."""
    root, port, _, teacher = corpus
    ours_mod, ref_mod = _mods("combine_image_dataset")
    name = f"image-cache-train-reps-{teacher.replace('/', '-')}.npz"
    with np.load(port / name) as data:
        keep = [i for i, p in enumerate(data["paths"]) if p.split("/")[-1].startswith("0")]
        np.savez(tmp_path / name, paths=data["paths"][keep], train_rep=data["train_rep"][keep])
    args = _dataset_kwargs(root, tmp_path, teacher, "CombineImageDataset",
                           cached_teacher_reps=True, augment_train=False,
                           image_use=["coco", "imagenet"])
    assert len(ref_mod.CombineImageDataset(**args)) == len(keep)
    with pytest.raises(ValueError, match=r"holds no image of \['imagenet'\]"):
        ours_mod.CombineImageDataset(**args)


# -- the webdataset shards ----------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from test_webdataset import _make_shard

    root = tmp_path_factory.mktemp("wds")
    for s in range(3):
        _make_shard(str(root / f"shard{s}.tar"), n=10, start=s * 10)
    return str(root)


def test_tar_samples_equal_jax(shards):
    from distillclip_tpu.data.component import text_image_webdataset as ref
    from distillclip_tpu_torch.data.component import text_image_webdataset as ours

    for s in range(3):
        assert list(ours.iter_tar_samples(f"{shards}/shard{s}.tar")) == \
            list(ref.iter_tar_samples(f"{shards}/shard{s}.tar"))


def test_text_image_datamodule_batches_equal_jax(shards, monkeypatch):
    from distillclip_tpu.data import transforms as jax_tf
    from distillclip_tpu.data.component import text_image_webdataset as ref
    from distillclip_tpu_torch.data.component import text_image_webdataset as ours

    for mod, t in ((ours, tf), (ref, jax_tf)):
        monkeypatch.setattr(mod, "train_image_transform",
                            lambda size, rand_augment_ops, t=t: t.train_image_transform(
                                size, rand_augment_ops, rng=random.Random(3)))
    a = ours.TextImageDataModule(shards, batch_size=4, image_size=32, context_length=16)
    b = ref.TextImageDataModule(shards, batch_size=4, image_size=32, context_length=16)
    assert (a.train_url, a.val_url, a.steps_per_epoch()) == (b.train_url, b.val_url,
                                                             b.steps_per_epoch())
    for got, want in ((list(a.train_dataloader(epoch=1)), list(b.train_dataloader(epoch=1))),
                      (list(a.val_dataloader()), list(b.val_dataloader()))):
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            _assert_items_equal(x, y)
    with pytest.raises(ValueError, match="no .tar shards"):
        ours.TextImageDataModule(shards + "/none")


def test_text_image_datamodule_shards_the_stream_by_rank(shards, monkeypatch):
    """Under two ranks each decodes every other batch of the stream, and both
    yield the same number of batches."""
    from distillclip_tpu_torch.data.component import text_image_webdataset as ours

    whole = list(ours.TextImageDataModule(shards, batch_size=4, image_size=32,
                                          context_length=16).val_dataloader())
    parts = []
    for r in range(2):
        monkeypatch.setattr(ours, "world_size", lambda: 2)
        monkeypatch.setattr(ours, "process_rank", lambda r=r: r)
        parts.append(list(ours.TextImageDataModule(shards, batch_size=2, image_size=32,
                                                   context_length=16).val_dataloader()))
    assert len(parts[0]) == len(parts[1]) == len(whole)
    for i, w in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][i]["tokens"], parts[1][i]["tokens"]]), w["tokens"])
