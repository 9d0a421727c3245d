"""The trainer's parts against the JAX package's: retrieval metrics, the
epoch-end retrieval, early stopping, checkpoint retention and the config
system (``instantiate``, ``build_trainer``), on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu import config as jax_config
from distillclip_tpu.training import checkpoints as jax_checkpoints
from distillclip_tpu.training import metrics as jax_metrics
from distillclip_tpu.training import trainer as jax_trainer
from distillclip_tpu_torch import config
from distillclip_tpu_torch.data.datamodule import MainDataModule
from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
from distillclip_tpu_torch.training import DistillTask, DualDistillTask
from distillclip_tpu_torch.training import metrics
from distillclip_tpu_torch.training import trainer
from distillclip_tpu_torch.training.checkpoints import CheckpointManager

# -- metrics ---------------------------------------------------------------------


def _logits(seed, n=12, ties=False):
    rng = np.random.default_rng(seed)
    if ties:   # few distinct values: many exact ties with the diagonal
        return rng.integers(0, 3, size=(n, n)).astype(np.float32)
    return rng.normal(size=(n, n)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_topk_and_diag_scores_match_jax(ties):
    x = _logits(1, ties=ties)
    ours = metrics.topk_accuracy(torch.from_numpy(x))
    ref = jax_metrics.topk_accuracy(jnp.asarray(x))
    assert list(ours) == list(ref) == list(metrics.DEFAULT_KS)
    for k in ours:
        assert float(ours[k]) == float(ref[k])
    for a, b in zip(metrics.diag_scores(torch.from_numpy(x)), jax_metrics.diag_scores(jnp.asarray(x))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_norm_and_logits_match_jax():
    rng = np.random.default_rng(2)
    enc, stu, tea = (rng.normal(size=(9, 5)).astype(np.float32) for _ in range(3))
    ours = metrics.norm_and_logits(*(torch.from_numpy(a) for a in (enc, stu, tea)))
    ref = jax_metrics.norm_and_logits(*(jnp.asarray(a) for a in (enc, stu, tea)))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _reps_list(dual, seed=3, batches=3, n=7, d=6):
    rng = np.random.default_rng(seed)
    keys = (("stu_image_outs", "stu_text_outs", "tea_image_outs", "tea_text_outs") if dual
            else ("student", "teacher", "contrary_rep"))
    return [{k: rng.normal(size=(n, d)).astype(np.float32) for k in keys}
            for _ in range(batches)]


@pytest.mark.parametrize("dual", [True, False])
def test_epoch_end_retrieval_matches_jax(dual):
    reps = _reps_list(dual)
    out, tea, logits = trainer._epoch_end_retrieval(reps, dual)
    ref_out, ref_tea, ref_logits = jax_trainer._epoch_end_retrieval(reps, dual)
    assert list(out) == list(ref_out) and list(tea) == list(ref_tea)
    for got, want in ((out, ref_out), (tea, ref_tea)):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=1e-6)


@pytest.mark.parametrize("mode,values", [
    ("min", [3.0, 2.0, 2.5, 2.4, 1.0, 1.5, 1.6, 1.7]),
    ("max", [0.1, 0.3, 0.2, 0.3, 0.25, 0.5, 0.4, 0.45]),
])
def test_early_stopper_matches_jax(mode, values):
    ours = trainer.EarlyStopper(patience=2, mode=mode)
    ref = jax_trainer.EarlyStopper(patience=2, mode=mode)
    for v in values:
        assert ours.update(v) == ref.update(v)
        assert (ours.best, ours.count) == (ref.best, ref.count)


# -- checkpoint retention ------------------------------------------------------------

CKPT_SEQUENCES = {
    "plain": [(0.10, 1.0), (0.20, 0.9), (0.15, 0.95), (0.30, 1.2), (0.05, 0.5), (0.25, 0.7)],
    "missing": [(None, 1.0), (0.20, None), (None, None), (0.40, 0.8), (0.10, 0.3),
                (0.30, 0.9)],
}


@pytest.mark.parametrize("seq", sorted(CKPT_SEQUENCES))
def test_checkpoint_manager_keeps_what_jax_keeps(tmp_path, monkeypatch, seq):
    # the JAX manager's Orbax writes are skipped; its bookkeeping is compared
    monkeypatch.setattr(jax_checkpoints, "save_pytree", lambda path, tree: None)
    ours = CheckpointManager(str(tmp_path / "port"))
    ref = jax_checkpoints.CheckpointManager(str(tmp_path / "jax"))
    for epoch, (acc, loss) in enumerate(CKPT_SEQUENCES[seq]):
        tree = {"w": torch.full((2,), float(epoch)), "epoch": epoch}
        m = {"stu_acc_top1": acc, "loss": loss}
        assert os.path.basename(ours.save_epoch(epoch, tree, m)) == \
            os.path.basename(ref.save_epoch(epoch, tree, m))
    with open(tmp_path / "port" / "index.json") as f, open(tmp_path / "jax" / "index.json") as g:
        index, ref_index = json.load(f), json.load(g)
    assert index == ref_index
    kept = {e["name"] for e in index["entries"]}
    assert set(os.listdir(tmp_path / "port")) == kept | {"index.json", "last"}
    last = torch.load(str(tmp_path / "port" / "last"), weights_only=True)
    assert float(last["w"][0]) == len(CKPT_SEQUENCES[seq]) - 1
    for metric in ("acc", "loss"):
        assert (os.path.basename(ours.best(metric) or "")
                == os.path.basename(ref.best(metric) or ""))
    # a fresh manager reads the index back
    assert CheckpointManager(str(tmp_path / "port"))._index == index


# -- the config system --------------------------------------------------------------

CONFIGS = [["configs/smoke_text.yaml"], ["configs/smoke_dual.yaml"],
           ["configs/bench_fit_lclip.yaml"],
           ["configs/bench_fit_lclip.yaml", "configs/bench_fit_prestaged.yaml"],
           ["configs/image_real.yaml"], ["configs/final/image.yaml"],
           ["configs/final/image.yaml", "configs/final/image_allcached.yaml"],
           ["configs/final/image.yaml", "configs/eva02_image.yaml"],
           ["configs/final/text.yaml"], ["configs/final/l_clip.yaml"],
           ["configs/final/l_clip.yaml", "configs/final/l_clip_allcached.yaml"]]
_IDS = ["+".join(os.path.basename(p)[:-5] for p in c) for c in CONFIGS]


def test_every_config_is_covered():
    covered = {p for c in CONFIGS for p in c}
    on_disk = {f"configs/{p}" for p in os.listdir("configs") if p.endswith(".yaml")}
    on_disk |= {f"configs/final/{p}" for p in os.listdir("configs/final")}
    assert on_disk <= covered


@pytest.mark.parametrize("paths", CONFIGS, ids=_IDS)
def test_build_trainer_matches_jax(paths):
    cfg = config.load_configs(paths)
    assert cfg == jax_config.load_configs(paths)
    ours = dataclasses.asdict(config.build_trainer(cfg.get("trainer"), seed=7, device="cpu"))
    ref = dataclasses.asdict(jax_config.build_trainer(cfg.get("trainer"), seed=7))
    assert ours.pop("device") == "cpu"
    assert ours == ref


class _NoTeacher:
    selected_layers = ()


@pytest.mark.parametrize("paths", CONFIGS, ids=_IDS)
def test_instantiate_model_matches_jax(paths, monkeypatch):
    """The task's fields and its students' constructor fields, as the JAX
    package builds them (its teacher load stubbed: no CLIP weights here).
    The port builds on the meta device: nothing is allocated."""
    from distillclip_tpu.training import distill as jax_distill
    from distillclip_tpu.training import dual as jax_dual

    for mod in (jax_distill, jax_dual):
        monkeypatch.setattr(mod, "teacher_load", lambda *a, **k: (_NoTeacher(), None))
    cfg = config.load_configs(paths)
    ref = jax_config.instantiate(cfg["model"])
    with torch.device("meta"):
        ours = config.instantiate(cfg["model"])
    assert type(ours).__name__ == type(ref).__name__
    assert isinstance(ours, (DistillTask, DualDistillTask))
    towers = ("image_student", "text_student") if isinstance(ours, DualDistillTask) else ("student",)
    for f in dataclasses.fields(ours):
        if f.name not in towers:
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for name in towers:
        stu, jstu = getattr(ours, name), getattr(ref, name)
        assert type(stu).__name__ == type(jstu).__name__
        assert isinstance(stu, (RepeatVisionTransformer, RepeatTextTransformer))
        assert stu.embed_dim == jstu.embed_dim
        assert len(stu.blocks) * jstu.repeated_times == jstu.depth
        assert stu.blocks[0].attn.num_heads == jstu.num_heads
        assert stu.head.kernel.shape == (jstu.embed_dim, jstu.out_dim)


DATASET_CLASSES = {"ms_coco": "COCODataset", "combine_image_dataset": "CombineImageDataset",
                   "combine_text_dataset": "CombineTextDataset"}


@pytest.mark.parametrize("paths", [c for c in CONFIGS if "smoke" not in c[0]
                                   and "bench" not in c[0]], ids=lambda c: c[-1])
def test_each_config_s_data_section_instantiates_its_dataset_class(paths):
    cfg = config.load_configs(paths)
    dm = config.instantiate(cfg["data"])
    assert isinstance(dm, MainDataModule)
    assert dm.data_module.__name__ == DATASET_CLASSES[dm.dataset]
    assert dm.data_module.__module__ == f"distillclip_tpu_torch.data.component.{dm.dataset}"
    assert callable(dm.prepare_function)


def test_synthetic_data_sections_build():
    for paths in (["configs/smoke_dual.yaml"],
                  ["configs/bench_fit_lclip.yaml", "configs/bench_fit_prestaged.yaml"]):
        dm = config.instantiate(config.load_configs(paths)["data"])
        assert isinstance(dm, MainDataModule) and dm.dataset == "synthetic"


def test_irpe_raises_by_item_and_webdataset_instantiates(tmp_path):
    from distillclip_tpu_torch.data.component.text_image_webdataset import TextImageDataModule

    from distillclip_tpu_torch.models import RpeConfig

    # a config's rpe_config dict becomes an RpeConfig, whose checks are JAX's
    node = {"class_path": "model.component.weight_share_model.RepeatVisionTransformer",
            "init_args": {"depth": 1, "embed_dim": 32, "num_heads": 4,
                          "rpe_config": {"method": "product", "mode": "ctx"}}}
    with pytest.raises(ValueError, match="mode must be one of"):
        config.instantiate(node)
    node["init_args"]["rpe_config"]["mode"] = "contextual"
    tower = config.instantiate(node)
    assert isinstance(tower, RepeatVisionTransformer)
    assert tower.blocks[0].attn.rpe == RpeConfig(method="product", mode="contextual")
    assert tower.blocks[0].attn.rpe_k_weight.shape == (1, 1, 1, 8, 50)
    (tmp_path / "shard0.tar").write_bytes(b"")
    dm = config.instantiate({"class_path": "data.text_image_datamodule.TextImageDataModule",
                             "init_args": {"image_path": str(tmp_path), "batch_size": 4}})
    assert isinstance(dm, TextImageDataModule) and dm.val_url and not dm.train_url


def test_instantiate_refuses_unknown_arguments_like_jax():
    node = {"class_path": "model.component.weight_share_model.RepeatTextTransformer",
            "init_args": {"depth": 1, "bogus_arg": 5}}
    with pytest.raises(TypeError, match="bogus_arg"):
        config.instantiate(node)
    node["init_args"] = {"depth": 1, "embed_dim": 32, "num_heads": 4, "qk_scale": None,
                         "hybrid_backbone": None}
    assert isinstance(config.instantiate(node), RepeatTextTransformer)
