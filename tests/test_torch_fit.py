"""The port's ``fit`` against the JAX package's, end to end on the CPU.

Both packages fit shrunken ``configs/smoke_text.yaml`` (stage 2, live teacher)
and ``configs/smoke_dual.yaml`` (stage 3, live teachers) for two epochs of a
few steps, fp32, the JAX towers on their XLA path (DISTILLCLIP_FLASH=0).  The
port starts from the state JAX's ``Trainer.fit`` makes (its ``init_state``
from ``PRNGKey(seed)`` on the first batch), converted, with fresh AdamW
moments, written as ``{"state": ..., "epoch": -1}`` and given to ``fit
--ckpt``.  Every logged loss agrees within 1e-4 relative, retrieval
accuracies within 1/N, the logged keys are the same (timings aside) and the
checkpoint manager keeps the same epochs.  The JAX side's Orbax writes are
skipped (its index is still kept).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from distillclip_tpu import cli as jax_cli
from distillclip_tpu import config as jax_config
from distillclip_tpu.training import checkpoints as jax_checkpoints
from distillclip_tpu_torch import cli, config
from distillclip_tpu_torch.convert import jax_distill_params_to_torch, jax_dual_params_to_torch
from distillclip_tpu_torch.training.checkpoints import (
    flatten,
    restore_pytree,
    save_pytree,
    state_tree,
)

SEED = 2022  # both CLIs' default
SHRINK = {
    # config -> (dataset size, batch, fabricated teacher arguments)
    "smoke_text": (48, 16, {}),
    "smoke_dual": (32, 16, {"vocab_size": 49408, "context_length": 77}),
}


def _write_config(root, name, **trainer_over):
    from distillclip_tpu.tools.fabricate_teacher import make_clip_state_dict

    size, batch, teacher = SHRINK[name]
    ckpt = root / f"{name}_teacher.pt"
    if not ckpt.exists():
        torch.save(make_clip_state_dict(**teacher), str(ckpt))
    with open(f"configs/{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["init_args"].update(teacher_name=str(ckpt), compute_dtype="float32")
    cfg["data"]["init_args"]["dataset_para"]["size"] = size
    cfg["data"]["init_args"].update(train_batch_size=batch, val_batch_size=batch)
    cfg["trainer"]["max_epochs"] = 2
    cfg["trainer"]["logger"]["init_args"]["dir"] = str(root / "result")
    cfg["trainer"].update(trainer_over)
    path = root / f"{name}-{'-'.join(f'{k}{v}' for k, v in trainer_over.items())}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path), cfg


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_initial_state(cfg):
    """The state the JAX Trainer.fit starts from, as the port's masters."""
    task = jax_config.instantiate(cfg["model"])
    dm = jax_config.instantiate(cfg["data"])
    dm.setup("fit")
    loader = dm.train_dataloader()
    sample = next(iter(loader))
    rng = jax.random.PRNGKey(SEED)
    if hasattr(task, "image_student"):
        state, _ = task.init_state(rng, jnp.asarray(sample["tokens"][:1]),
                                   jnp.asarray(sample["images"][:1]), len(loader))
        params = jax_dual_params_to_torch(jax.tree_util.tree_map(np.asarray, state.params))
    else:
        state, _ = task.init_state(rng, jnp.asarray(sample["inputs"][:1]), len(loader))
        params = jax_distill_params_to_torch(jax.tree_util.tree_map(np.asarray, state.params),
                                             task.model_type)
    return params, len(loader)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{config: (port run dir, JAX run dir, config)} after both fits."""
    root = tmp_path_factory.mktemp("fit")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DISTILLCLIP_FLASH", "0")
        mp.setattr(jax_checkpoints, "save_pytree", lambda path, tree: None)
        for name in SHRINK:
            path, cfg = _write_config(root, name)
            run = cfg["trainer"]["logger"]["init_args"]["name"]
            jax_dir = root / "jax"
            jcfg = dict(cfg, trainer=dict(cfg["trainer"], logger={"init_args": {
                "dir": str(jax_dir), "name": run}}))
            jpath = root / f"{name}-jax.yaml"
            with open(jpath, "w") as f:
                yaml.safe_dump(jcfg, f)
            assert jax_cli.main(["fit", "-c", str(jpath)]) == 0

            params, steps = _jax_initial_state(cfg)
            task = config.instantiate(cfg["model"])
            state, _ = task.init_state(0, steps, params=params, device="cpu")
            start = str(root / f"{name}-jax-init.pt")
            save_pytree(start, {"state": state_tree(state), "epoch": -1})
            assert cli.main(["fit", "-c", path, "--ckpt", start, "--device", "cpu"]) == 0
            out[name] = (str(root / "result" / run), str(jax_dir / run), cfg, start, root)
    return out


def _close(k, got, want, n_val, batch):
    if "acc" in k or "_top" in k:
        n = batch if k.startswith("val_step/") else n_val
        return abs(got - want) <= 1.0 / n + 1e-7
    if "score" in k:
        return abs(got - want) <= 1e-4 * max(abs(want), 1e-2)
    return abs(got - want) <= 1e-4 * max(abs(want), 1e-6)


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_fit_matches_jax(runs, name):
    port_dir, jax_dir, cfg, _, _ = runs[name]
    ours, ref = _records(port_dir), _records(jax_dir)
    assert len(ours) == len(ref)
    size, batch, _ = SHRINK[name]
    compared, accs, acc_equal = 0, 0, 0
    for a, b in zip(ours, ref):
        keys = lambda r: {k for k in r if not k.startswith("perf/") and k != "time"}
        assert keys(a) == keys(b)
        for k in keys(b):
            if k in ("step", "epoch", "lr"):
                assert a[k] == b[k], (k, a[k], b[k])
            else:
                assert _close(k, a[k], b[k], size, batch), (k, a[k], b[k])
                compared += 1
                if "acc" in k or "_top" in k:
                    accs, acc_equal = accs + 1, acc_equal + (a[k] == b[k])
    assert compared > 0
    # representations within 1e-4 flip a rank only at a near-tie: nearly
    # every accuracy is JAX's to the bit
    assert acc_equal >= 0.95 * accs, (acc_equal, accs)
    with open(os.path.join(port_dir, "checkpoints", "index.json")) as f, \
            open(os.path.join(jax_dir, "checkpoints", "index.json")) as g:
        kept, ref_kept = json.load(f)["entries"], json.load(g)["entries"]
    assert [e["epoch"] for e in kept] == [e["epoch"] for e in ref_kept]
    # the teacher's baseline once, at the first epoch
    tea = [r["epoch"] for r in ours if "val_tea_acc/tea_acc_top1" in r]
    assert tea == [0.0]
    with open(os.path.join(port_dir, "config.yaml")) as f:
        assert yaml.safe_load(f)["perf"] is not None


def test_two_epochs_equal_one_then_resume(runs, tmp_path):
    """One epoch, then a resume from ``last`` for the second, gives the
    two-epoch run's losses and state."""
    port_dir, _, cfg, start, root = runs["smoke_text"]
    one = dict(cfg, trainer=dict(cfg["trainer"], max_epochs=1, logger={"init_args": {
        "dir": str(tmp_path), "name": "split"}}))
    path = tmp_path / "one.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(one, f)
    assert cli.main(["fit", "-c", str(path), "--ckpt", start, "--device", "cpu"]) == 0
    last = str(tmp_path / "split" / "checkpoints" / "last")
    one["trainer"]["max_epochs"] = 2
    with open(path, "w") as f:
        yaml.safe_dump(one, f)
    assert cli.main(["fit", "-c", str(path), "--ckpt", last, "--device", "cpu"]) == 0
    split, whole = _records(str(tmp_path / "split")), _records(port_dir)
    losses = lambda rs: [(r["step"], k, v) for r in rs for k, v in r.items()
                         if k.startswith(("train_loss/", "val_loss/"))]
    assert [x[:2] for x in losses(split)] == [x[:2] for x in losses(whole)]
    for (_, k, a), (_, _, b) in zip(losses(split), losses(whole)):
        assert abs(a - b) <= 1e-6 * max(abs(b), 1.0), k
    got = flatten(restore_pytree(str(tmp_path / "split" / "checkpoints" / "last")))
    want = flatten(restore_pytree(os.path.join(port_dir, "checkpoints", "last")))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)


class _Stream:
    """A loader without ``__len__`` or ``set_epoch``: a generator's worth of
    batches per pass."""

    def __init__(self, loader):
        self._loader = loader

    def __iter__(self):
        return iter(self._loader)


def test_loader_without_len_recalibrates_the_schedule(runs, tmp_path):
    _, _, cfg, _, _ = runs["smoke_text"]
    task = config.instantiate(cfg["model"])
    dm = config.instantiate(cfg["data"])
    make = dm.train_dataloader
    dm.train_dataloader = lambda epoch=None: _Stream(make())
    trainer = config.build_trainer(dict(cfg["trainer"], logger={"init_args": {
        "dir": str(tmp_path), "name": "stream"}}), seed=SEED, device="cpu")
    trainer.fit(task, dm)
    records = _records(str(tmp_path / "stream"))
    recal = [r for r in records if "perf/steps_per_epoch_recalibrated" in r]
    assert [r["perf/steps_per_epoch_recalibrated"] for r in recal] == [3.0]
    # after recalibration the schedule advances one epoch per 3 steps
    assert task._lr_schedule(3) == task._lr_schedule(5) != task._lr_schedule(2)
    lrs = [r["lr"] for r in records if "lr" in r]
    assert len(lrs) == 6 and lrs[3:] == [task._lr_schedule(s) for s in (4, 5, 6)]


def test_unfreeze_epoch_switches_the_mask(runs, tmp_path):
    _, _, cfg, _, _ = runs["smoke_dual"]
    cfg = json.loads(json.dumps(cfg))
    # no warm-up: the first epoch's learning rate is not 0
    cfg["model"]["init_args"].update(freeze_prefix=["image_tower"], unfreeze_epoch=1,
                                     warm_steps=0)
    task = config.instantiate(cfg["model"])
    dm = config.instantiate(cfg["data"])
    trainer = config.build_trainer(dict(cfg["trainer"], max_epochs=1, logger={"init_args": {
        "dir": str(tmp_path), "name": "unfreeze"}}), seed=SEED, device="cpu")
    init, _ = task.init_state(SEED, 1, device="cpu")
    init = {k: v.clone() for k, v in init.params.items()}
    frozen = trainer.fit(task, dm)["state"].params
    image = [k for k in init if k.startswith("student.image_tower.")]
    assert image and all(torch.equal(frozen[k], init[k]) for k in image)
    assert any(not torch.equal(frozen[k], init[k]) for k in init if k not in image)
    trainer.max_epochs = 2
    last = str(tmp_path / "unfreeze" / "checkpoints" / "last")
    moved = trainer.fit(config.instantiate(cfg["model"]), dm, ckpt_path=last)["state"].params
    assert all(not torch.equal(moved[k], init[k]) for k in image)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_fit_on_a_missing_card_fails_and_never_falls_back(runs, tmp_path):
    _, _, cfg, _, _ = runs["smoke_text"]
    cfg = dict(cfg, trainer=dict(cfg["trainer"], logger={"init_args": {
        "dir": str(tmp_path), "name": "nocard"}}))
    path = tmp_path / "nocard.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fit", "-c", str(path), "--device", "cuda"])
    assert not os.path.exists(tmp_path / "nocard" / "metrics.jsonl")
