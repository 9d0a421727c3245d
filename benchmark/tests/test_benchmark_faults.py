"""``correct`` comes out false when the timed path is broken underneath, and
the control (the reference with fp8 operands in the program's place) fails
each cell's limits: at a tiny size on the CPU, the look for a GPU skipped and
the rest of a run driven as on the card."""

from __future__ import annotations

import pytest

from bench_tiny import install, run_cell
from benchmark import common, compare


def test_sound_runs_are_correct(monkeypatch, tmp_path):
    install(monkeypatch, tmp_path, dtype="float32")
    for cell in ("lclip_b32.train_textcached", "lclip_b32.score_stream"):
        rc, line = run_cell(cell)
        assert rc == 0 and line["correct"] and line["failed"] == 0, line


@pytest.mark.parametrize("cell", ["lclip_b32.train_textcached", "distill_l14.train_stage1"])
def test_state_unchanged(cell, monkeypatch, tmp_path):
    from distillclip_tpu_torch.training.train_state import TrainState

    install(monkeypatch, tmp_path, dtype="float32")
    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, *a, **k: self)
    rc, line = run_cell(cell)
    assert rc == 0 and not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["lclip_b32.train_textcached", "distill_l14.train_stage1"])
def test_half_batch(cell, monkeypatch, tmp_path):
    install(monkeypatch, tmp_path, dtype="float32")
    builder = common.builder(common.config(common.workload(cell)["config"]))
    start = builder.TrainProgram.start

    def halved(self, seed):
        state, step, tx = start(self, seed)
        return state, (lambda s, *batch: step(s, *[x[:x.shape[0] // 2] for x in batch])), tx

    monkeypatch.setattr(builder.TrainProgram, "start", halved)
    rc, line = run_cell(cell)
    assert rc == 0 and not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["lclip_b32.train_textcached", "distill_l14.train_stage1"])
def test_teacher_rows_out_of_line(cell, monkeypatch, tmp_path):
    """The teacher's representations altered where they are made: each row
    handed the next picture's."""
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher

    install(monkeypatch, tmp_path, dtype="float32")
    compute = FrozenTeacher.compute

    def rolled(self, device):
        module = compute(self, device)
        image = getattr(module, "image_tower", module)
        if not getattr(image, "_rolled", False):
            image.register_forward_hook(lambda m, args, out: _roll_rows(out))
            image._rolled = True
        return module

    monkeypatch.setattr(FrozenTeacher, "compute", rolled)
    rc, line = run_cell(cell)
    check = line["checks"]["teacher_gap"]
    assert rc == 0 and not line["correct"] and check["value"] > check["limit"], line["checks"]


def _roll_rows(out):
    import dataclasses

    if hasattr(out, "last_representation"):
        return dataclasses.replace(out, last_representation=out.last_representation.roll(1, 0))
    return out.roll(1, 0)


def test_pictures_out_of_line(monkeypatch, tmp_path):
    """Each batch scored with its pictures rolled by a row."""
    from distillclip_tpu_torch.serving.lclip_score import LCLIPScorer

    install(monkeypatch, tmp_path, dtype="float32")
    stream = LCLIPScorer.score_tokens_stream

    def rolled(self, batches, depth=2):
        return stream(self, ((images.roll(1, 0), tokens) for images, tokens in batches), depth)

    monkeypatch.setattr(LCLIPScorer, "score_tokens_stream", rolled)
    rc, line = run_cell("lclip_b32.score_stream")
    assert rc == 0 and not line["correct"], line["checks"]


def test_answer_altered(monkeypatch, tmp_path):
    from distillclip_tpu_torch.serving.lclip_score import LCLIPScorer

    install(monkeypatch, tmp_path, dtype="float32")
    collect = LCLIPScorer._collect

    def altered(scores, done):
        out = collect(scores, done)
        out[0] += 0.05
        return out

    monkeypatch.setattr(LCLIPScorer, "_collect", staticmethod(altered))
    rc, line = run_cell("lclip_b32.score_stream")
    assert rc == 0 and not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["lclip_b32.train_textcached", "distill_l14.train_stage1",
                                  "lclip_b32.score_stream"])
def test_control_fails_the_limits(cell, monkeypatch, tmp_path):
    from benchmark import calibrate

    install(monkeypatch, tmp_path)
    wl = common.workload(cell)
    cfg = common.config(wl["config"])
    ctx = {"workload": wl, "cfg": cfg, "mix": common.traffic(wl["traffic"]),
           "builder": common.builder(cfg), "device": "cpu"}
    rows = calibrate.train_rows if wl["driver"] == "train_step" else calibrate.score_rows
    readings = list(rows(ctx, [11, 12, 13], {11, 12, 13}))
    controls = [r for r in readings if r["kind"].startswith("control_fp8")]
    assert len(controls) == (6 if wl["driver"] == "train_step" else 3)
    assert not any(compare.held(r, wl["limits"]) for r in controls), controls
