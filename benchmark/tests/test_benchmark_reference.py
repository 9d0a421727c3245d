"""The plain reference against the program's plain CPU path at a tiny size,
in float32: the student towers, the CLIP teacher from the benchmark's
checkpoint file, the two losses and the three AdamW steps, each through a
whole run of the harness, and the towers one by one."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import install, run_cell, tiny_config, tiny_traffic
from benchmark import generator
from benchmark.reference import towers as RT
from benchmark.reference.numerics import Precision

FP32 = Precision("fp32")


@pytest.mark.parametrize("cell", ["lclip_b32.train_textcached", "distill_l14.train_stage1",
                                  "lclip_b32.score_stream"])
def test_fp32_program_equals_reference(cell, monkeypatch, tmp_path):
    install(monkeypatch, tmp_path, dtype="float32")
    rc, line = run_cell(cell)
    assert rc == 0 and line["correct"], line
    assert all(c["value"] < 1e-5 for c in line["checks"].values()), line["checks"]


def test_towers_one_by_one(monkeypatch, tmp_path):
    install(monkeypatch, tmp_path, dtype="float32")
    from benchmark import common
    from benchmark.weights import clip_checkpoint, load_checkpoint

    cfg, mix = tiny_config("lclip_b32", "float32"), tiny_traffic("train_textcached")
    b = common.builder(cfg)
    program = b.TrainProgram(cfg, mix, "cpu")
    params = program.masters(5)
    tokens, images, _ = generator.pool(mix, b.input_shapes(cfg), 5, "cpu")[0]
    out, _ = program.task._student_forward(params, tokens, images, True, None)
    ref_img = RT.student_image(params, "student.image_tower.", images, cfg["image_student"], FP32)
    ref_txt = RT.student_text(params, "student.text_tower.", tokens, cfg["text_student"], FP32)
    torch.testing.assert_close(out.visual_output.last_representation, ref_img)
    torch.testing.assert_close(out.text_output.last_representation, ref_txt)
    sd = load_checkpoint(clip_checkpoint(cfg["teacher"], "cpu"), "cpu")
    tea_img = program.task.make_teacher_image_encode("cpu")(images)
    tea_txt = program.task.make_teacher_text_encode("cpu")(tokens)
    torch.testing.assert_close(tea_img, RT.clip_image(sd, images, FP32), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(tea_txt, RT.clip_text(sd, tokens, FP32), rtol=1e-4, atol=1e-5)


def test_fp8_operands_are_rounded():
    x = torch.linspace(-3, 3, 1001)
    q = Precision("fp8").op(x)
    assert 0 < float((q - x).abs().max()) < 0.2 and torch.equal(Precision("fp32").op(x), x)
