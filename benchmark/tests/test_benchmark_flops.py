"""The model FLOP counts against hand counts, and each kernel's least time at
the cells' shapes below the device time the kernel table of PERF.md holds
(a share of the roofline above 100% would show a miscount).  The table's
times are CUDA-graph replays of one call, whose input can sit in the 50 MB
L2 cache: K4 over 12800 rows of 768 reads 19.7 MB and took 0.0116 ms against
its 0.0117 ms from device memory, so the bound is the driver's 105%."""

from __future__ import annotations

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import common, flops
from benchmark.roofline import least_seconds

G = 1e9


def _cfg(name):
    cfg = common.config(name)
    return cfg, common.builder(cfg)


def test_teacher_and_student_forwards_by_hand():
    cfg, b = _cfg("lclip_b32")
    # ViT-B/32: 12 layers of 50 tokens, 768 wide (qkv + proj + MLP = 12·C² per
    # token), attention 4·N²·C, the patch product 49·3072·768, the projection
    per_layer = 2 * 50 * 12 * 768 ** 2 + 4 * 50 * 50 * 768
    hand = 12 * per_layer + 2 * 49 * 3072 * 768 + 2 * 768 * 512
    teacher = flops.forward_flops(b.clip_geometry(cfg["teacher"], "image", 1))[0]
    assert teacher == pytest.approx(hand, rel=1e-12) and teacher == pytest.approx(8.82 * G,
                                                                                  rel=0.01)
    image = flops.forward_flops(b.student_geometry(cfg["image_student"], "image", 1, "train"))
    text = flops.forward_flops(b.student_geometry(cfg["text_student"], "text", 1, "train"))
    assert image[0] + text[0] == pytest.approx(8.99 * G, rel=0.01)
    l14, bl14 = _cfg("distill_l14")
    big = flops.forward_flops(bl14.clip_geometry(l14["teacher"], "image", 1))[0]
    assert big == pytest.approx(161.9 * G, rel=0.01)


def test_step_counts():
    cfg, b = _cfg("lclip_b32")
    mix = common.traffic("train_textcached")
    assert b.train_pair_flops(cfg, mix) == pytest.approx(35.6 * G, rel=0.01)
    l14, bl14 = _cfg("distill_l14")
    assert bl14.train_pair_flops(l14, common.traffic("train_stage1")) == pytest.approx(
        257.5 * G, rel=0.01)
    assert b.score_pair_flops(cfg, common.traffic("score_stream")) == pytest.approx(
        8.99 * G, rel=0.01)


# (kernel, launch, device ms at B=256 from PERF.md's kernel table, NVIDIA H100
# 80GB HBM3, 700 W: the image student's shapes unless said)
MEASURED = [
    ("dense_ln", {"rows": 12800, "C": 768, "N": 2304, "bias": True, "stats": True}, 0.1218),
    ("dense_act_ln", {"rows": 12800, "C": 768, "N": 3072}, 0.1743),
    ("dense_act_ln_res", {"rows": 12800, "C": 768, "N": 3072}, 0.2203),
    ("dense_ln_bwd", {"rows": 12800, "C": 768, "N": 2304}, 0.1193),
    ("dense_ln_bwd", {"rows": 12800, "C": 768, "N": 3072}, 0.1417),
    ("transform_attention_save_p", {"B": 256, "N": 50, "H": 24, "d": 32, "causal": False},
     0.1695),
    ("transform_attention_rows_qkv", {"B": 256, "N": 50, "H": 24, "d": 32, "causal": False},
     0.1470),
    ("transform_attention_bwd", {"B": 256, "N": 50, "H": 24, "d": 32, "causal": False}, 0.4603),
    ("plain_attention_rows_qkv", {"B": 256, "N": 50, "H": 12, "d": 64, "causal": False}, 0.0400),
    ("layer_norm_rows", {"rows": 12800, "C": 768, "stats": False}, 0.0116),
    ("layer_norm_rows_bwd", {"rows": 256, "C": 768}, 0.0068),
    # the stage-1 L/14 student (32 heads of 32, 197 tokens), PR 18
    ("transform_attention_save_p", {"B": 256, "N": 197, "H": 32, "d": 32, "causal": False},
     2.6086),
    ("transform_attention_bwd", {"B": 256, "N": 197, "H": 32, "d": 32, "causal": False}, 5.6789),
]


@pytest.mark.parametrize("name,launch,ms", MEASURED)
def test_least_time_below_measured(name, launch, ms):
    kernel = next(k for k in common.kernel_files() if k.NAME == name)
    least = least_seconds(*kernel.work(launch)) * 1e3
    assert 0 < least < 1.05 * ms, (name, least, ms)


def test_plans_match_the_program_tables():
    """A text-cached step's launches as the program's smoke tables count them
    (chip_smoke.py TRAIN_STEP_LAUNCHES + IMAGE_TEACHER_LAUNCHES)."""
    from benchmark.roofline import plan

    cfg, b = _cfg("lclip_b32")
    got = {k: len(v) for k, v in plan(b.train_towers(cfg, common.traffic("train_textcached")))
           .items() if v}
    assert got == {"dense_ln": 22, "dense_act_ln": 12, "dense_act_ln_res": 10,
                   "transform_attention_save_p": 10, "transform_attention_bwd": 10,
                   "dense_ln_bwd": 20, "layer_norm_rows": 4, "layer_norm_rows_bwd": 2,
                   "plain_attention_rows_qkv": 12}
    l14, bl14 = _cfg("distill_l14")
    got = {k: len(v) for k, v in plan(bl14.train_towers(l14, common.traffic("train_stage1")))
           .items() if v}
    assert got == {"dense_ln": 30, "dense_act_ln": 24, "dense_act_ln_res": 6,
                   "transform_attention_save_p": 6, "transform_attention_bwd": 6,
                   "dense_ln_bwd": 12, "layer_norm_rows": 3, "layer_norm_rows_bwd": 1}
    got = {k: len(v) for k, v in plan(b.score_towers(cfg, common.traffic("score_stream")))
           .items() if v}
    assert got == {"dense_ln": 10, "dense_act_ln": 10, "transform_attention_rows_qkv": 10,
                   "layer_norm_rows": 2}
