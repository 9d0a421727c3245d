"""The EVA-02-CLIP cell at a tiny size on the CPU: a sound run is correct,
the fp8 control, the faults and each mechanism control of ``reference/eva.py``
fail the cell's limits, and the new kernel files plan launches for the EVA
tower alone."""

from __future__ import annotations

import pytest
import torch

import bench_tiny
from bench_tiny import run_cell
from benchmark import common, compare, weights
from benchmark.drivers import train_step
from benchmark.reference import eva as RE
from benchmark.reference.numerics import Precision
from benchmark.reference.train import train_readings
from benchmark.roofline import least_seconds

CELL = "eva02_l14.train_stage1_1024"


def tiny_eva(name: str, dtype: str = "bfloat16") -> dict:
    if name != "eva02_l14":
        return bench_tiny.tiny_config(name, dtype)
    cfg = {"name": name, **common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")}
    cfg["teacher"]["vision_cfg"].update(image_size=32, patch_size=8, width=128, layers=2)
    cfg["teacher"]["embed_dim"] = 32
    cfg["student_encoder"].update(img_size=32, patch_size=8, embed_dim=64, num_heads=4, depth=2,
                                  out_dim=32)
    cfg.update(reference_rows=3, compute_dtype=dtype)
    return cfg


def install(monkeypatch, tmp_path, dtype="float32"):
    monkeypatch.setattr(common, "config", lambda name: tiny_eva(name, dtype))
    monkeypatch.setattr(common, "traffic", bench_tiny.tiny_traffic)
    monkeypatch.setattr(weights, "CACHE_DIR", tmp_path / "cache")
    monkeypatch.setattr(common, "CACHE_DIR", tmp_path / "cache")


def _readings(monkeypatch, tmp_path):
    """(the program's first steps' readings, the reference's, ctx, shapes, pool)."""
    install(monkeypatch, tmp_path)
    from benchmark import generator

    wl = common.workload(CELL)
    cfg = common.config(wl["config"])
    b = common.builder(cfg)
    mix = common.traffic(wl["traffic"])
    ctx = {"workload": wl, "cfg": cfg, "mix": mix, "builder": b, "device": "cpu", "seed": 11}
    program = b.TrainProgram(cfg, mix, "cpu")
    pool = generator.pool(mix, b.input_shapes(cfg), 11, "cpu")[:train_step.FIRST_STEPS]
    state, step, tx = program.start(11)
    _, first = train_step.first_steps(program, state, step, tx, pool, 11)
    return first, train_step.reference(ctx, program.shapes, pool), ctx, program.shapes, pool


def test_sound_run_is_correct(monkeypatch, tmp_path):
    install(monkeypatch, tmp_path)
    rc, line = run_cell(CELL)
    assert rc == 0 and line["correct"] and line["failed"] == 0, line["checks"]


def test_controls_and_faults_fail_the_limits(monkeypatch, tmp_path):
    first, ref, ctx, shapes, pool = _readings(monkeypatch, tmp_path)
    limits = common.workload(CELL)["limits"]
    assert compare.held(compare.train_numbers(first, ref), limits)
    b, cfg, mix = ctx["builder"], ctx["cfg"], ctx["mix"]
    controls = [train_step.reference(ctx, shapes, pool, precision="fp8"),
                train_step.reference(ctx, shapes, pool, half_batch=True)]
    for variant in RE.VARIANTS:
        model = b.reference_model(cfg, mix, "cpu", variant)
        controls.append(train_readings(model, weights.student_masters(shapes, 11, "cpu"), pool,
                                       b.reference_optimizer(cfg), Precision("fp32"),
                                       cfg["reference_rows"]))
    for other in controls:
        assert not compare.held(compare.train_numbers(other, ref), limits)


def test_new_kernel_files_plan_the_eva_tower_alone():
    from benchmark.roofline import plan

    wl = common.workload(CELL)
    cfg = common.config(wl["config"])
    b = common.builder(cfg)
    got = {k: len(v) for k, v in plan(b.train_towers(cfg, common.traffic(wl["traffic"])))
           .items() if v}
    assert got["dense_ln_rope"] == got["dense_swiglu_ln"] == got["dense_ln_width"] == 24
    for cell in ("lclip_b32.train_textcached", "distill_l14.train_stage1"):
        other = common.workload(cell)
        ocfg = common.config(other["config"])
        towers = common.builder(ocfg).train_towers(ocfg, common.traffic(other["traffic"]))
        assert not any(plan(towers)[k] for k in ("dense_ln_rope", "dense_swiglu_ln",
                                                 "dense_ln_width"))
    # a picture: ~162 GFLOP of the teacher's forward, ~13 of the student's step
    teacher = b.eva_forward_flops(b.eva_geometry(cfg, 1))
    assert 160e9 < teacher < 164e9
    assert 0.85 < teacher / b.train_pair_flops(cfg, common.traffic(wl["traffic"])) < 0.95


@pytest.mark.parametrize("variant", RE.VARIANTS)
def test_each_variant_changes_the_teacher(variant, monkeypatch, tmp_path):
    install(monkeypatch, tmp_path)
    cfg = common.config("eva02_l14")
    b = common.builder(cfg)
    sd = weights.load_checkpoint(b.eva_checkpoint(cfg["teacher"], "cpu"), "cpu")
    images = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8)
    P = Precision("fp32")
    ref = RE.eva_image(sd, images, P, 2)
    other = RE.eva_image(sd, images, P, 2, variant=variant)
    assert compare.rows_gap([other], [ref]) > 1e-4


def test_eva_roofline_takes_the_modes_statistics_launches_and_not_k1s():
    """The modes' time is their products and the statistics launch they
    share; K1's product and statistics launch (the sub-LN and proj, the
    student) stay out, and a program whose counters miss the plan reads
    nothing."""
    reader = common.load_module(common.BENCH_DIR / "metrics" / "eva_roofline.train.py")
    wl = common.workload(CELL)
    cfg = common.config(wl["config"])
    b = common.builder(cfg)
    towers = b.train_towers(cfg, common.traffic(wl["traffic"]))
    ns = "void dc::(anonymous namespace)::"
    seconds = {ns + "dense_ln_rope_wgmma_kernel(CUtensorMap_st)": 2.0,
               ns + "dense_swiglu_ln_wgmma_kernel(CUtensorMap_st)": 3.0,
               ns + "dense_ln_width_wgmma_kernel(CUtensorMap_st)": 1.5,
               ns + "ln_stats_width_w16_kernel(bf16 const*)": 0.5,
               ns + "dense_ln_wgmma_kernel<0, false>(CUtensorMap_st)": 9.0,
               ns + "ln_stats_w16_kernel<0>(bf16 const*)": 9.0}

    class Trace:
        def seconds(self, keep):
            return sum(t for name, t in seconds.items() if keep("kernel", name))

    units = 3
    counts = {m: 24 * units for m in reader.MODES}
    r = {"kind": "train", "trace": Trace(), "units_profiled": units, "launch_counts": counts,
         "towers": towers}
    files = [common.load_module(common.BENCH_DIR / "kernels" / f"{m}.py") for m in reader.MODES]
    need = units * sum(least_seconds(*k.work(launch)) for k in files
                       for launch in k.launches(towers))
    assert reader.read(r) == pytest.approx(100.0 * need / 7.0)
    assert reader.read({**r, "launch_counts": {**counts, "dense_ln_width": 0}}) is None
