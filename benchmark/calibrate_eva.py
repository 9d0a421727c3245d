#!/usr/bin/env python3
"""The readings the limits of an EVA-02-CLIP cell are set from, on the GPU
(not part of a benchmark run):

    python3 benchmark/calibrate_eva.py --workload eva02_l14.train_stage1_1024 \
        --seeds 101,102,...,112 --control-seeds 101,102,103

What ``calibrate.py`` reads for a train cell (each seed's program against
the float32 reference; on each control seed the fp8 control, the teacher's
fp8 control and the half-batch fault), and on each control seed also the
rolled-picture fault (the reference on each batch's pictures rolled by one
row, so that its rows are out of line with the program's) and each mechanism
control of ``reference/eva.py`` (the reference's teacher with the rotary
embedding left out, turned on halves, SiLU on W2's half, LN_ffn's moments
over the padded width, LN_inner left out).  One JSON line per reading, and a
summary last: the largest program reading and the smallest control and
fault readings of each number.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from benchmark import calibrate, common, compare, generator  # noqa: E402
from benchmark.drivers import train_step  # noqa: E402
from benchmark.reference import eva as RE  # noqa: E402
from benchmark.reference.numerics import Precision, fp32_mode  # noqa: E402
from benchmark.reference.train import train_readings  # noqa: E402
from benchmark.weights import student_masters  # noqa: E402


def variant_reference(ctx: dict, shapes: dict, batches: list, variant: str) -> dict:
    """The reference's readings with the teacher's ``variant``."""
    b, cfg, mix = ctx["builder"], ctx["cfg"], ctx["mix"]
    fp32_mode()
    model = b.reference_model(cfg, mix, ctx["device"], variant)
    return train_readings(model, student_masters(shapes, ctx["seed"], ctx["device"]), batches,
                          b.reference_optimizer(cfg), Precision("fp32"), cfg["reference_rows"])


def rows(ctx: dict, seeds: list, control: set):
    b, cfg, mix, device = ctx["builder"], ctx["cfg"], ctx["mix"], ctx["device"]
    program = b.TrainProgram(cfg, mix, device)
    at = mix["inputs"].index("images")
    for seed in seeds:
        ctx["seed"] = seed
        pool = generator.pool(mix, b.input_shapes(cfg), seed, device)[:train_step.FIRST_STEPS]
        state, step, tx = program.start(seed)
        state, first = train_step.first_steps(program, state, step, tx, pool, seed)
        del state, step, tx
        calibrate.free()
        ref = train_step.reference(ctx, program.shapes, pool)
        yield {"seed": seed, "kind": "program", **compare.train_numbers(first, ref),
               "losses": first["losses"], "ref_losses": ref["losses"]}
        if seed not in control:
            continue
        rolled = [[x.roll(1, 0) if j == at else x for j, x in enumerate(batch)]
                  for batch in pool]
        others = [("control_fp8", lambda: train_step.reference(ctx, program.shapes, pool,
                                                               precision="fp8")),
                  ("control_fp8_teacher", lambda: train_step.reference(
                      ctx, program.shapes, pool, teacher_precision="fp8")),
                  ("fault_half_batch", lambda: train_step.reference(ctx, program.shapes, pool,
                                                                    half_batch=True)),
                  ("fault_roll_images", lambda: train_step.reference(ctx, program.shapes,
                                                                     rolled))]
        others += [(f"control_{v}", lambda v=v: variant_reference(ctx, program.shapes, pool, v))
                   for v in RE.VARIANTS]
        for kind, make in others:
            other = make()
            yield {"seed": seed, "kind": kind, **compare.train_numbers(other, ref),
                   "losses": other["losses"]}
            calibrate.free()
        del pool
        calibrate.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_eva: no CUDA device", file=sys.stderr)
        return 2
    wl = common.workload(args.workload)
    cfg = common.config(wl["config"])
    ctx = {"workload": wl, "cfg": cfg, "mix": common.traffic(wl["traffic"]),
           "builder": common.builder(cfg), "device": "cuda"}
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    summary = {}
    t0 = time.perf_counter()
    for row in rows(ctx, seeds, control):
        row["t_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(row), flush=True)
        for k in (k for k, v in row.items() if isinstance(v, float) and k != "t_s"):
            key = (row["kind"], k)
            pick = max if row["kind"] == "program" else min
            summary[key] = pick(summary.get(key, row[k]), row[k])
    print(json.dumps({"summary": {f"{kind}.{k}": v for (kind, k), v in summary.items()},
                      "limits": wl["limits"], "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
