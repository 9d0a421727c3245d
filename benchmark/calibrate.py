#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the GPU, at a
cell's own sizes (not part of a benchmark run):

    python3 benchmark/calibrate.py --workload lclip_b32.train_textcached \
        --seeds 101,102,...,112 --control-seeds 101,102,103

For each seed the program's numbers (its first three steps, or its scores of
two passes over the pool, against the float32 reference); for each control
seed the control's (the reference computed with fp8 operands in the
program's place) and, for a train cell, the teacher's control (the same with
fp8 operands in the teacher alone) and the half-batch fault's (the
reference on the first half of every batch, its mean over those rows); for a
score cell, the program's scores of pictures out of line with their
captions: each batch's image rows rolled by one (``fault_roll_images``), and
each batch's captions with the previous batch's pictures
(``fault_prev_images``).  A state left unchanged reads 1 by construction
(``change3``) and needs no run.
One JSON line per reading on standard output, and a summary last: the
largest program reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from benchmark import common, compare, generator  # noqa: E402
from benchmark.drivers import score_stream, train_step  # noqa: E402


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_rows(ctx: dict, seeds: list, control: set):
    b, cfg, mix, device = ctx["builder"], ctx["cfg"], ctx["mix"], ctx["device"]
    program = b.TrainProgram(cfg, mix, device)
    for seed in seeds:
        ctx["seed"] = seed
        pool = generator.pool(mix, b.input_shapes(cfg), seed, device)[:train_step.FIRST_STEPS]
        state, step, tx = program.start(seed)
        state, first = train_step.first_steps(program, state, step, tx, pool, seed)
        del state, step, tx
        free()
        ref = train_step.reference(ctx, program.shapes, pool)
        yield {"seed": seed, "kind": "program", **compare.train_numbers(first, ref),
               "losses": first["losses"], "ref_losses": ref["losses"]}
        if seed in control:
            for kind, kw in (("control_fp8", {"precision": "fp8"}),
                             ("control_fp8_teacher", {"teacher_precision": "fp8"}),
                             ("fault_half_batch", {"half_batch": True})):
                other = train_step.reference(ctx, program.shapes, pool, **kw)
                yield {"seed": seed, "kind": kind, **compare.train_numbers(other, ref),
                       "losses": other["losses"]}
        del pool
        free()


def score_rows(ctx: dict, seeds: list, control: set):
    b, cfg, mix, device = ctx["builder"], ctx["cfg"], ctx["mix"], ctx["device"]
    for seed in seeds:
        ctx["seed"] = seed
        program = b.ScoreProgram(cfg, seed, device)
        pool = [[x.cpu() for x in batch]
                for batch in generator.pool(mix, b.input_shapes(cfg), seed, device)]
        stream = program.scorer.score_tokens_stream
        outs = list(stream(iter(pool + pool), depth=mix["depth"]))
        faults = {}
        if seed in control:
            at = mix["inputs"].index("images")
            for kind, images in (("fault_roll_images", lambda i: pool[i][at].roll(1, 0)),
                                 ("fault_prev_images", lambda i: pool[i - 1][at])):
                fed = [[images(i) if j == at else x for j, x in enumerate(batch)]
                       for i, batch in enumerate(pool)]
                faults[kind] = list(stream(iter(fed), depth=mix["depth"]))
        shapes = program.shapes
        del program, stream
        free()
        refs = score_stream.reference_scores(ctx, shapes, pool)
        yield {"seed": seed, "kind": "program", "score_gap": score_stream.score_gap(outs, refs)}
        if seed in control:
            ctl = score_stream.reference_scores(ctx, shapes, pool, "fp8")
            yield {"seed": seed, "kind": "control_fp8",
                   "score_gap": score_stream.score_gap(ctl, refs)}
            for kind, scores in faults.items():
                yield {"seed": seed, "kind": kind,
                       "score_gap": score_stream.score_gap(scores, refs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    wl = common.workload(args.workload)
    cfg = common.config(wl["config"])
    ctx = {"workload": wl, "cfg": cfg, "mix": common.traffic(wl["traffic"]),
           "builder": common.builder(cfg), "device": "cuda"}
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = train_rows if wl["driver"] == "train_step" else score_rows
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
