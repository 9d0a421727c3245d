"""A closed loop of batches through ``LCLIPScorer.score_tokens_stream``: the
driver of the scoring cells.

Set-up builds the scorer from the benchmark's weights and makes the traffic's
pool of batches on the device, then moves it to host memory, where a scoring
client holds its decoded images and token rows; one pass over the pool warms
every shape.  In the window the stream pulls batches from an iterator that
cycles through the pool until ``--seconds`` have passed, with ``depth``
batches in flight; the window ends when the stream yields its last scores.
Each batch's time runs from its pull to the yield of its scores.

With ``--trace 1`` a few more batches run under the profiler.  The scorer is
then freed, and every score of the window is held against the reference's
score of the same pair (the pool holds few distinct batches, so the
reference scores each once).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import generator
from benchmark.common import CACHE_DIR
from benchmark.reference.numerics import Precision, fp32_mode
from benchmark.trace import profile


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def reference_scores(ctx: dict, shapes: dict, pool: list, precision: str = "fp32") -> list:
    from benchmark.weights import student_masters

    b, cfg, mix, device = ctx["builder"], ctx["cfg"], ctx["mix"], ctx["device"]
    fp32_mode()
    params = student_masters(shapes, ctx["seed"], device)
    at = {k: i for i, k in enumerate(mix["inputs"])}
    with torch.no_grad():
        return [b.reference_scores(cfg, params, batch[at["images"]].to(device),
                                   batch[at["tokens"]].to(device), Precision(precision),
                                   cfg["reference_rows"]).cpu().numpy() for batch in pool]


def score_gap(outs: list, refs: list) -> float:
    """The largest |score − reference| over every batch ``outs`` holds (batch
    i is the pool's batch i mod its size)."""
    gaps = [float(np.abs(o - refs[i % len(refs)]).max()) for i, o in enumerate(outs)]
    return max(gaps) if gaps else float("inf")


def run(ctx: dict) -> dict:
    b, cfg, mix, device, seed = (ctx[k] for k in ("builder", "cfg", "mix", "device", "seed"))
    cuda = torch.device(device).type == "cuda"
    clock = ctx["clock"]
    clock.mark("imports")
    program = b.ScoreProgram(cfg, seed, device)
    scorer, depth = program.scorer, mix["depth"]
    clock.mark("program")
    pool = [[x.cpu() for x in batch]
            for batch in generator.pool(mix, b.input_shapes(cfg), seed, device)]
    clock.mark("pool")
    for _ in scorer.score_tokens_stream(iter(pool), depth=depth):
        pass
    clock.mark("warm_pass")
    setup_s = time.perf_counter() - ctx["t_start"]

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pulls, dones, outs = [], [], []
    t0 = time.perf_counter()

    def feed():
        i = 0
        while time.perf_counter() - t0 < ctx["seconds"]:
            pulls.append(time.perf_counter())
            yield pool[i % len(pool)]
            i += 1

    for scores in scorer.score_tokens_stream(feed(), depth=depth):
        dones.append(time.perf_counter())
        outs.append(scores)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    pairs = sum(len(o) for o in outs)

    readings = {"kind": "score", "rate": pairs / window_s,
                "item_flops": b.score_pair_flops(cfg, mix), "towers": b.score_towers(cfg, mix)}
    if ctx["trace"]:
        from distillclip_tpu_torch import ops

        units = mix["profile_batches"]

        def traced():
            for _ in scorer.score_tokens_stream((pool[k % len(pool)] for k in range(units)),
                                                depth=depth):
                pass

        ops.reset_launch_counts()
        readings["trace"] = profile(traced, CACHE_DIR / "trace" / f"{ctx['workload']['name']}.json")
        readings.update(units_profiled=units, launch_counts=ops.launch_counts())

    shapes = program.shapes
    del program, scorer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = reference_scores(ctx, shapes, pool)
    failed = len(pulls) - len(outs) + sum(not np.isfinite(o).all() for o in outs)
    latency = [d - p for p, d in zip(pulls, dones)]
    return {"e2e": {"score_pairs_per_s": pairs / window_s,
                    "score_batch_p95_ms": 1e3 * p95(latency) if latency else float("inf"),
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "readings": readings, "numbers": {"score_gap": score_gap(outs, refs)},
            "attempted": len(pulls), "failed": failed, "memory_peak_bytes": peak,
            "window_s": window_s}
