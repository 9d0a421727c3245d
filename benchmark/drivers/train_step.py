"""Train steps dispatched back to back: the driver of the train cells.

Set-up builds the program's task and one state from the benchmark's masters,
makes the traffic's pool of batches on the device, and drives that state
through its first three steps with the window's own call, on three distinct
batches: they warm every shape, and their readings (each loss, the first
gradient from Adam's moment, the change of every leaf, and the teacher's
representations, the students' outputs and the loss parts that the first
step's loss read) are what the reference is held against.  The window hands
on the same state: steps on the pool's batches in turn, the loss read back
every ``readback_every`` steps as the trainer logs, and the window ends when
the last loss is read back and the device is synchronised, so queued work
counts.  ``train_pairs_per_s`` is all the pairs of all the steps over all
that time.

With ``--trace 1`` a few more steps run under the profiler.  The program's
state is then freed and the reference computes its three steps in float32.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare, generator
from benchmark.common import CACHE_DIR
from benchmark.reference.numerics import Precision, fp32_mode
from benchmark.reference.train import train_readings
from benchmark.trace import profile

FIRST_STEPS = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def first_steps(program, state, step, tx, pool: list, seed: int) -> tuple:
    """(state, readings) after the first steps on ``pool[0..2]``: each loss;
    of the first step, its loss parts, the teacher's representations and the
    students' outputs that its loss read, and the gradient (kept in host
    memory, out of the window's peak); each leaf's change after the last."""
    seen, close = program.tap(state)
    losses, first = [], None
    try:
        for t in range(FIRST_STEPS):
            state, metrics = step(state, *pool[t])
            losses.append(float(metrics["loss"]))
            if first is None:
                close()
                vec = {k: (mu / (1.0 - tx.b1)).cpu() for k, mu in state.opt_state["mu"].items()}
                first = {"parts1": {k: float(v) for k, v in metrics.items() if k != "loss"},
                         "teacher1": [None if x is None else x.cpu() for x in seen["teacher"]],
                         "students1": [x.cpu() for x in seen["students"] or []],
                         "grad1": {k: float(g.norm()) for k, g in vec.items()}, "grad1_vec": vec}
    finally:
        close()
    start = program.masters(seed)
    change = {k: float((state.params[k] - v).norm()) for k, v in start.items()}
    return state, {"losses": losses, **first, "change": change}


def reference(ctx: dict, shapes: dict, batches: list, precision: str = "fp32",
              half_batch: bool = False, teacher_precision: str = None) -> dict:
    from benchmark.weights import student_masters

    b, cfg, mix = ctx["builder"], ctx["cfg"], ctx["mix"]
    fp32_mode()
    model = b.reference_model(cfg, mix, ctx["device"])
    params0 = student_masters(shapes, ctx["seed"], ctx["device"])
    PT = Precision(teacher_precision) if teacher_precision else None
    return train_readings(model, params0, batches, b.reference_optimizer(cfg),
                          Precision(precision), cfg["reference_rows"], half_batch, PT)


def run(ctx: dict) -> dict:
    b, cfg, mix, device, seed = (ctx[k] for k in ("builder", "cfg", "mix", "device", "seed"))
    clock = ctx["clock"]
    clock.mark("imports")
    program = b.TrainProgram(cfg, mix, device)
    clock.mark("program")
    pool = generator.pool(mix, b.input_shapes(cfg), seed, device)
    clock.mark("pool")
    state, step, tx = program.start(seed)
    clock.mark("state")
    state, first = first_steps(program, state, step, tx, pool, seed)
    sync(device)
    clock.mark("first_steps")
    setup_s = time.perf_counter() - ctx["t_start"]

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pairs, every = mix["pairs"], mix["readback_every"]
    dispatch, n, bad = [], 0, 0
    t0 = time.perf_counter()
    while True:
        batch = pool[(FIRST_STEPS + n) % len(pool)]
        a = time.perf_counter()
        state, metrics = step(state, *batch)
        dispatch.append(time.perf_counter() - a)
        n += 1
        if n % every == 0:
            bad += not math.isfinite(float(metrics["loss"]))
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    if n % every:
        bad += not math.isfinite(float(metrics["loss"]))
    sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    readings = {"kind": "train", "dispatch_s": dispatch, "rate": n * pairs / window_s,
                "item_flops": b.train_pair_flops(cfg, mix), "towers": b.train_towers(cfg, mix)}
    if ctx["trace"]:
        from distillclip_tpu_torch import ops

        units = mix["profile_steps"]

        def traced():
            nonlocal state
            for k in range(units):
                state, m = step(state, *pool[k % len(pool)])
            float(m["loss"])
            sync(device)

        ops.reset_launch_counts()
        readings["trace"] = profile(traced, CACHE_DIR / "trace" / f"{ctx['workload']['name']}.json")
        readings.update(units_profiled=units, launch_counts=ops.launch_counts())

    shapes, kept = program.shapes, pool[:FIRST_STEPS]
    del state, step, tx, program, pool, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(ctx, shapes, kept)
    numbers = compare.train_numbers(first, ref)
    return {"e2e": {"train_pairs_per_s": n * pairs / window_s, "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": setup_s},
            "readings": readings, "numbers": numbers, "attempted": n, "failed": bad,
            "memory_peak_bytes": peak, "window_s": window_s}
