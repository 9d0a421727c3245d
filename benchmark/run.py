#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``distillclip_tpu_torch`` on the
GPUs of this machine.

    python3 benchmark/run.py --workload lclip_b32.train_textcached --seed 7 \
        --seconds 30 --trace 0

Loads the cell (``workloads/<cell>.json``), its configuration and traffic,
builds the program with the benchmark's own weights and inputs from the
seed, warms it up (set-up), measures for ``--seconds``, holds what the timed
path produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``setup`` (the set-up's parts,
and whether this run built the kernel library or wrote a teacher file, as a
checkout's first run does), and last ``checks``: each number compared beside
its limit (also the last lines on standard error).

It exits non-zero without a result when CUDA is missing or has fewer devices
than the cell asks for, and when JAX or the JAX package is loaded once the
window has closed.  Builds and caches stay inside the checkout
(``build/torch_kernels/`` for the kernels, ``.cache/benchmark/`` for the
seeded teachers and the trace).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = ROOT / ".cache" / "benchmark"
os.environ["TRITON_CACHE_DIR"] = str(CACHES / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHES / "torch_extensions")
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402
from benchmark.compare import held  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        limit, clock = (float(x) for x in smi.stdout.strip().split(","))
        out.update(power_limit_w=limit, sm_clock_mhz=clock)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return out


def execute(args, device: str, t_start: float) -> tuple:
    """(the result line, the numbers compared beside their limits, the
    numbers read and not compared) of one run on ``device``."""
    wl = common.workload(args.workload)
    cfg = common.config(wl["config"])
    ctx = {"workload": wl, "cfg": cfg, "mix": common.traffic(wl["traffic"]),
           "builder": common.builder(cfg), "device": device, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace), "t_start": t_start,
           "clock": common.SetupClock(t_start)}
    res = common.driver(wl["driver"]).run(ctx)
    spec = common.benchmark_spec()
    metrics = {}
    if args.trace:
        for m in common.cell_metrics(spec, wl["name"], "per_layer"):
            value = common.metric_reader(m["name"]).read(res["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in common.cell_metrics(spec, wl["name"], "end_to_end"):
            if m["name"] in res["e2e"]:
                metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    limits = wl["limits"]
    checks = {k: {"value": res["numbers"].get(k), "limit": v} for k, v in limits.items()}
    device_line = {**card(device), "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": held(res["numbers"], limits) and res["failed"] == 0,
            "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": device_line}
    trace = res["readings"].get("trace")
    if trace is not None:
        device_line.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["setup"] = ctx["clock"].summary()
    line["checks"] = checks
    return line, checks, {k: v for k, v in res["numbers"].items() if k not in limits}


def main(argv=None, device: str = None) -> int:
    """``device`` other than None skips the look for a GPU (the CPU tests)."""
    args = parse(argv)
    if device is None:
        import torch

        chips = common.workload(args.workload)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    line, checks, readings = execute(args, device, T_START)
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; the port runs without JAX", file=sys.stderr)
        return 3
    print(f"setup: {json.dumps(line['setup'])}", file=sys.stderr)
    for name, value in readings.items():
        print(f"reading {name}: {value} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
