"""Digest a torch.profiler trace of the port into a per-family cost table.

Usage:
    python -m distillclip_tpu_torch.cli fit -c CONFIG ...   # trainer: profiler: trace
    python -m distillclip_tpu_torch.tools.trace_summary result/<run> [--top 25] [--steps 5]

Reads the Chrome trace the trainer's ``trace`` profiler writes
(``<run>/torch_trace/trace.json``, ``training/profiling.py``; a run directory,
its ``torch_trace`` directory or the file itself), keeps the device's events
(kernels, copies and memsets), and groups their durations by family: the
port's kernels by name (:data:`PROFILE_GROUPS`, the table ``chip_smoke.py``'s
``--profile`` tables use too), the library's products, convolutions and the
optimizer's foreach kernels, and the elementwise rest.  Durations are reported
per traced step (``--steps``: the profiler traces the first 5 train steps by
default).  ``--ops N`` also lists the N costliest kernels by name.
:func:`trace_split` splits the traced steps between the host and the device,
and between the step's phase spans.

On a trace taken on the CPU there are no device events: the table is empty.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

# device kernels by the piece of the step they belong to, first match wins
PROFILE_GROUPS = (
    ("flash_attention forward (#16, tensor cores)", ("flash_attention_fwd_mma_kernel",)),
    ("flash_attention_bwd (#16, tensor cores)", ("flash_attention_bwd_mma_kernel",)),
    # #17's instances hold K3's kernel name: they come first
    ("#17 flash_transform_attention forward (tensor cores)", ("flash_tf_fwd_mma_kernel",)),
    ("#17 CUDA-core route (heads past the tensor-core kernel)",
     ("flash_transform_attention_fwd_kernel",)),
    # one kernel template: K2 / #8 are its activation instances, K1 act 0
    ("K2 / #8 dense_act_ln + dense_act_ln_res (wgmma, activation epilogue)",
     ("dense_ln_wgmma_kernel<1", "dense_ln_wgmma_kernel<2")),
    ("K1 dense_ln (wgmma)", ("dense_ln_wgmma_kernel",)),
    ("ln_stats_w16 (statistics and W's fp16 copy for K1, K2 and #8)", ("ln_stats_w16_kernel",)),
    ("#9 dense_ln_bwd (wgmma, clusters along C)", ("dense_ln_bwd_wgmma_kernel",)),
    ("K3 / #5 transform_attention forward (lean / save_p, tensor cores)",
     ("tf_fwd_mma_kernel",)),
    ("K3 / #5 CUDA-core route (heads past the tensor-core kernel)",
     ("transform_attention_kernel",)),
    ("#6 CUDA-core route (heads past the tensor-core backward)", ("tf_bwd_wide_",)),
    ("transform_attention_bwd", ("tf_bwd_",)),
    ("plain_attention forward (#13 lean / save_p, tensor cores)",
     ("plain_attention_mma_kernel",)),
    ("plain_attention_bwd (#14, tensor cores)", ("plain_attention_bwd_mma_kernel",)),
    ("#13L plain_attention_long (wgmma, past 256 tokens)", ("plain_attention_long_kernel",)),
    ("layer_norm_rows + bwd", ("layer_norm_rows",)),
    ("reduce_partials (#6, #9)", ("reduce_partials",)),
    ("optimizer (foreach kernels)", ("multi_tensor_apply",)),
    ("library convolutions (cuDNN; vit_kd)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("dense_act (#10-#12, wgmma)", ("dense_act_wgmma_kernel",)),
    ("library products (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "splitk")),
    ("copies and memset", ("memcpy", "memset")),
)


REST = "elementwise and the rest"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def family_of(name: str) -> str:
    """The :data:`PROFILE_GROUPS` family of a device event's name, or
    :data:`REST`."""
    name = name.lower()
    return next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), REST)


def trace_file(path) -> Path:
    """The trace of a run directory, of its ``torch_trace`` directory, or the
    file itself."""
    path = Path(path)
    for candidate in (path, path / "trace.json", path / "torch_trace" / "trace.json"):
        if candidate.is_file():
            return candidate
    raise FileNotFoundError(f"no torch_trace/trace.json under {path}")


def load_events(path) -> list:
    return json.loads(trace_file(path).read_text())["traceEvents"]


def summarize(path, top: int = 25, steps: int = 5, ops: int = 0) -> dict:
    """The device's ms per step by family (the ``top`` costliest), and with
    ``ops`` the costliest kernels by name."""
    fam_us, fam_n = collections.Counter(), collections.Counter()
    op_us, op_n = collections.Counter(), collections.Counter()
    for ev in load_events(path):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        dur, name = float(ev.get("dur", 0.0)), ev.get("name", "?")
        fam = family_of(name)
        fam_us[fam] += dur
        fam_n[fam] += 1
        op_us[name] += dur
        op_n[name] += 1
    total = sum(fam_us.values())
    row = lambda us: {"ms_per_step": round(us / 1e3 / steps, 3),
                      "pct": round(100.0 * us / total, 1) if total else 0.0}
    out = {"trace": str(trace_file(path)), "steps": steps,
           "device_total_ms_per_step": round(total / 1e3 / steps, 3),
           "families": [{"family": f, **row(us), "count": fam_n[f]}
                        for f, us in fam_us.most_common(top)]}
    if ops:
        out["ops"] = [{"op": n, **row(us), "count": op_n[n]} for n, us in op_us.most_common(ops)]
    return out


def trace_split(path, skip: int = 1) -> dict:
    """Per step of a fit's torch.profiler trace, past its first ``skip``
    steps: the host's ms between step starts, in ``host_to_device`` and in
    ``train_step`` (launching the step), the device's busy ms (the union
    of the kernels and copies those steps launched) and its window (first
    start to last end of that work), and ``phases``: for each of the step's
    phase spans (``step.student``, ``step.teacher``, ``step.loss``,
    ``step.backward``, ``step.optimizer``; ``training.profiling.span``) its
    host ms and the device ms of the work launched while it was open (the
    backward's launches come from autograd's own thread)."""
    events = [e for e in load_events(path) if e.get("ph") == "X"]
    spans = {name: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                          if e.get("cat") == "user_annotation" and e["name"] == name)
             for name in ("host_to_device", "train_step")}
    h2d, steps = spans["host_to_device"], spans["train_step"]
    if len(h2d) != len(steps) or len(steps) <= skip + 1:
        raise ValueError(f"fit: the trace at {path} holds {len(h2d)} / {len(steps)} step spans")
    t0, t1 = h2d[skip][0], steps[-1][1]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e.get("args", {}).get("correlation") in launched]
    if not device:
        raise ValueError(f"fit: the trace at {path} holds no device work for the traced steps")
    work = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, work[0][0]
    for a, b in work:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    phases = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("step.")
              and t0 <= e["ts"] <= t1]
    host_us, device_us = collections.Counter(), collections.Counter()
    for a, b, name in phases:
        host_us[name] += b - a
    for e in device:
        t = launched[e["args"]["correlation"]]
        inner = [(b - a, name) for a, b, name in phases if a <= t < b]
        if inner:
            device_us[min(inner)[1]] += e["dur"]
    n = len(steps) - skip
    mean = lambda xs: sum(b - a for a, b in xs) / len(xs) / 1e3
    return {"steps": n, "host_step_ms": (h2d[-1][0] - h2d[skip][0]) / (n - 1) / 1e3,
            "to_device_ms": mean(h2d[skip:]), "train_step_ms": mean(steps[skip:]),
            "device_busy_ms": busy / n / 1e3, "device_window_ms": (end - work[0][0]) / n / 1e3,
            "phases": {name: {"device_ms": device_us[name] / n / 1e3,
                              "host_ms": host_us[name] / n / 1e3} for name in sorted(host_us)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a run directory, its torch_trace directory or trace.json")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=5,
                    help="traced step count (the trainer's trace profiler records 5)")
    ap.add_argument("--ops", type=int, default=0, help="also list the top-N kernels by name")
    ap.add_argument("--json", action="store_true", help="print raw JSON")
    args = ap.parse_args(argv)
    out = summarize(args.trace, top=args.top, steps=args.steps, ops=args.ops)
    if args.json:
        json.dump(out, sys.stdout, indent=1)
        print()
        return 0
    print(f"trace: {out['trace']}")
    print(f"device total: {out['device_total_ms_per_step']} ms/step over {args.steps} steps")
    print(f"{'ms/step':>9}  {'%':>5}  {'n':>6}  family")
    for r in out["families"]:
        print(f"{r['ms_per_step']:>9.3f}  {r['pct']:>5.1f}  {r['count']:>6}  {r['family']}")
    for r in out.get("ops", []):
        print(f"{r['ms_per_step']:>9.3f}  {r['pct']:>5.1f}  {r['count']:>6}  {r['op']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
