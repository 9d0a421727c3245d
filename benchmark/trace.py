"""The traced part of a run: ``torch.profiler`` over a few steps (or batches)
inside one span, and the reading of its trace.

The families of device kernels are the program's own profile groups (copied
from ``distillclip_tpu_torch/tools/trace_summary.py``, ``PROFILE_GROUPS``),
so the breakdown speaks the names the repository's profiles use.  The busy
time is the union of the device's kernel, copy and memset intervals inside
the span, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import json
from pathlib import Path

WINDOW = "benchmark.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")

# device kernels by the piece of the step they belong to, first match wins
PROFILE_GROUPS = (
    ("flash_attention forward (#16, tensor cores)", ("flash_attention_fwd_mma_kernel",)),
    ("flash_attention_bwd (#16, tensor cores)", ("flash_attention_bwd_mma_kernel",)),
    ("#17 flash_transform_attention forward (tensor cores)", ("flash_tf_fwd_mma_kernel",)),
    ("#17 CUDA-core route (heads past the tensor-core kernel)",
     ("flash_transform_attention_fwd_kernel",)),
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
    ("layer_norm_rows + bwd", ("layer_norm_rows",)),
    ("reduce_partials (#6, #9)", ("reduce_partials",)),
    ("optimizer (foreach kernels)", ("multi_tensor_apply",)),
    ("library convolutions (cuDNN; vit_kd)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("dense_act (#10-#12, wgmma)", ("dense_act_wgmma_kernel",)),
    ("library products (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma", "cublas", "splitk")),
    ("copies and memset", ("memcpy", "memset")),
)
REST = "elementwise and the rest"
# the libraries' kernels: products, convolutions, collectives
LIBRARY = ("gemm", "cutlass", "nvjet", "xmma", "cublas", "splitk", "fprop", "dgrad", "wgrad",
           "conv", "cudnn", "nccl")


def family_of(name: str) -> str:
    name = name.lower()
    return next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), REST)


def matches(name: str, patterns) -> bool:
    name = name.lower()
    return any(p.lower() in name for p in patterns)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The device and host events of the span named :data:`WINDOW`; times
    in seconds."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        span = spans[0]
        self.t0, self.t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        self.device, self.host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if e.get("cat") in DEVICE_CATEGORIES and a < self.t1 and b > self.t0:
                self.device.append((max(a, self.t0), min(b, self.t1), e["cat"], e.get("name", "")))
            elif (e.get("cat") in HOST_CATEGORIES and e.get("tid") == span.get("tid")
                  and e is not span and a < self.t1 and b > self.t0):
                self.host.append((a, b, e.get("name", "")))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> list:
        return _union((a, b) for a, b, _, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def seconds(self, keep) -> float:
        """Device seconds of the events ``keep(category, name)`` accepts."""
        return sum(b - a for a, b, c, n in self.device if keep(c, n)) / 1e6

    def _host_at(self, t: float) -> str:
        inner = [(b - a, name) for a, b, name in self.host if a <= t < b]
        return min(inner)[1] if inner else "host Python (no operator)"

    def breakdown(self, top: int = 10) -> dict:
        """The device's families by seconds, and its idle seconds by what
        the host was running when each gap began."""
        fam = {}
        for a, b, _, name in self.device:
            f = family_of(name)
            fam[f] = fam.get(f, 0.0) + (b - a) / 1e6
        idle, end = {}, self.t0
        for a, b in self.busy() + [[self.t1, self.t1]]:
            if a > end:
                who = self._host_at(end)
                idle[who] = idle.get(who, 0.0) + (a - end) / 1e6
            end = max(end, b)
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(fam), "idle_gaps": order(idle)}


def profile(work, path: Path) -> Trace:
    """Run ``work()`` (which ends with the device synchronised) under the
    profiler inside the :data:`WINDOW` span; its trace, written to ``path``
    (a fixed file, overwritten each traced run)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW):
            work()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"])
