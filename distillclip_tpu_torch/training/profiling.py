"""Profiling: per-phase wall-time summary, or a torch.profiler trace.

Port of ``distillclip_tpu/training/profiling.py``:

* ``simple``: wall time per named phase, written as a table to
  ``profile.txt`` (Lightning's SimpleProfiler);
* ``trace``: ``torch.profiler`` over the first ``trace_steps`` train steps
  (the host and, on a card, the device), written as a Chrome trace to
  ``<run>/torch_trace/trace.json`` (the JAX package writes a jax.profiler
  trace under ``jax_trace``).

:func:`span` marks a phase of the program (the train step's ``step.*``, the
score stream's ``score.*``) in whatever ``torch.profiler`` trace is being
recorded, and costs a flag check when none is.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records, a
    shared no-op context otherwise: an unrecorded ``record_function`` costs
    ~10 µs on a CPU, the check well under one."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class SimpleProfiler:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def maybe_start(self):
        pass

    def step(self):
        pass

    def summary(self) -> str:
        rows = ["| phase | total s | calls | mean ms |", "|---|---|---|---|"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t, c = self.times[name], self.counts[name]
            rows.append(f"| {name} | {t:.3f} | {c} | {t / max(c, 1) * 1000:.2f} |")
        return "\n".join(rows)

    def write(self):
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "profile.txt"), "w") as f:
            f.write(self.summary() + "\n")


class TraceProfiler:
    """torch.profiler over the first ``trace_steps`` train steps."""

    def __init__(self, out_dir: str, trace_steps: int = 5):
        self.out_dir = os.path.join(out_dir, "torch_trace")
        self.trace_steps = trace_steps
        self._prof = None
        self._seen = 0

    def maybe_start(self):
        if self._prof is None and self._seen == 0:
            from torch.profiler import ProfilerActivity

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def step(self):
        if self._prof is not None:
            self._seen += 1
            if self._seen >= self.trace_steps:
                self.stop()

    def stop(self):
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
            self._prof = None

    def profile(self, name: str):
        return span(name)

    def write(self):
        self.stop()


class NullProfiler:
    @contextlib.contextmanager
    def profile(self, name: str):
        yield

    def maybe_start(self):
        pass

    def step(self):
        pass

    def write(self):
        pass


def build_profiler(kind: Optional[str], out_dir: str):
    if kind in (None, "", "none"):
        return NullProfiler()
    if kind == "simple":
        return SimpleProfiler(out_dir)
    if kind == "trace":
        return TraceProfiler(out_dir)
    raise ValueError(f"unknown profiler {kind!r} (use simple|trace)")
