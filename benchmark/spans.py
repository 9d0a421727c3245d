"""The program's own phase spans in a traced run: device and host seconds by
span name, read from the run's trace file.

The program marks each phase of a train step (``step.student``,
``step.teacher``, ``step.loss``, ``step.backward``, ``step.optimizer``) and
of each scored batch (``score.stage``, ``score.launch``, ``score.wait``) with
``torch.profiler.record_function`` while a profiler records
(``distillclip_tpu_torch/training/profiling.py``, ``span``).  A program
without them leaves every span absent, and the readers then read nothing.

Device work belongs to the span that launched it: each kernel, copy and
memset of the window is matched to its ``cuda_runtime`` / ``cuda_driver``
launch by ``args.correlation``, and the launch to the innermost program span
on the window's thread whose interval holds the launch's time.  The time and
not the thread, because autograd launches the backward's kernels from a
thread of its own while the step's thread waits inside ``step.backward``.
Work launched outside every program span is unattributed.

:class:`benchmark.trace.Trace` keeps no correlation ids, so the file is
opened again: the one under ``CACHE_DIR / "trace"`` whose window span starts
where the reading's ``Trace`` does.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import common
from benchmark.trace import DEVICE_CATEGORIES, WINDOW

PREFIXES = ("step.", "score.")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _window(events: list) -> dict:
    """The trace's :data:`WINDOW` span, as :class:`benchmark.trace.Trace`
    takes it (the first), or None."""
    return next((e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"), None)


class Phases:
    """Seconds by program span in the window of one trace: ``device_s``
    (work launched inside each span), ``host_s`` (the spans' own length),
    ``count`` (spans of each name), ``unattributed_s`` (work launched outside
    every span) and ``device_events`` (the window's kernels, copies and
    memsets)."""

    def __init__(self, events: list):
        window = _window(events)
        t0 = float(window["ts"])
        t1 = t0 + float(window["dur"])
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and e.get("tid") == window.get("tid")
                      and str(e.get("name", "")).startswith(PREFIXES)
                      and t0 <= float(e["ts"]) < t1]
        self.host_s, self.count = {}, {}
        for a, b, name in self.spans:
            self.host_s[name] = self.host_s.get(name, 0.0) + (b - a) / 1e6
            self.count[name] = self.count.get(name, 0) + 1
        launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                    if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
        self.device_s, self.unattributed_s, self.device_events = {}, 0.0, 0
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if not (a < t1 and b > t0):
                continue
            s = (min(b, t1) - max(a, t0)) / 1e6
            self.device_events += 1
            name = self.span_at(launched.get(e.get("args", {}).get("correlation")))
            if name is None:
                self.unattributed_s += s
            else:
                self.device_s[name] = self.device_s.get(name, 0.0) + s

    def span_at(self, t) -> str:
        """The innermost program span open at host time ``t``, or None."""
        if t is None:
            return None
        inner = [(b - a, name) for a, b, name in self.spans if a <= t < b]
        return min(inner)[1] if inner else None


def trace_events(trace, directory: Path = None) -> list:
    """The events of the trace file under ``directory`` (by default
    ``CACHE_DIR / "trace"``) whose window starts at ``trace.t0``, the newest
    first; None where no file holds it."""
    directory = Path(directory or common.CACHE_DIR / "trace")
    paths = sorted(directory.glob("*.json"), key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        window = _window(events)
        if window is not None and float(window["ts"]) == trace.t0:
            return events
    return None


_LAST = {"trace": None, "phases": None}


def phases(r: dict):
    """The :class:`Phases` of the reading's traced run (kept for the next
    reader of the same run), or None without a trace or its file."""
    trace = r.get("trace")
    if trace is None:
        return None
    if _LAST["trace"] is not trace:
        events = trace_events(trace)
        _LAST.update(trace=trace, phases=None if events is None else Phases(events))
    return _LAST["phases"]


def device_ms(r: dict, kind: str, name: str):
    """Device ms a unit (a step, a batch) launched under the span ``name``;
    None where the run is not of ``kind``, its trace holds no device work or
    the program emits no such span."""
    if r["kind"] != kind:
        return None
    p = phases(r)
    if p is None or not p.device_events or not p.count.get(name):
        return None
    return 1e3 * p.device_s.get(name, 0.0) / r["units_profiled"]


def host_ms(r: dict, kind: str, name: str):
    """Host ms a unit spends inside the span ``name``; None where the run is
    not of ``kind`` or the program emits no such span."""
    if r["kind"] != kind:
        return None
    p = phases(r)
    if p is None or not p.count.get(name):
        return None
    return 1e3 * p.host_s[name] / r["units_profiled"]
