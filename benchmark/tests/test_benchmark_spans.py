"""The phase readers (``benchmark/spans.py``, ``metrics/*_ms.{train,score}.py``)
on hand-written Chrome traces, and on tiny traced runs on the CPU."""

from __future__ import annotations

import json

import pytest

from bench_tiny import install, run_cell
from benchmark import common, spans
from benchmark.trace import WINDOW, Trace

TRAIN = ("student_ms.train", "teacher_ms.train", "loss_ms.train", "backward_ms.train",
         "optimizer_ms.train")
SCORE = ("stage_ms.score", "wait_ms.score")
MAIN, AUTOGRAD = 1, 2


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "elementwise_kernel", "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def _step_trace(t0=1000.0, device=True) -> list:
    """One traced step: a window holding the five phases on the step's
    thread; a kernel launched in each, the backward's from autograd's thread
    (and a second backward launch from the step's thread), and a readback
    launched after the step, outside every phase."""
    ev = [_span(WINDOW, t0, 1000)]
    phases = (("step.student", 10), ("step.teacher", 100), ("step.loss", 200),
              ("step.backward", 300), ("step.optimizer", 600))
    for i, (name, a) in enumerate(phases):
        ev.append(_span(name, t0 + a, 90 if name != "step.backward" else 290))
        ev.append(_launch(i, t0 + a + 5, AUTOGRAD if name == "step.backward" else MAIN))
        if device:
            ev.append(_kernel(i, t0 + a + 20, 10 * (i + 1)))
    ev.append(_launch(9, t0 + 800))
    if device:
        ev.append(_kernel(9, t0 + 810, 4, "gpu_memcpy"))
    return ev


def _reading(events, tmp_path, monkeypatch, kind="train", name="cell.json") -> dict:
    directory = tmp_path / "trace"
    directory.mkdir(exist_ok=True)
    (directory / name).write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(common, "CACHE_DIR", tmp_path)
    return {"kind": kind, "trace": Trace(events), "units_profiled": 1}


def _read(metric, r):
    return common.metric_reader(metric).read(r)


def test_launch_from_another_thread_is_charged_to_the_open_span(tmp_path, monkeypatch):
    r = _reading(_step_trace(), tmp_path, monkeypatch)
    assert [_read(m, r) for m in TRAIN] == pytest.approx([0.01, 0.02, 0.03, 0.04, 0.05])
    p = spans.phases(r)
    assert p.count == {n: 1 for n in ("step.student", "step.teacher", "step.loss",
                                      "step.backward", "step.optimizer")}
    assert p.host_s["step.backward"] == pytest.approx(290e-6)


def test_launch_outside_every_span_is_unattributed(tmp_path, monkeypatch):
    p = spans.phases(_reading(_step_trace(), tmp_path, monkeypatch))
    assert p.unattributed_s == pytest.approx(4e-6) and p.device_events == 6
    assert sum(p.device_s.values()) == pytest.approx(150e-6)


def test_the_file_whose_window_starts_at_the_reading_is_read(tmp_path, monkeypatch):
    other = _step_trace(t0=5000.0)
    other[1]["name"] = "step.elsewhere"
    r = _reading(_step_trace(), tmp_path, monkeypatch, name="a.json")
    (tmp_path / "trace" / "b.json").write_text(json.dumps({"traceEvents": other}))
    assert "step.student" in spans.phases(r).count
    assert spans.trace_events(Trace(other), tmp_path / "trace")[1]["name"] == "step.elsewhere"
    assert spans.trace_events(Trace(_step_trace(t0=7.0)), tmp_path / "trace") is None


def test_device_readers_read_nothing_without_device_events(tmp_path, monkeypatch):
    r = _reading(_step_trace(device=False), tmp_path, monkeypatch)
    assert [_read(m, r) for m in TRAIN] == [None] * 5
    assert spans.host_ms(r, "train", "step.loss") == pytest.approx(0.09)


def test_a_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    events = [e for e in _step_trace() if not e["name"].startswith("step.")]
    r = _reading(events, tmp_path, monkeypatch)
    assert [_read(m, r) for m in TRAIN] == [None] * 5
    s = _reading(events, tmp_path, monkeypatch, kind="score")
    assert [_read(m, s) for m in SCORE] == [None] * 2


def test_tiny_traced_runs_print_the_score_spans_and_no_device_phase(monkeypatch, tmp_path):
    install(monkeypatch, tmp_path)
    rc, line = run_cell("lclip_b32.train_textcached", trace=1)
    assert rc == 0 and not set(TRAIN) & set(line["metrics"]), line["metrics"]
    rc, line = run_cell("lclip_b32.score_stream", trace=1)
    assert rc == 0 and set(SCORE) <= set(line["metrics"]), line["metrics"]
    assert all(line["metrics"][m]["value"] >= 0 for m in SCORE)
