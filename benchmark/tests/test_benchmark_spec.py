"""The benchmark's files against its contract: every name resolves to a
file, names and units use the allowed characters, a new workload file is
found without an edit, and nothing the harness or the reference runs imports
JAX or the JAX package (the reference nothing of the program either)."""

from __future__ import annotations

import ast
import json
import re

import pytest

from bench_tiny import ROOT
from benchmark import common

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "distillclip_tpu"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = common.workload(cell)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    cfg = common.config(wl["config"])
    assert (common.BENCH_DIR / "configs" / f"{cfg['builder']}.py").is_file()
    assert (common.BENCH_DIR / "drivers" / f"{wl['driver']}.py").is_file()
    assert common.traffic(wl["traffic"])["inputs"]
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    reported = {m["name"] for m in common.cell_metrics(SPEC, cell, "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert common.cell_metrics(SPEC, cell, "per_layer")


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
    texts += [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_metric_readers_and_configs_exist():
    for m in SPEC["per_layer"]:
        assert hasattr(common.metric_reader(m["name"]), "read"), m["name"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        cfg = common.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and cfg["source"].startswith(("http", "arXiv"))
    assert {k.NAME for k in common.kernel_files()} >= {"dense_ln", "transform_attention_bwd"}


def test_extra_workload_found_without_edit(tmp_path):
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "lclip_b32.extra.json").write_text(json.dumps(
        {"config": "lclip_b32", "traffic": "train_textcached", "driver": "train_step",
         "chips": 1, "limits": {"loss": 1.0}}))
    wl = common.workload("lclip_b32.extra", tmp_path)
    assert wl["name"] == "lclip_b32.extra" and wl["config"] == "lclip_b32"
    reported = {m["name"] for m in common.cell_metrics(SPEC, wl["name"], "end_to_end")}
    assert reported == {"peak_mem_gib", "setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_anywhere_and_reference_stands_alone():
    files = sorted(common.BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)
        if "reference" in path.relative_to(common.BENCH_DIR).parts:
            assert "distillclip_tpu_torch" not in tops, path
            assert all(t in {"torch", "math", "typing", "__future__", "benchmark"} for t in tops)
            assert not {n for n in _imports(path) if n.startswith("benchmark.")
                        and not n.startswith("benchmark.reference")}, path
