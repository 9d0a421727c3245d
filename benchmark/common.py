"""What every run of the benchmark shares: where its files are, how a name in
``BENCHMARK.json`` becomes a file, the card's peaks, seeded generators and
the check for modules that must not be loaded.

The benchmark is driven by data.  A cell (``workloads/<cell>.json``) names a
configuration (``configs/<config>.json`` with its builder
``configs/<builder>.py``), a traffic mix (``traffic/<mix>.json``) and a
driver (``drivers/<driver>.py``); each per-layer metric is a reader of its
own (``metrics/<metric>.py``) and each of the program's kernels a file of its
own (``kernels/<kernel>.py``).  Adding any of them adds a file and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every file a run writes (the seeded teachers, the profiler's trace) lies here,
# at fixed paths inside the checkout
CACHE_DIR = ROOT / ".cache" / "benchmark"
# where the program keeps its built kernel library, one file per hash of its
# sources: a run that adds a file there built it
KERNEL_LIBRARY_DIR = ROOT / "build" / "torch_kernels"

# top-level module names no run may hold once its window has closed: JAX and
# the JAX package the port was made from (compared whole, so the port's own
# name, which starts with the JAX package's, passes)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "distillclip_tpu")

# NVIDIA H100 SXM data sheet, dense rates: bf16 on the tensor cores and the
# bandwidth of device memory, at the card's full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

# streams of one seed: the students' weights, the traffic
WEIGHT_STREAM, TRAFFIC_STREAM = 0, 1


def stream_seed(seed: int, stream: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` from ``--seed`` (any whole
    number up to 2**62) and a stream number."""
    return (int(seed) * 4 + stream) % 2 ** 63


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark as a module, whatever its name holds
    (metric readers are named ``<metric>.py``, with dots)."""
    name = "benchmark_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``workloads/<name>.json`` with its name."""
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload {name!r}: {path} does not exist")
    return {"name": name, **load_json(path)}


def config(name: str) -> dict:
    """``configs/<name>.json``: the configuration as it is run."""
    return {"name": name, **load_json(BENCH_DIR / "configs" / f"{name}.json")}


def builder(cfg: dict) -> ModuleType:
    """The configuration's builder, ``configs/<builder>.py`` (by default
    named as the configuration)."""
    return load_module(BENCH_DIR / "configs" / f"{cfg.get('builder', cfg['name'])}.py")


def traffic(name: str) -> dict:
    """``traffic/<name>.json``: the mix's parameters."""
    return {"name": name, **load_json(BENCH_DIR / "traffic" / f"{name}.json")}


def driver(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "drivers" / f"{name}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def kernel_files() -> list:
    """Every ``kernels/<kernel>.py``: its ``NAME`` (the program's launch
    counter), ``PATTERNS`` (its device kernels' names in the profiler),
    ``launches(towers)`` and ``work(launch)``."""
    return [load_module(p) for p in sorted((BENCH_DIR / "kernels").glob("*.py"))
            if not p.name.startswith("_")]


def cell_metrics(spec: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``BENCHMARK.json`` gives ``cell``: those that list it, and those without
    a list that move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in reported:
            out.append(m)
    return out


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class SetupClock:
    """The parts of a run's set-up, from the process start: :meth:`mark`
    closes the part that ran since the last mark.  :meth:`summary` also says
    whether this run built the kernel library or wrote a teacher file, as
    only a checkout's first run does; such a run's ``setup_s`` holds the
    build and the write."""

    def __init__(self, t_start: float):
        self.last, self.parts = t_start, {}
        self.libraries = set(KERNEL_LIBRARY_DIR.glob("*.so"))

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now

    def summary(self) -> dict:
        from benchmark import weights

        return {"kernels_built": bool(set(KERNEL_LIBRARY_DIR.glob("*.so")) - self.libraries),
                "teacher_written": bool(weights.WRITTEN), "parts_s": dict(self.parts)}
