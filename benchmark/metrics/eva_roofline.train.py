"""EVA-02's three modes of the LN GEMM in a train step against their roofline,
in %: the least time of their traced launches (each launch's larger of FLOPs
over the card's bf16 peak and bytes over the bandwidth of device memory,
``kernels/dense_ln_rope.py``, ``dense_swiglu_ln.py``, ``dense_ln_width.py``)
over the device time of their own kernels in the trace: each mode's product and
the statistics launches they share.  Read only where the towers plan launches of
them and the program's counters over the traced steps equal that plan, mode by
mode: a program without the modes reads nothing."""

from benchmark.common import BENCH_DIR, load_module
from benchmark.roofline import least_seconds
from benchmark.trace import matches

MODES = ("dense_ln_rope", "dense_swiglu_ln", "dense_ln_width")


def read(r):
    trace, units, counts = (r.get(k) for k in ("trace", "units_profiled", "launch_counts"))
    if r["kind"] != "train" or trace is None or not units or counts is None:
        return None
    files = [load_module(BENCH_DIR / "kernels" / f"{m}.py") for m in MODES]
    plans = {k.NAME: k.launches(r["towers"]) for k in files}
    if not any(plans.values()) or any(counts.get(k, 0) != units * len(p)
                                      for k, p in plans.items()):
        return None
    need = units * sum(least_seconds(*k.work(launch)) for k in files for launch in plans[k.NAME])
    patterns = [p for k in files for p in k.PATTERNS]
    took = trace.seconds(lambda cat, name: cat == "kernel" and matches(name, patterns))
    return 100.0 * need / took if took > 0 else None
