"""The program's kernels against their roofline, over the traced steps.

Numerator: for every launch the traced steps made of a kernel that has a file
under ``kernels/``, the least time of its work, the larger of its FLOPs over
the card's bf16 peak and its bytes over the bandwidth of device memory, the
work taken from the shapes of the call (``launches(towers)``, ``work``).
Denominator: the device time of those kernels' events in the trace (their
``PATTERNS``).  The launches come from the configuration's towers, and the
program's own launch counters over the traced steps have to agree with them,
kernel by kernel: where one differs, or a kernel launched that no file
describes, the share is not read.
"""

from __future__ import annotations

from benchmark.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_S, kernel_files
from benchmark.trace import matches


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def plan(towers: list) -> dict:
    """``{kernel: [launch, ...]}`` of one step (or one scored batch)."""
    return {k.NAME: k.launches(towers) for k in kernel_files()}


def mismatch(towers: list, counts: dict, units: int) -> list:
    """Kernels whose counted launches differ from the plan's over ``units``
    steps, as (kernel, counted, planned)."""
    planned = {k: len(v) * units for k, v in plan(towers).items()}
    names = set(planned) | {k for k, v in counts.items() if v}
    return [(k, counts.get(k, 0), planned.get(k))
            for k in sorted(names) if counts.get(k, 0) != planned.get(k)]


def kernel_roofline(readings: dict):
    """The share in %, or None where the trace or the counters do not allow
    it."""
    trace, units, counts = (readings.get(k) for k in ("trace", "units_profiled",
                                                      "launch_counts"))
    if trace is None or not units or counts is None:
        return None
    if mismatch(readings["towers"], counts, units):
        return None
    files = kernel_files()
    need = units * sum(least_seconds(*k.work(launch))
                       for k in files for launch in k.launches(readings["towers"]))
    patterns = [p for k in files for p in k.PATTERNS]
    took = trace.seconds(lambda cat, name: cat == "kernel" and matches(name, patterns))
    return 100.0 * need / took if took > 0 else None
