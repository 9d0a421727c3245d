"""The whole train step's model FLOPs (``benchmark/flops.py``) at the
window's rate, against the card's bf16 peak, in %: taken over the window,
whose steps lie outside the profiler's."""

from benchmark.common import PEAK_BF16_FLOPS


def read(r):
    if r["kind"] != "train" or not r.get("rate"):
        return None
    return 100.0 * r["rate"] * r["item_flops"] / PEAK_BF16_FLOPS
