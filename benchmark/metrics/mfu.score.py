"""The scored pairs' model FLOPs (``benchmark/flops.py``) at the window's
rate, against the card's bf16 peak, in %."""

from benchmark.common import PEAK_BF16_FLOPS


def read(r):
    if r["kind"] != "score" or not r.get("rate"):
        return None
    return 100.0 * r["rate"] * r["item_flops"] / PEAK_BF16_FLOPS
