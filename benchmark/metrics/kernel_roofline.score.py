"""The program's kernels' share of their roofline in a scored batch
(``benchmark/roofline.py``), from the traced batches."""

from benchmark.roofline import kernel_roofline


def read(r):
    return kernel_roofline(r) if r["kind"] == "score" else None
