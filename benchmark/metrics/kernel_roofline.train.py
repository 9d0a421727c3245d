"""The program's kernels' share of their roofline in a train step
(``benchmark/roofline.py``), from the traced steps."""

from benchmark.roofline import kernel_roofline


def read(r):
    return kernel_roofline(r) if r["kind"] == "train" else None
