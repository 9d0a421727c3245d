"""#7, ``ops.layer_norm_rows_bwd``: the backward of the students' final norm
on the pooled rows: dx and the sums dγ, dβ.

Least work: memory, x, γ, the gradient and the statistics read once, dx
written once."""

from benchmark.kernels._shapes import BF16, FP32, train_students

NAME = "layer_norm_rows_bwd"
PATTERNS = ("layer_norm_rows",)


def launches(towers):
    return [{"rows": t["B"], "C": t["C"]} for t in train_students(towers)]


def work(l):
    R, C = l["rows"], l["C"]
    return 10.0 * R * C, BF16 * (3 * R * C + C) + FP32 * (2 * R + 2 * C)
