"""#8, ``ops.dense_act_ln_res``: K2 under a gradient, which also writes the
pre-activation u, the activation's residual e and the rows' statistics for
the backward.

Least work: the product's FLOPs; x, γ, β, W, the bias read once; h, u, e and
the statistics written once."""

from benchmark.kernels._shapes import BF16, FP32, rows, train_students

NAME = "dense_act_ln_res"
PATTERNS = ("dense_ln_wgmma_kernel", "ln_stats_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["C"], "N": t["mlp"]}
            for t in train_students(towers) for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    return 2.0 * R * C * N, BF16 * (R * C + 2 * C + C * N + N + 3 * R * N) + 2 * FP32 * R
