"""#9, ``ops.dense_ln_bwd``: the backward of a LayerNorm + product (the qkv
and fc1 of every trained layer): du·Wᵀ, then the LayerNorm's backward to dx,
with the normalised rows xn (for the weight gradient, a library product) and
the sums dγ, dβ.  Its device work is the ``wgmma`` kernel and the pass that
reduces its partial sums.

Least work: the product's FLOPs; x, γ, W, du and the statistics read once;
dx, xn, dγ and dβ written once."""

from benchmark.kernels._shapes import BF16, FP32, rows, train_students

NAME = "dense_ln_bwd"
PATTERNS = ("dense_ln_bwd_wgmma_kernel", "reduce_partials")


def launches(towers):
    out = []
    for t in train_students(towers):
        for _ in range(t["layers"]):
            out += [{"rows": rows(t), "C": t["C"], "N": 3 * t["C"]},
                    {"rows": rows(t), "C": t["C"], "N": t["mlp"]}]
    return out


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    read = BF16 * (R * C + C + C * N + R * N) + 2 * FP32 * R
    return 2.0 * R * C * N, read + BF16 * 2 * R * C + 2 * FP32 * C
