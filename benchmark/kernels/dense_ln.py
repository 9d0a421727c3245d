"""K1, ``ops.dense_ln``: LayerNorm of the rows, then the product with W (the
qkv projection of every tower), with the rows' mean and rstd under a
gradient.  Its device work is the ``wgmma`` GEMM with the LayerNorm prologue
and the statistics pass that also makes W's fp16 copy (shared with K2 / #8).

Least work: the product's FLOPs; x, γ, β, W and the bias read once, the output
(and the statistics) written once."""

from benchmark.kernels._shapes import BF16, FP32, rows

NAME = "dense_ln"
PATTERNS = ("dense_ln_wgmma_kernel", "ln_stats_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["C"], "N": 3 * t["C"], "bias": t["qkv_bias"],
             "stats": t["mode"] == "train"}
            for t in towers for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    nbytes = BF16 * (R * C + 2 * C + C * N + R * N + (N if l["bias"] else 0))
    return 2.0 * R * C * N, nbytes + (2 * FP32 * R if l["stats"] else 0)
