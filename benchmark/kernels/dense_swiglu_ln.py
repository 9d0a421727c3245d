"""K2's SwiGLU mode, ``ops.dense_swiglu_ln``: LN_2 of EVA-02's block, the
product with W1 and W2 interleaved by columns, and silu(x1)·x2 in the epilogue
at half width, lean (the frozen EVA-02-CLIP teacher).  Planned for EVA towers
only (``"kind": "eva"``).  Its device work is the product
(``dense_swiglu_ln_wgmma_kernel``) and the statistics launch that also makes
W's fp16 copy (``ln_stats_width_w16_kernel``, which EVA-02's three modes
share).

Least work, at the true SwiGLU width (the program pads it to a multiple of 32):
the two products' FLOPs; x, γ, β, W1, W2 and their biases read once, h written
once."""

from benchmark.kernels._shapes import BF16, rows

NAME = "dense_swiglu_ln"
PATTERNS = ("dense_swiglu_ln_wgmma_kernel", "ln_stats_width_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["C"], "hidden": t["mlp"]}
            for t in towers if t["kind"] == "eva" for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], 2 * l["hidden"]
    return 2.0 * R * C * N, BF16 * (R * C + 2 * C + C * N + N + R * N // 2)
