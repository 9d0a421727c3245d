"""K1's width mode, ``ops.dense_ln_width``: LN_ffn of EVA-02's block over the
true SwiGLU width of rows padded to a multiple of 32, and the product with w3,
lean (the frozen EVA-02-CLIP teacher).  Planned for EVA towers only (``"kind":
"eva"``).  Its device work is the product (``dense_ln_width_wgmma_kernel``) and
the statistics launch that also makes W's fp16 copy
(``ln_stats_width_w16_kernel``, which EVA-02's three modes share).

Least work, at the true width: the product's FLOPs; h, γ, β, W and the bias
read once, the output written once."""

from benchmark.kernels._shapes import BF16, rows

NAME = "dense_ln_width"
PATTERNS = ("dense_ln_width_wgmma_kernel", "ln_stats_width_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["mlp"], "N": t["C"]}
            for t in towers if t["kind"] == "eva" for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    return 2.0 * R * C * N, BF16 * (R * C + 2 * C + C * N + N + R * N)
