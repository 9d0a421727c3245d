"""K1's rotary mode, ``ops.dense_ln_rope``: LN_1 of EVA-02's block, the fused
q, k, v product and the 2-D rotary turn of q and k in the epilogue, lean (the
frozen EVA-02-CLIP teacher).  Planned for EVA towers only (``"kind":
"eva"``).  Its device work is the product (``dense_ln_rope_wgmma_kernel``) and
the statistics launch that also makes W's fp16 copy
(``ln_stats_width_w16_kernel``, which EVA-02's three modes share).

Least work: the product's FLOPs; x, γ, β, W, the bias and the (cos, sin) table
read once, u written once."""

from benchmark.kernels._shapes import BF16, FP32, rows

NAME = "dense_ln_rope"
PATTERNS = ("dense_ln_rope_wgmma_kernel", "ln_stats_width_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["C"], "N": 3 * t["C"], "patches": t["N"] - 1, "d": t["d"]}
            for t in towers if t["kind"] == "eva" for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    table = FP32 * 2 * l["patches"] * l["d"] // 2
    return 2.0 * R * C * N, BF16 * (R * C + 2 * C + C * N + N + R * N) + table
