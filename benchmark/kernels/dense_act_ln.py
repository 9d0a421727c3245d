"""K2, ``ops.dense_act_ln`` without a gradient: LayerNorm, the fc1 product and
the activation (QuickGELU in CLIP's towers, exact GELU in the students'), the
lean route of the frozen teacher and of serving.

Least work: the product's FLOPs; x, γ, β, W, the bias read once, h written
once."""

from benchmark.kernels._shapes import BF16, lean_towers, rows

NAME = "dense_act_ln"
PATTERNS = ("dense_ln_wgmma_kernel", "ln_stats_w16_kernel")


def launches(towers):
    return [{"rows": rows(t), "C": t["C"], "N": t["mlp"]}
            for t in lean_towers(towers) for _ in range(t["layers"])]


def work(l):
    R, C, N = l["rows"], l["C"], l["N"]
    return 2.0 * R * C * N, BF16 * (R * C + 2 * C + C * N + N + R * N)
