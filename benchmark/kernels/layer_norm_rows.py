"""K4, ``ops.layer_norm_rows``: LayerNorm of rows, with their statistics under
a gradient: the students' final norm on the pooled rows, CLIP's ``ln_pre``
and ``ln_post`` over every token of its ViT and ``ln_final`` of its text
tower.

Least work: memory, x and γ, β read once, y (and the statistics) written
once."""

from benchmark.kernels._shapes import BF16, FP32, rows

NAME = "layer_norm_rows"
PATTERNS = ("layer_norm_rows",)


def launches(towers):
    out = []
    for t in towers:
        if t["kind"] == "student":
            out.append({"rows": t["B"], "C": t["C"], "stats": t["mode"] == "train"})
        else:
            n = 2 if t["modality"] == "image" else 1
            out += [{"rows": rows(t), "C": t["C"], "stats": False}] * n
    return out


def work(l):
    R, C = l["rows"], l["C"]
    return 8.0 * R * C, BF16 * (2 * R * C + 2 * C) + (2 * FP32 * R if l["stats"] else 0)
