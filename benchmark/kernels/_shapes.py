"""Byte sizes the kernels' work functions share."""

BF16, FP32 = 2, 4
# the kernels take sequences up to this length; past it the towers
# materialise the attention in plain PyTorch (no kernel launch)
MAX_SEQ = 256


def rows(t: dict) -> int:
    return t["B"] * t["N"]


def train_students(towers):
    return [t for t in towers if t["kind"] == "student" and t["mode"] == "train"]


def lean_towers(towers):
    return [t for t in towers if t["mode"] == "lean"]


def attention_shape(t: dict) -> dict:
    return {"B": t["B"], "N": t["N"], "H": t["H"], "d": t["d"], "causal": t["causal"]}
