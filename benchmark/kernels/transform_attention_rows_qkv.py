"""K3, ``ops.transform_attention_rows_qkv``: head-transform attention forward
without a gradient (the students' serving path).

Least work: q·kᵀ and P'·v and the two head mixes; qkv and the mixes read
once, the output written once."""

from benchmark.kernels._shapes import BF16, MAX_SEQ, attention_shape

NAME = "transform_attention_rows_qkv"
PATTERNS = ("tf_fwd_mma_kernel",)


def launches(towers):
    return [attention_shape(t) for t in towers
            if t["kind"] == "student" and t["mode"] == "lean" and t["transform"]
            and t["N"] <= MAX_SEQ for _ in range(t["layers"])]


def work(l):
    B, N, H, d = l["B"], l["N"], l["H"], l["d"]
    flops = 2 * (2.0 * B * H * N * N * d) + 2 * (2.0 * B * H * H * N * N)
    return flops, BF16 * (3 * B * N * H * d + 2 * H * H + B * N * H * d)
