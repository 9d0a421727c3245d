"""#5, ``ops.transform_attention_save_p``: head-transform attention forward
under a gradient, on the fused qkv rows, saving the softmax probabilities P
for the backward (the students' attention in a train step).

Least work: q·kᵀ and P'·v (2·B·H·N²·d each) and the two head mixes
(2·B·H²·N² each); qkv and the mixes read once, the output and P written
once."""

from benchmark.kernels._shapes import BF16, MAX_SEQ, attention_shape, train_students

NAME = "transform_attention_save_p"
PATTERNS = ("tf_fwd_mma_kernel",)


def launches(towers):
    return [attention_shape(t) for t in train_students(towers)
            if t["transform"] and t["N"] <= MAX_SEQ for _ in range(t["layers"])]


def work(l):
    B, N, H, d = l["B"], l["N"], l["H"], l["d"]
    flops = 2 * (2.0 * B * H * N * N * d) + 2 * (2.0 * B * H * H * N * N)
    return flops, BF16 * (3 * B * N * H * d + 2 * H * H + B * N * H * d + B * H * N * N)
