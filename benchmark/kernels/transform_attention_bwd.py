"""#6, ``ops.transform_attention_bwd``: the backward of head-transform
attention from qkv, the mixes, the output gradient and the saved P, to dqkv
and the two mixes' gradients (fp32).  Its device work is the tensor-core
kernel and the pass that reduces the mixes' partial sums.

Least work from those inputs: five products of 2·B·H·N²·d (q·kᵀ, which P
does not hold; dP' = dO·vᵀ; dv = P'ᵀ·dO; dq; dk) and five head mixes of
2·B·H²·N² (P' = ww·P, which is not among the inputs; dww; dP; dwl; dS);
qkv, dO, P and the mixes read once, dqkv and the mixes' gradients written
once."""

from benchmark.kernels._shapes import BF16, FP32, MAX_SEQ, attention_shape, train_students

NAME = "transform_attention_bwd"
PATTERNS = ("tf_bwd_", "reduce_partials")


def launches(towers):
    return [attention_shape(t) for t in train_students(towers)
            if t["transform"] and t["N"] <= MAX_SEQ for _ in range(t["layers"])]


def work(l):
    B, N, H, d = l["B"], l["N"], l["H"], l["d"]
    flops = 5 * (2.0 * B * H * N * N * d) + 5 * (2.0 * B * H * H * N * N)
    read = BF16 * (3 * B * N * H * d + 2 * H * H + B * N * H * d + B * H * N * N)
    return flops, read + BF16 * 3 * B * N * H * d + FP32 * 2 * H * H
