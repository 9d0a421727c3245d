"""#13, ``ops.plain_attention_rows_qkv``: CLIP's attention without a
gradient on the fused qkv rows (the frozen teacher), causal in the text
tower, up to 256 tokens.

Least work: q·kᵀ and P·v, over the keys a query sees (about half under the
causal mask); qkv read once, the output written once."""

from benchmark.kernels._shapes import BF16, MAX_SEQ, attention_shape

NAME = "plain_attention_rows_qkv"
PATTERNS = ("plain_attention_mma_kernel",)


def launches(towers):
    return [attention_shape(t) for t in towers
            if t["kind"] == "clip" and t["N"] <= MAX_SEQ for _ in range(t["layers"])]


def work(l):
    B, N, H, d = l["B"], l["N"], l["H"], l["d"]
    seen = (N + 1) / (2.0 * N) if l["causal"] else 1.0
    return 2 * (2.0 * B * H * N * N * d) * seen, BF16 * 4 * B * N * H * d
