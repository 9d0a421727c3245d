"""Model FLOPs of a step or a scored pair, from the configuration's shapes.

Every product the forward needs counts 2 FLOPs a multiply-add; nothing
recomputed counts.  A trainable tower adds the products of its backward: the
gradient of each product's inputs and of its weights, each as costly as the
forward product, but not the gradient of the pixels (the patch embedding's
input).  A frozen tower counts its forward only.  Normalisation, activations
and softmax are not products and do not count.

A tower is described by its geometry (``towers`` in the builders): ``N``
tokens of width ``C`` in ``H`` heads of ``d``, ``layers`` logical layers with
an MLP of ``mlp`` hidden units, head mixes when ``transform``, the patch
product's input width ``embed_in`` (0 for a text tower: a lookup), and the
pooled head ``C`` -> ``out_dim``.
"""

from __future__ import annotations


def forward_flops(t: dict) -> tuple:
    """(a sample's forward FLOPs, the patch product's share of them)."""
    N, C, H, d = t["N"], t["C"], t["H"], t["d"]
    layer = 2 * N * C * 3 * C + 2 * N * C * C + 2 * 2 * N * C * t["mlp"]
    layer += 2 * 2 * H * N * N * d                       # q·kᵀ and P·v
    if t["transform"]:
        layer += 2 * 2 * H * H * N * N                   # the two head mixes
    embed = 2 * (N - 1) * t["embed_in"] * C
    return embed + t["layers"] * layer + 2 * C * t["out_dim"], embed


def tower_flops(t: dict) -> float:
    """A sample's FLOPs in a step: 3 x the forward less the pixels' gradient
    when trainable, the forward when frozen or serving."""
    fwd, embed = forward_flops(t)
    return 3 * fwd - embed if t["mode"] == "train" else fwd


def pair_flops(towers: list, extra: float = 0.0) -> float:
    return sum(tower_flops(t) for t in towers) + extra
