"""EVA-02-CLIP's vision tower, a frozen image teacher.

EVA-CLIP (arXiv:2303.15389) with EVA-02's block (arXiv:2303.11331), as
``EVA-CLIP/rei/eva_clip/eva_vit_model.py`` and ``rope.py`` of
baaivision/EVA build it for ``EVA02-CLIP-L-14.json`` (224 px, patch 14, width
1024, 24 layers, 16 heads of 64, SwiGLU hidden ``int(1024 · 2.6667)`` = 2730,
output 768).  LayerNorm ε = 1e-6 throughout, no ``ln_pre``, no layer scale:

* embedding: ``x = [cls; conv(img) + b] + pos_embed``;
* attention: ``x ← x + proj(LN_inner(attn(q, k, v)))``, q, k, v from
  ``LN_1(x)`` (k without a bias), the 2-D rotary embedding on the patch rows
  of q and k (:func:`rope_table`), scale d^-0.5, no mask;
* MLP: ``x ← x + w3(LN_ffn(silu(LN_2(x)·W1 + b1) ⊙ (LN_2(x)·W2 + b2)))``;
* head: ``LN(x)[cls] · W_head + b_head``.

The blocks run on ``[B·N, C]`` rows through EVA-02's modes of the LN GEMM
(``ops.fc1_act``): ``LN_1`` + fused qkv + rotary is :func:`ops.dense_ln_rope`;
attention is #13 (:func:`ops.plain_attention_rows_qkv`) up to 256 tokens,
the towers' gate (:func:`layers.attention_kernel_ok`), and the long-row kernel
:func:`ops.plain_attention_long` past it, as at 257 (the tower has no JAX
counterpart, so nothing holds it to the JAX towers' materialised attention);
``LN_inner`` + ``proj`` is :func:`ops.dense_ln` (K1); ``LN_2`` + ``[W1 | W2]``
+ SwiGLU is :func:`ops.dense_swiglu_ln`; ``LN_ffn`` + ``w3`` is
:func:`ops.dense_ln_width` at the hidden width padded to a multiple of 32 (the
kernels' tiles), the moments over the true width.  The padding is exact:
the pad columns of ``[W1 | W2]`` and their biases are zero, so SwiGLU gives
silu(0)·0 = 0 there, and ``LN_ffn``'s γ, β and ``w3``'s rows are zero past the
true width.  Departure: the rotary turn acts on the fp32 sums before the one
bf16 rounding of q and k; EVA rounds them, turns, and rounds again.

Forward only, without taps (no hidden states, scores or probabilities): a
loss that reads the teacher's taps raises.  The text tower is not built.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense, LayerNorm, attention_kernel_ok
from distillclip_tpu_torch.models.outputs import ControlFlags, VisionOutput
from distillclip_tpu_torch.models.vit import patchify
from distillclip_tpu_torch.ops import (
    dense_ln,
    dense_ln_rope,
    dense_ln_width,
    dense_swiglu_ln,
    plain_attention_long,
    plain_attention_rows_qkv,
)

EPS = 1e-6
# EVA-02-CLIP's pt_hw_seq_len: the grid the rotary frequencies are laid on,
# 16 in every EVA-02-CLIP configuration
PT_GRID = 16
THETA = 10000.0


def padded(width: int) -> int:
    """The hidden width padded to the kernels' multiple of 32."""
    return -(-width // 32) * 32


def rope_table(grid: int, head_dim: int, pt_grid: int = PT_GRID,
               theta: float = THETA) -> torch.Tensor:
    """(cos, sin) fp32 ``[grid², head_dim / 2, 2]``: the angle of patch p =
    grid·r + c at pair i is r·f_i for i < head_dim / 4 and c·f_(i - head_dim/4)
    past it, f_i = θ^(-4i / head_dim), the positions r, c scaled by
    pt_grid / grid (``VisionRotaryEmbeddingFast``: frequencies over dim =
    head_dim / 2, repeated over each pair, rows' then columns')."""
    dim = head_dim // 2
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2)[:dim // 2].float() / dim)
    t = torch.arange(grid).float() / grid * pt_grid
    f = t[:, None] * freqs[None, :]                                  # [grid, dim / 2]
    rows = f[:, None, :].expand(grid, grid, dim // 2)
    cols = f[None, :, :].expand(grid, grid, dim // 2)
    angle = torch.cat([rows, cols], dim=-1).reshape(grid * grid, dim)
    return torch.stack([angle.cos(), angle.sin()], dim=-1)


def _attend(qkv: torch.Tensor, heads: int, seq: int) -> torch.Tensor:
    """Attention of the fused rows, by the sequence length: #13 up to 256
    tokens, the long-row kernel past it."""
    if attention_kernel_ok(ControlFlags(), seq, False):
        return plain_attention_rows_qkv(qkv, heads=heads, seq=seq)
    return plain_attention_long(qkv, heads=heads, seq=seq)


class EvaBlock(nn.Module):
    """EVA-02's block on ``[B·seq, width]`` rows.  ``qkv`` is the fused
    ``[q | k | v]`` (k's bias zero), ``w12`` the interleaved ``[W1 | W2]``
    over the padded hidden width, ``ffn_ln`` and ``w3`` over the padded width
    (zero past ``hidden``)."""

    def __init__(self, width: int, heads: int, hidden: int):
        super().__init__()
        self.heads, self.hidden = heads, hidden
        hp = padded(hidden)
        self.norm1 = LayerNorm(width, EPS)
        self.qkv = Dense(width, 3 * width)
        self.inner_attn_ln = LayerNorm(width, EPS)
        self.proj = Dense(width, width)
        self.norm2 = LayerNorm(width, EPS)
        self.w12 = Dense(width, 2 * hp)
        self.ffn_ln = LayerNorm(hp, EPS)
        self.w3 = Dense(hp, width)

    def forward(self, x: torch.Tensor, seq: int, rope: torch.Tensor) -> torch.Tensor:
        width = x.shape[1]
        qkv = dense_ln_rope(x, self.norm1.scale, self.norm1.bias, self.qkv.kernel,
                            self.qkv.bias, rope, seq, width // self.heads, 2 * width, EPS)
        o = _attend(qkv, self.heads, seq)
        x = x + dense_ln(o, self.inner_attn_ln.scale, self.inner_attn_ln.bias,
                         self.proj.kernel, self.proj.bias, EPS)
        h = dense_swiglu_ln(x, self.norm2.scale, self.norm2.bias, self.w12.kernel,
                            self.w12.bias, EPS)
        return x + dense_ln_width(h, self.ffn_ln.scale, self.ffn_ln.bias, self.w3.kernel,
                                  self.w3.bias, self.hidden, EPS)


class EvaVisionTransformer(nn.Module):
    """EVA-02-CLIP's vision tower; images NHWC in the compute dtype, the
    projected class row out."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, hidden: int = 2730, output_dim: int = 768,
                 pt_grid: int = PT_GRID):
        super().__init__()
        self.input_resolution, self.patch_size, self.width = input_resolution, patch_size, width
        grid = input_resolution // patch_size
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * 3, width))
        self.patch_bias = nn.Parameter(torch.zeros(width))
        self.cls_token = nn.Parameter(torch.empty(width))
        self.pos_embed = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.blocks = nn.ModuleList(EvaBlock(width, heads, hidden) for _ in range(layers))
        self.norm = LayerNorm(width, EPS)
        self.head = Dense(width, output_dim)
        self.register_buffer("rope", rope_table(grid, width // heads, pt_grid), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        if H != self.input_resolution or W != self.input_resolution:
            raise ValueError(f"EvaVisionTransformer(input_resolution={self.input_resolution}) "
                             f"got images of shape {tuple(images.shape)} (NHWC)")
        dt = images.dtype
        x = patchify(images, self.patch_size) @ self.patch_kernel.to(dt) + self.patch_bias.to(dt)
        cls = self.cls_token.to(dt).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        N = x.shape[1]
        rows = x.reshape(B * N, self.width)
        for block in self.blocks:
            rows = block(rows, N, self.rope)
        cls_rows = self.norm(rows.view(B, N, self.width)[:, 0].contiguous())
        return self.head(cls_rows)


class EvaImageEncoder(nn.Module):
    """The frozen image teacher of an EVA-02-CLIP checkpoint: ``visual`` is
    its :class:`EvaVisionTransformer`.  It returns the last representation
    only; flags that ask for taps raise."""

    def __init__(self, **geometry):
        super().__init__()
        self.visual = EvaVisionTransformer(**geometry)

    @property
    def selected_layers(self):
        return ()

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> VisionOutput:
        if flags.any_tap():
            raise ValueError(
                f"the EVA-02-CLIP teacher returns its last representation only; the loss asks "
                f"for taps ({flags}): hidden states, attention scores, probabilities, value "
                f"maps and embeddings of its blocks are not built")
        return VisionOutput(last_representation=self.visual(images))


# -- EVA-CLIP's checkpoint layout ---------------------------------------------------


def is_eva_state_dict(sd: Dict[str, torch.Tensor]) -> bool:
    return "visual.blocks.0.attn.q_proj.weight" in sd


def eva_visual_para(sd: Dict[str, torch.Tensor]) -> dict:
    """The tower's geometry from an EVA-CLIP state dict (64-wide heads, as
    EVA-02-CLIP's ``head_width``)."""
    width = sd["visual.cls_token"].shape[-1]
    patch = sd["visual.patch_embed.proj.weight"].shape[-1]
    grid = round((sd["visual.pos_embed"].shape[-2] - 1) ** 0.5)
    return {
        "input_resolution": patch * grid, "patch_size": patch, "width": width,
        "layers": len([k for k in sd if k.startswith("visual.blocks.")
                       and k.endswith(".attn.q_proj.weight")]),
        "heads": width // 64, "hidden": sd["visual.blocks.0.mlp.w1.weight"].shape[0],
        "output_dim": sd["visual.head.weight"].shape[0],
    }


def _pad_to(t: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` and ``[..., n]`` -> ``[..., 2n]``: a's column j at 2j, b's at 2j + 1."""
    return torch.stack([a, b], dim=-1).flatten(-2)


def map_eva_visual_weights(sd: Dict[str, torch.Tensor], layers: int) -> Dict[str, torch.Tensor]:
    """``visual.*`` keys of an EVA-CLIP checkpoint -> an
    :class:`EvaVisionTransformer`'s state dict: q, k, v fused into one
    ``[C, 3C]`` kernel with a zero k bias; W1, W2 interleaved by columns;
    the hidden width padded with zeros to a multiple of 32 (``[W1 | W2]``'s
    columns and biases, ``LN_ffn``'s γ and β, ``w3``'s rows).  Linear
    weights ``[out, in]`` become kernels ``[in, out]``."""
    v = lambda k: sd[f"visual.{k}"]
    conv = v("patch_embed.proj.weight")                      # [O, I, P, P]
    O, I, P, _ = conv.shape
    out = {"patch_kernel": conv.permute(2, 3, 1, 0).reshape(P * P * I, O),
           "patch_bias": v("patch_embed.proj.bias"),
           "cls_token": v("cls_token").reshape(-1), "pos_embed": v("pos_embed").reshape(-1, O),
           "norm.scale": v("norm.weight"), "norm.bias": v("norm.bias"),
           "head.kernel": v("head.weight").t(), "head.bias": v("head.bias")}
    for i in range(layers):
        s, d = f"blocks.{i}.", f"blocks.{i}."
        hidden = v(s + "mlp.w1.weight").shape[0]
        hp = padded(hidden)
        q_bias = v(s + "attn.q_bias")
        for src, dst in (("norm1", "norm1"), ("attn.inner_attn_ln", "inner_attn_ln"),
                         ("norm2", "norm2")):
            out[d + dst + ".scale"], out[d + dst + ".bias"] = (v(f"{s}{src}.weight"),
                                                             v(f"{s}{src}.bias"))
        out[d + "qkv.kernel"] = torch.cat([v(s + f"attn.{n}_proj.weight").t()
                                           for n in "qkv"], dim=1)
        out[d + "qkv.bias"] = torch.cat([q_bias, torch.zeros_like(q_bias), v(s + "attn.v_bias")])
        out[d + "proj.kernel"], out[d + "proj.bias"] = (v(s + "attn.proj.weight").t(),
                                                      v(s + "attn.proj.bias"))
        out[d + "w12.kernel"] = interleave(_pad_to(v(s + "mlp.w1.weight").t(), hp, 1),
                                           _pad_to(v(s + "mlp.w2.weight").t(), hp, 1))
        out[d + "w12.bias"] = interleave(_pad_to(v(s + "mlp.w1.bias"), hp, 0),
                                         _pad_to(v(s + "mlp.w2.bias"), hp, 0))
        out[d + "ffn_ln.scale"] = _pad_to(v(s + "mlp.ffn_ln.weight"), hp, 0)
        out[d + "ffn_ln.bias"] = _pad_to(v(s + "mlp.ffn_ln.bias"), hp, 0)
        out[d + "w3.kernel"] = _pad_to(v(s + "mlp.w3.weight").t(), hp, 0)
        out[d + "w3.bias"] = v(s + "mlp.w3.bias")
    return {k: t.contiguous().clone() for k, t in out.items()}

