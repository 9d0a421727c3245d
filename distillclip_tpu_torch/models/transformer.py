"""The CLIP transformer stack.

Port of ``distillclip_tpu/models/transformer.py``: pre-LN attention and a 4x
QuickGELU MLP per block, on ``[B·seq, C]`` rows.  ``need_layers`` names the
layers whose taps a loss would read; with the default flags (the only ones
ported) nothing is collected, so it only fixes ``selected_layers``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import ClipMlp, InstrumentedAttention, LayerNorm
from distillclip_tpu_torch.models.outputs import ControlFlags


def clip_init_stds(width: int, layers: int) -> Tuple[float, float, float]:
    """CLIP's init scheme: (in_proj weight and bias, out_proj / c_proj, c_fc)
    standard deviations."""
    return width ** -0.5, (width ** -0.5) * ((2 * layers) ** -0.5), (2 * width) ** -0.5


def causal_mask(context_length: int, neg: float = -1e9) -> torch.Tensor:
    """Additive causal mask ``[ctx, ctx]`` fp32: ``neg`` above the diagonal,
    0 elsewhere.  The kernels mask by skipping the hidden keys instead; this
    is the JAX package's explicit form, for code that adds a mask to scores."""
    return torch.triu(torch.full((context_length, context_length), neg), diagonal=1)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, drop_prob: float = 0.0):
        super().__init__()
        self.attn = InstrumentedAttention(width, heads, drop_prob)
        self.mlp = ClipMlp(width)
        self.ln_1 = LayerNorm(width)
        self.ln_2 = LayerNorm(width)

    def forward(self, x: torch.Tensor, flags: ControlFlags, seq: int, causal: bool = False,
                kv_len: Optional[int] = None) -> torch.Tensor:
        x = x + self.attn(x, flags, self.ln_1, seq, causal, kv_len)
        return x + self.mlp(x, self.ln_2)


class Transformer(nn.Module):
    """``layers`` residual blocks; returns the hidden rows."""

    def __init__(self, width: int, layers: int, heads: int,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0):
        super().__init__()
        self.width, self.layers, self.heads = width, layers, heads
        self.need_layers = None if need_layers is None else tuple(need_layers)
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, drop_prob)
                                       for _ in range(layers))

    def selected_layers(self) -> Tuple[int, ...]:
        return tuple(range(self.layers)) if self.need_layers is None else self.need_layers

    def forward(self, x: torch.Tensor, flags: ControlFlags, seq: int, causal: bool = False,
                kv_len: Optional[int] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, flags, seq, causal, kv_len)
        return x
