"""The CLIP transformer stack.

Port of ``distillclip_tpu/models/transformer.py``: pre-LN attention and a 4x
QuickGELU MLP per block, on ``[B·seq, C]`` rows.  ``need_layers`` names the
layers whose taps a loss reads: only their hidden states, scores and
probabilities are collected, stacked on a leading axis (the student's few
layers against, say, the teacher's [0, 1, 10, 11]); the value map is the last
selected layer's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.config.perf import perf_knobs, require_kernels
from distillclip_tpu_torch.models.layers import ClipMlp, InstrumentedAttention, LayerNorm
from distillclip_tpu_torch.models.outputs import (
    AttentionOutput,
    ControlFlags,
    TransformerOutput,
)


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
                kv_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> AttentionOutput:
        """``hidden`` is the block's output rows; the taps are the attention's."""
        attn_out = self.attn(x, flags, self.ln_1, seq, causal, kv_len, generator)
        x = x + attn_out.hidden
        return dataclasses.replace(attn_out, hidden=x + self.mlp(x, self.ln_2))


def _stack_or_none(items: list) -> Optional[torch.Tensor]:
    if not items or any(i is None for i in items):
        return None
    return torch.stack(items, dim=0)


class Transformer(nn.Module):
    """``layers`` residual blocks collecting taps for ``need_layers`` only."""

    def __init__(self, width: int, layers: int, heads: int,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0):
        super().__init__()
        self.width, self.layers, self.heads = width, layers, heads
        self.need_layers = None if need_layers is None else tuple(need_layers)
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, drop_prob)
                                       for _ in range(layers))
        self.perf = perf_knobs()

    def selected_layers(self) -> Tuple[int, ...]:
        return tuple(range(self.layers)) if self.need_layers is None else self.need_layers

    def forward(self, x: torch.Tensor, flags: ControlFlags, seq: int, causal: bool = False,
                kv_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> TransformerOutput:
        """``hidden`` stays ``[B·seq, C]`` rows; ``representations`` are
        ``[L, B, seq, C]`` views of the selected layers' rows."""
        if x.is_cuda:
            require_kernels(self.perf, x.device)
        selected = set(self.selected_layers())
        scores, probs, reps = [], [], []
        value_map = None
        for i, block in enumerate(self.resblocks):
            out = block(x, flags, seq, causal, kv_len, generator)
            x = out.hidden
            if i not in selected:
                continue
            if flags.need_rep:
                reps.append(x.view(-1, seq, self.width))
            if flags.need_attn_score:
                scores.append(out.attention_scores)
            if flags.need_attn_prob:
                probs.append(out.attention_probs)
            value_map = out.value_map     # only the last selected layer's is kept
        return TransformerOutput(
            hidden=x, attention_scores=_stack_or_none(scores),
            attention_probs=_stack_or_none(probs), representations=_stack_or_none(reps),
            value_map=value_map)
