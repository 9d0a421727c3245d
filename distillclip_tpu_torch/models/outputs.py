"""Static switches for what a forward returns, and the output containers.

Port of ``distillclip_tpu/models/outputs.py``.  :class:`ControlFlags` is the
counterpart of the reference's ControlOutput: a frozen set of booleans, fixed
for a whole training run, that tells every tower which taps to collect.  The
containers hold ``None`` where a tap is off.  Per-layer collections (attention
scores and probabilities, hidden representations) are stacked tensors with a
leading ``layers`` axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ControlFlags:
    need_emb: bool = False
    need_attn_score: bool = False
    need_value_map: bool = False
    need_attn_prob: bool = False
    need_rep: bool = False
    # full projected sequence (only the fine_grain loss reads it); without it
    # the weight-share towers pool first and run the final norm + head on one
    # row per sample
    need_last_layer: bool = False

    def any_tap(self) -> bool:
        """True if any per-layer instrumentation is requested."""
        return (self.need_emb or self.need_attn_score or self.need_value_map
                or self.need_attn_prob or self.need_rep)

    def attn_tap(self) -> bool:
        """True if the attention's inner state must be materialised."""
        return self.need_attn_score or self.need_attn_prob or self.need_value_map


@dataclasses.dataclass(frozen=True)
class AttentionOutput:
    """One attention layer's output."""

    hidden: torch.Tensor
    attention_scores: Optional[torch.Tensor] = None  # [B, H, N, N] pre-softmax (scaled)
    attention_probs: Optional[torch.Tensor] = None   # [B, H, N, N] post-softmax
    value_map: Optional[torch.Tensor] = None         # [B, H, N, N] softmax(V Vᵀ / sqrt(d))


@dataclasses.dataclass(frozen=True)
class TransformerOutput:
    """A transformer stack's output; the per-layer tensors hold the selected
    layers only."""

    hidden: torch.Tensor
    attention_scores: Optional[torch.Tensor] = None  # [L, B, H, N, N]
    attention_probs: Optional[torch.Tensor] = None   # [L, B, H, N, N]
    representations: Optional[torch.Tensor] = None   # [L, B, N, D]
    value_map: Optional[torch.Tensor] = None         # [B, H, N, N] (last selected layer)


@dataclasses.dataclass(frozen=True)
class VisionOutput:
    """Vision tower output: the cls representation ``[B, out_dim]``, the
    projected sequence ``[B, N, out_dim]`` (``[B, 1, out_dim]`` where a
    weight-share tower pooled first; None where no tower ran), and the taps."""

    last_representation: torch.Tensor
    last_layer_output: Optional[torch.Tensor] = None
    attention_scores: Optional[torch.Tensor] = None
    attention_probs: Optional[torch.Tensor] = None
    representations: Optional[torch.Tensor] = None
    value_map: Optional[torch.Tensor] = None
    embedding: Optional[torch.Tensor] = None  # [B, N, D] post-positional embeddings


@dataclasses.dataclass(frozen=True)
class TextOutput:
    """Text tower output: the EOT representation ``[B, out_dim]``, the
    projected sequence, and the taps."""

    last_representation: torch.Tensor
    last_layer_output: Optional[torch.Tensor] = None
    attention_scores: Optional[torch.Tensor] = None
    attention_probs: Optional[torch.Tensor] = None
    representations: Optional[torch.Tensor] = None
    value_map: Optional[torch.Tensor] = None
    embedding: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class CLIPOutput:
    """Both towers' outputs and the raw cosine logits (no logit scale)."""

    visual_output: VisionOutput
    text_output: TextOutput
    i2t_logits: torch.Tensor  # [B_img, B_txt] fp32
    t2i_logits: torch.Tensor  # [B_txt, B_img] fp32
