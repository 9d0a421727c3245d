"""Token embedding, EOT pooling and the CLIP text transformer.

Port of ``distillclip_tpu/models/text.py``.  :class:`TextTransformer` is the
CLIP text tower (the teacher's, or a plain student): token and positional
embedding, the causal transformer stack, ``ln_final``, ``text_projection`` on
every token, then the EOT pool.  It runs on ``[B·N, C]`` rows at N = the
context length; the JAX tower pads N to a multiple of 16 and masks the pad
keys, which is the same math.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense, LayerNorm
from distillclip_tpu_torch.models.outputs import ControlFlags, TextOutput
from distillclip_tpu_torch.models.transformer import Transformer


def eot_pool(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The feature at the EOT position of each row: ``[B, N, D] -> [B, D]``.

    EOT is the largest token id, so its position is ``argmax(tokens)`` (the
    first one on a tie), as in the reference."""
    idx = tokens.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class Embed(nn.Module):
    """A ``[vocab, dim]`` lookup table named ``embedding`` (Flax's Embed)."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.embedding)


class TokenEmbedding(nn.Module):
    """Token embedding, optionally factorised (compression):
    ``Embed(vocab, compression_dim) -> Dense(compression_dim, width)``."""

    def __init__(self, vocab_size: int, width: int, compression: bool = False,
                 compression_dim: int = 256):
        super().__init__()
        self.embed = Embed(vocab_size, compression_dim if compression else width)
        self.expand = Dense(compression_dim, width) if compression else None

    def forward(self, tokens: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype`` is the compute dtype of the gathered rows.  The vocab table
        stays fp32 (see ``serving.inputs.cast_to_compute``) and only the rows
        looked up are cast, which equals gathering from a cast table."""
        emb = self.embed(tokens)
        if dtype is not None:
            emb = emb.to(dtype)
        if self.expand is not None:
            emb = self.expand(emb)
        return emb


class TextTransformer(nn.Module):
    """CLIP text tower.  Like the reference it projects every token
    (``last_layer_output``) and pools the projected sequence at the EOT."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0,
                 compression_embedding: bool = False, embedding_compression_dim: int = 256):
        super().__init__()
        self.context_length = context_length
        self.width = width
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.token_embedding = TokenEmbedding(vocab_size, width, compression_embedding,
                                              embedding_compression_dim)
        self.transformer = Transformer(width, layers, heads, need_layers, drop_prob)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> TextOutput:
        # the positional embedding's dtype is the tower's compute dtype; the
        # vocab table stays fp32 and only the gathered rows are cast
        x = self.token_embedding(tokens, dtype=self.positional_embedding.dtype)
        x = x + self.positional_embedding.to(x.dtype)
        embedding = x if flags.need_emb else None
        B, N, _ = x.shape
        t_out = self.transformer(x.reshape(B * N, self.width), flags, N, causal=True,
                                 generator=generator)
        projected = self.ln_final(t_out.hidden) @ self.text_projection.to(x.dtype)
        projected = projected.view(B, N, -1)
        return TextOutput(
            last_representation=eot_pool(projected, tokens), last_layer_output=projected,
            attention_scores=t_out.attention_scores, attention_probs=t_out.attention_probs,
            representations=t_out.representations, value_map=t_out.value_map,
            embedding=embedding)
