"""Token embedding and EOT pooling for the text towers.

Port of ``TokenEmbedding`` and ``eot_pool`` (``distillclip_tpu/models/text.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense


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
