"""Encoder wrappers around the CLIP towers.

Port of ``distillclip_tpu/models/encoders.py``: :class:`ImageEncoder` holds a
:class:`VisionTransformer` as ``visual``, :class:`TextEncoder` a
:class:`TextTransformer` as ``text``.  With ``is_student=False`` they are the
teacher's towers; with ``is_student=True`` plain CLIP-architecture students.

The student-only width projections (``hidden_projection``,
``embedding_projection``) and the score clean-up act only on taps, and the JAX
package creates their parameters only when a tap is on.  The port runs the
default flags only, so it builds neither and both parameter trees hold the
same leaves.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.models.outputs import ControlFlags, TextOutput, VisionOutput
from distillclip_tpu_torch.models.text import TextTransformer
from distillclip_tpu_torch.models.vit import VisionTransformer


class ImageEncoder(nn.Module):
    def __init__(self, is_student: bool, input_resolution: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0,
                 teacher_width: Optional[int] = None):
        super().__init__()
        self.is_student = is_student
        self.teacher_width = teacher_width
        self.visual = VisionTransformer(input_resolution, patch_size, width, layers, heads,
                                        output_dim, need_layers, drop_prob)

    @property
    def selected_layers(self) -> Tuple[int, ...]:
        return self.visual.transformer.selected_layers()

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags()) -> VisionOutput:
        return self.visual(images, flags)


class TextEncoder(nn.Module):
    def __init__(self, is_student: bool, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0,
                 compression_embedding: bool = False, embedding_compression_dim: int = 256,
                 teacher_width: Optional[int] = None):
        super().__init__()
        self.is_student = is_student
        self.teacher_width = teacher_width
        self.text = TextTransformer(vocab_size, context_length, width, layers, heads,
                                    output_dim, need_layers, drop_prob,
                                    compression_embedding, embedding_compression_dim)

    @property
    def selected_layers(self) -> Tuple[int, ...]:
        return self.text.transformer.selected_layers()

    def forward(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags()) -> TextOutput:
        return self.text(tokens, flags)
