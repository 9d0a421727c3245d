"""Encoder wrappers around the CLIP towers.

Port of ``distillclip_tpu/models/encoders.py``: :class:`ImageEncoder` holds a
:class:`VisionTransformer` as ``visual``, :class:`TextEncoder` a
:class:`TextTransformer` as ``text``.  With ``is_student=False`` they are the
teacher's towers; with ``is_student=True`` plain CLIP-architecture students.

A student whose width differs from the teacher's projects its hidden
representations and its post-positional embedding to the teacher's width
(``hidden_projection``, ``embedding_projection``).  The JAX package creates
those parameters only when the tap that feeds them is on (``need_rep``,
``need_emb``), so the port builds each under the constructor's
``project_hidden`` / ``project_embedding`` switch, which the caller sets from
the flags the task will run with (:func:`projections_for`); both parameter
trees then hold the same leaves.  Masked score entries (the additive -1e9) are
zeroed before the scores reach a loss (:func:`clean_masked_scores`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense
from distillclip_tpu_torch.models.outputs import ControlFlags, TextOutput, VisionOutput
from distillclip_tpu_torch.models.text import TextTransformer
from distillclip_tpu_torch.models.vit import VisionTransformer

_MASK_CLEAN_THRESHOLD = -1e8


def clean_masked_scores(scores: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Zero the additive-mask entries of attention scores ``[L, B, H, N, N]``."""
    if scores is None:
        return None
    return torch.where(scores <= _MASK_CLEAN_THRESHOLD, torch.zeros_like(scores), scores)


def projections_for(flags: ControlFlags) -> dict:
    """The constructor switches that give an encoder the projection leaves the
    JAX package would create under ``flags``."""
    return {"project_hidden": flags.need_rep, "project_embedding": flags.need_emb}


class _Encoder(nn.Module):
    """The width projections and the score clean-up both encoders share."""

    def _build_projections(self, is_student: bool, width: int, teacher_width: Optional[int],
                           project_hidden: bool, project_embedding: bool) -> None:
        self.is_student = is_student
        self.teacher_width = teacher_width
        project = is_student and teacher_width is not None and teacher_width != width
        if project and project_hidden:
            self.hidden_projection = Dense(width, teacher_width)
        if project and project_embedding:
            self.embedding_projection = Dense(width, teacher_width)

    def _finish(self, out, flags: ControlFlags):
        reps, emb = out.representations, out.embedding
        if reps is not None and hasattr(self, "hidden_projection"):
            reps = self.hidden_projection(reps)
        if emb is not None and hasattr(self, "embedding_projection"):
            emb = self.embedding_projection(emb)
        return dataclasses.replace(
            out, representations=reps, embedding=emb,
            attention_scores=clean_masked_scores(out.attention_scores)
            if flags.need_attn_score else None)


class ImageEncoder(_Encoder):
    def __init__(self, is_student: bool, input_resolution: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0,
                 teacher_width: Optional[int] = None, project_hidden: bool = False,
                 project_embedding: bool = False):
        super().__init__()
        self._build_projections(is_student, width, teacher_width, project_hidden,
                                project_embedding)
        self.visual = VisionTransformer(input_resolution, patch_size, width, layers, heads,
                                        output_dim, need_layers, drop_prob)

    @property
    def selected_layers(self) -> Tuple[int, ...]:
        return self.visual.transformer.selected_layers()

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> VisionOutput:
        return self._finish(self.visual(images, flags, generator), flags)


class TextEncoder(_Encoder):
    def __init__(self, is_student: bool, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0,
                 compression_embedding: bool = False, embedding_compression_dim: int = 256,
                 teacher_width: Optional[int] = None, project_hidden: bool = False,
                 project_embedding: bool = False):
        super().__init__()
        self._build_projections(is_student, width, teacher_width, project_hidden,
                                project_embedding)
        self.text = TextTransformer(vocab_size, context_length, width, layers, heads,
                                    output_dim, need_layers, drop_prob,
                                    compression_embedding, embedding_compression_dim)

    @property
    def selected_layers(self) -> Tuple[int, ...]:
        return self.text.transformer.selected_layers()

    def forward(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> TextOutput:
        return self._finish(self.text(tokens, flags, generator), flags)
