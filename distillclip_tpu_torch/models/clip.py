"""Dual-tower CLIP model producing cosine contrastive logits.

Port of ``distillclip_tpu/models/clip.py``.  Like the reference there is no
learnable logit scale: the i2t / t2i logits are raw cosine similarities.
:meth:`CLIPModel.score` is the L-CLIPScore fast path: both towers' unit
features and their cosines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.models.outputs import (
    CLIPOutput,
    ControlFlags,
    TextOutput,
    VisionOutput,
)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x|| in fp32 with no eps, like torch's ``x / x.norm(dim, keepdim=True)``.

    Port of ``distillclip_tpu/models/clip.py:24-29``; output in x's dtype."""
    x32 = x.float()
    return (x32 / x32.norm(dim=dim, keepdim=True)).to(x.dtype)


def cosine_logits(image_rep: torch.Tensor, text_rep: torch.Tensor) -> torch.Tensor:
    """[B_img, B_txt] fp32 logits: each side normalised in fp32 and rounded to
    its own dtype (as the JAX package rounds it), the product summed in fp32."""
    return l2_normalize(image_rep).float() @ l2_normalize(text_rep).float().t()


class CLIPModel(nn.Module):
    """Dual tower wrapper.  ``image_tower`` and ``text_tower`` are weight-share
    students, which return their pooled representation as a tensor, or plain
    CLIP encoders, whose output containers pass through unchanged."""

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module):
        super().__init__()
        self.image_tower = image_tower
        self.text_tower = text_tower

    def encode_image(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                     generator: Optional[torch.Generator] = None):
        out = self.image_tower(images, flags, generator)
        return out if isinstance(out, VisionOutput) else VisionOutput(last_representation=out)

    def encode_text(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags(),
                    generator: Optional[torch.Generator] = None):
        out = self.text_tower(tokens, flags, generator)
        return out if isinstance(out, TextOutput) else TextOutput(last_representation=out)

    def forward(self, tokens: torch.Tensor, images: torch.Tensor,
                flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> CLIPOutput:
        """``generator`` feeds the towers' dropout and drop-path in training
        mode, the image tower first."""
        visual_output = self.encode_image(images, flags, generator)
        text_output = self.encode_text(tokens, flags, generator)
        logits = cosine_logits(visual_output.last_representation,
                               text_output.last_representation)
        return CLIPOutput(visual_output=visual_output, text_output=text_output,
                          i2t_logits=logits, t2i_logits=logits.t())

    def score(self, tokens: torch.Tensor,
              images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(image features, text features, cosine logits ``[B_img, B_txt]`` fp32)."""
        image_feature = l2_normalize(self.encode_image(images).last_representation)
        text_feature = l2_normalize(self.encode_text(tokens).last_representation)
        return image_feature, text_feature, image_feature.float() @ text_feature.float().t()
