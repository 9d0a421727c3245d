"""Patch extraction and the CLIP vision transformer.

Port of ``distillclip_tpu/models/vit.py``.  The patch convolution is a reshape
(:func:`patchify`) plus one ``[P·P·C, width]`` product; the (ph, pw, c) flatten
order is the JAX package's, so its ``patch_kernel`` drops in as it is.

:class:`VisionTransformer` is the CLIP ViT (the teacher's image tower, or a
plain student): patches, class and positional embedding, ``ln_pre``, the
transformer stack, ``ln_post`` and ``proj`` on every token.  It runs on
``[B·N, C]`` rows at the true token count, with or without taps (the taps are
views or fp32 buffers beside the rows); the JAX tower's padding of N to a
multiple of 16 and its switch between rank-3 and rows mode are TPU layout
measures and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import LayerNorm
from distillclip_tpu_torch.models.outputs import ControlFlags, VisionOutput
from distillclip_tpu_torch.models.transformer import Transformer


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, (H/P)·(W/P), P·P·C]``."""
    B, H, W, C = images.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = images.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, P * P * C)


class VisionTransformer(nn.Module):
    """CLIP ViT; images are NHWC in the compute dtype.  Returns the projected
    class token as ``last_representation`` and every projected token as
    ``last_layer_output``."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 need_layers: Optional[Sequence[int]] = None, drop_prob: float = 0.0):
        super().__init__()
        self.input_resolution = input_resolution
        self.patch_size = patch_size
        self.width = width
        n_patches = (input_resolution // patch_size) ** 2
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * 3, width))
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_patches + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, need_layers, drop_prob)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> VisionOutput:
        B, H, W, _ = images.shape
        if H != self.input_resolution or W != self.input_resolution:
            raise ValueError(f"VisionTransformer(input_resolution={self.input_resolution}) "
                             f"got images of shape {tuple(images.shape)} (expected NHWC "
                             f"with H=W={self.input_resolution})")
        # conv1 as a patch product, no bias (CLIP's Conv2d has none)
        x = patchify(images, self.patch_size) @ self.patch_kernel.to(images.dtype)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        embedding = x if flags.need_emb else None
        N = x.shape[1]
        rows = self.ln_pre(x.reshape(B * N, self.width))
        t_out = self.transformer(rows, flags, N, generator=generator)
        projected = (self.ln_post(t_out.hidden) @ self.proj.to(rows.dtype)).view(B, N, -1)
        return VisionOutput(
            last_representation=projected[:, 0], last_layer_output=projected,
            attention_scores=t_out.attention_scores, attention_probs=t_out.attention_probs,
            representations=t_out.representations, value_map=t_out.value_map,
            embedding=embedding)
