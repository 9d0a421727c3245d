"""ViTKD loss, the only distillation loss with trainable parameters.

Port of ``distillclip_tpu/losses/vit_kd.py`` (ViTKD: feature distillation for
ViTs).  Low layers are mimicked: a per-layer Linear alignment (only when the
student's width differs from the teacher's) and a summed squared error.  High
layers are generated: random token masking, a learned mask token, two 3×3
convolutions over the ``hw × hw`` patch grid, and a squared error on the
masked tokens.  The parameters live in the train state beside the student's,
under ``loss_aux``.

The token grid goes through the convolutions as NCHW (``[B, D, hw, hw]``),
where the JAX package has NHWC and kernels ``[3, 3, in, out]``;
``convert.jax_loss_aux_to_torch`` transposes them (the align layers are the
port's ``Dense``, ``[in, out]`` like Flax's, and need no transpose).  The convolutions are fp32
library calls and follow ``torch.backends.cudnn.allow_tf32`` (on by default on
the card: about three decimal digits in their operands); a run that is held
to the CPU path switches it off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense


def random_masking(x: torch.Tensor, mask_ratio: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample random masking of ``[B, N, D]`` tokens: the ``[B, N]`` mask
    in x's dtype, 1 for a removed token, in the original token order.  Each
    sample keeps a uniformly random subset of exactly ``int(N·(1 - ratio))``
    tokens (the rank of a token's uniform noise decides)."""
    B, N, _ = x.shape
    len_keep = int(N * (1 - mask_ratio))
    noise = torch.rand((B, N), device=x.device, generator=generator)
    ranks = noise.argsort(dim=1).argsort(dim=1)
    return (ranks >= len_keep).to(x.dtype)


class ViTKDLoss(nn.Module):
    """ViTKD with align linears, mask token and the conv generation head."""

    def __init__(self, student_dims: int, teacher_dims: int, alpha_vitkd: float = 0.00003,
                 beta_vitkd: float = 0.000003, lambda_vitkd: float = 0.5,
                 low_layers_num: int = 2, high_layers_num: int = 1):
        super().__init__()
        self.student_dims, self.teacher_dims = student_dims, teacher_dims
        self.alpha_vitkd, self.beta_vitkd = alpha_vitkd, beta_vitkd
        self.lambda_vitkd = lambda_vitkd
        self.low_layers_num, self.high_layers_num = low_layers_num, high_layers_num
        if student_dims != teacher_dims:
            self.align_low = nn.ModuleList(Dense(student_dims, teacher_dims)
                                           for _ in range(low_layers_num))
            self.align_high = nn.ModuleList(Dense(student_dims, teacher_dims)
                                            for _ in range(high_layers_num))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, teacher_dims))
        conv = lambda: nn.Conv2d(teacher_dims, teacher_dims, kernel_size=3, padding=1)
        self.generation_conv1 = nn.ModuleList(conv() for _ in range(high_layers_num))
        self.generation_conv2 = nn.ModuleList(conv() for _ in range(high_layers_num))

    def forward(self, preds_s: Sequence[torch.Tensor], preds_t: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``preds_s`` / ``preds_t``: [low ``[B, low_n, N, D]``, high
        ``[B, high_n, N, D]``].  ``masks`` gives each high layer's ``[B, N-1]``
        mask instead of drawing it from ``generator``."""
        low_s, high_s = preds_s
        low_t, high_t = preds_t
        B = low_s.shape[0]
        need_align = self.student_dims != self.teacher_dims

        # mimicking
        low_x = low_s.float()
        if need_align:
            low_x = torch.stack([self.align_low[i](low_x[:, i])
                                 for i in range(self.low_layers_num)], dim=1)
        loss_lr = (low_x - low_t.float()).square().sum() / B * self.alpha_vitkd

        # generation
        loss_gen = 0.0
        for i in range(self.high_layers_num):
            x = high_s[:, i].float()
            if need_align:
                x = self.align_high[i](x)
            x, tea = x[:, 1:], high_t[:, i].float()[:, 1:]        # without the cls token
            Bi, N, D = x.shape
            mask = (random_masking(x, self.lambda_vitkd, generator) if masks is None
                    else masks[i].to(x.dtype))
            m = mask[:, :, None]
            x = torch.where(m > 0, self.mask_token.to(x.dtype), x)
            hw = int(N ** 0.5)
            g = x.view(Bi, hw, hw, D).permute(0, 3, 1, 2)
            g = self.generation_conv2[i](torch.relu(self.generation_conv1[i](g)))
            g = g.permute(0, 2, 3, 1).reshape(Bi, N, D)
            l_gen = (g * m - tea * m).square().sum()
            loss_gen = loss_gen + l_gen / Bi * self.beta_vitkd / self.lambda_vitkd
        return loss_lr + loss_gen / self.high_layers_num
