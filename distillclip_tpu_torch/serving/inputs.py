"""Request normalisation and the compute-dtype cast of the weights.

Ports of ``prepare_inputs`` and ``cast_to_compute``
(``distillclip_tpu/training/train_state.py:148-193``), matched exactly so that
the bf16 scorer agrees with the JAX one.
"""

from __future__ import annotations

import torch
from torch import nn

# CLIP's pixel statistics, from distillclip_tpu/data/transforms.py:21-22.
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# 2D parameters with at least this many rows (the vocab embedding table) stay
# fp32; their looked-up rows are cast instead (train_state.py:175).
EMBED_CAST_SKIP_ROWS = 16384


def prepare_inputs(inputs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 images -> ((x / 255 - mean) / std) in fp32, cast to ``dtype``,
    on the tensor's own device; float inputs are taken as normalised and only
    cast; integer tokens pass through."""
    if inputs.dtype == torch.uint8:
        mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=inputs.device)
        std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=inputs.device)
        return ((inputs.float() / 255.0 - mean) / std).to(dtype)
    if inputs.is_floating_point():
        return inputs.to(dtype)
    return inputs


@torch.no_grad()
def cast_to_compute(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every fp32 parameter of ``module`` to ``dtype`` in place, LN
    scale/bias and the head mixes included, except 2D tables with at least
    ``EMBED_CAST_SKIP_ROWS`` rows.  Returns ``module``."""
    for p in module.parameters():
        if p.dtype != torch.float32:
            continue
        if p.ndim == 2 and p.shape[0] >= EMBED_CAST_SKIP_ROWS:
            continue
        p.data = p.data.to(dtype)
    return module
