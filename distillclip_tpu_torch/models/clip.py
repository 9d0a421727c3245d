"""Feature normalisation for cosine scoring."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x|| in fp32 with no eps, like torch's ``x / x.norm(dim, keepdim=True)``.

    Port of ``distillclip_tpu/models/clip.py:24-29``; output in x's dtype."""
    x32 = x.float()
    return (x32 / x32.norm(dim=dim, keepdim=True)).to(x.dtype)
