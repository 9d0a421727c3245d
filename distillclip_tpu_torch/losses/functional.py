"""Distillation losses as plain functions on tensors, all in fp32.

Port of ``distillclip_tpu/losses/functional.py``: the three losses of the
stage-3 configuration (``configs/final/l_clip.yaml``).  The other losses of
the JAX package are ROADMAP queue 1, item 4.
"""

from __future__ import annotations

import torch


def out_l1(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """L1 on last representations: mean |stu - tea|."""
    return (stu.float() - tea.float()).abs().mean()


def out_cos(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """CosineEmbeddingLoss with target +1: mean(1 - cos), with the 1e-8
    added to the product of the norms."""
    s, t = stu.float(), tea.float()
    cos = (s * t).sum(dim=1) / (s.norm(dim=1) * t.norm(dim=1) + 1e-8)
    return (1.0 - cos).mean()


def _off_diagonal(x: torch.Tensor) -> torch.Tensor:
    """All off-diagonal elements of a square matrix, row by row."""
    n = x.shape[0]
    return x.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(-1)


def cos_diff(stu_logits: torch.Tensor, tea_logits: torch.Tensor) -> torch.Tensor:
    """Hinge on cosine gaps: pull the diagonal up to the teacher's, push the
    off-diagonals below the teacher's."""
    s, t = stu_logits.float(), tea_logits.float()
    pos = torch.relu(torch.diagonal(t) - torch.diagonal(s)).mean()
    neg = torch.relu(_off_diagonal(s) - _off_diagonal(t)).mean()
    return pos + neg
