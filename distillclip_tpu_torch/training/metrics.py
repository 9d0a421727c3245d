"""Retrieval metrics: top-k accuracy, diagonal scores, logits helpers.

Port of ``distillclip_tpu/training/metrics.py``.  The rank of a row's
diagonal entry is the count of strictly larger logits in the row, so ties
count against the diagonal, and acc@k = mean(rank < k), every k from one
comparison matrix.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

DEFAULT_KS = (1, 3, 5, 10, 20, 50)


def l2_normalize_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def norm_and_logits(encode: torch.Tensor, stu_encode: torch.Tensor, tea_encode: torch.Tensor):
    """(student logits, teacher logits, and their transposes) against the
    normalised ``encode`` rows."""
    encode = l2_normalize_f32(encode)
    stu = l2_normalize_f32(stu_encode)
    tea = l2_normalize_f32(tea_encode)
    stu_logits = stu @ encode.t()
    tea_logits = tea @ encode.t()
    return stu_logits, tea_logits, stu_logits.t(), tea_logits.t()


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The fp32 mean as XLA takes it, the sum times the reciprocal of the
    count, so that an accuracy is the JAX package's to the bit."""
    return x.float().sum() * (1.0 / x.numel())


def topk_accuracy(logits: torch.Tensor, ks: Sequence[int] = DEFAULT_KS
                  ) -> Dict[int, torch.Tensor]:
    """acc@k with diagonal labels, ties counted against the diagonal."""
    rank = (logits > torch.diagonal(logits)[:, None]).sum(dim=1)  # 0 = best
    return {k: _mean(rank < k) for k in ks}


def diag_scores(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean diagonal score, mean diagonal softmax score)."""
    return (torch.diagonal(logits).mean(),
            torch.diagonal(torch.softmax(logits, dim=1)).mean())
