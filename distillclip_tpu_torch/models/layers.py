"""The dense layer shared by the towers (``distillclip_tpu/models/layers.py::Dense``)."""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """y = x @ kernel + bias with ``kernel`` ``[in, out]``.

    The Flax Dense layout, kept so that converted parameters need no
    transpose and the LN-prologue kernels read W as ``[C, N]`` row-major.
    A plain product, like the XLA dot it replaces."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias
