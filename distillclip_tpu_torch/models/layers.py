"""Core layers: the dense layer, fp32 LayerNorm, QuickGELU, the CLIP MLP and
the CLIP attention.

Port of ``distillclip_tpu/models/layers.py``.  Parameters are fp32 masters;
the step (or the teacher, once) casts them to the compute dtype.  The blocks
run on ``[B·N, C]`` rows and fold their pre-LayerNorm into the consumer's
kernel: ``ln_1`` + ``in_proj`` is :func:`ops.dense_ln` (K1), ``ln_2`` + ``c_fc``
+ QuickGELU is :func:`ops.dense_act_ln` (K2), attention is
:func:`ops.plain_attention_rows_qkv`; ``out_proj`` and ``c_proj`` are plain
products.  Only the path without taps is ported: the score, probability and
value-map taps and attention dropout raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distillclip_tpu_torch.models.outputs import _TAPS_ITEM, ControlFlags
from distillclip_tpu_torch.ops import (
    dense_act_ln,
    dense_ln,
    layer_norm_rows,
    plain_attention_rows_qkv,
)


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


class LayerNorm(nn.Module):
    """LayerNorm with fp32 moments, result in the input's dtype, on the last
    dimension of any shape (the rows go through :func:`ops.layer_norm_rows`, K4).
    Blocks that fold it into their next kernel read ``scale``, ``bias`` and
    ``eps`` instead of calling it."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape(-1, x.shape[-1])
        return layer_norm_rows(rows, self.scale, self.bias, self.eps).view(x.shape)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU approximation x · sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class ClipMlp(nn.Module):
    """CLIP residual-block MLP: c_fc (width -> 4·width), QuickGELU, c_proj;
    ``ln_2`` is folded into the c_fc kernel."""

    def __init__(self, width: int, expansion: int = 4):
        super().__init__()
        self.c_fc = Dense(width, width * expansion)
        self.c_proj = Dense(width * expansion, width)

    def forward(self, x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
        h = dense_act_ln(x, ln.scale, ln.bias, self.c_fc.kernel, self.c_fc.bias,
                         "quick_gelu", ln.eps)
        return self.c_proj(h)


class InstrumentedAttention(nn.Module):
    """CLIP's fused-qkv multi-head attention on ``[B·seq, C]`` rows, without
    taps; ``ln_1`` is folded into the in-projection kernel."""

    def __init__(self, width: int, heads: int, drop_prob: float = 0.0):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} not divisible by heads {heads}")
        self.heads = heads
        self.drop_prob = drop_prob
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def forward(self, x: torch.Tensor, flags: ControlFlags, ln: LayerNorm, seq: int,
                causal: bool = False, kv_len: Optional[int] = None) -> torch.Tensor:
        flags.require_default()
        if self.drop_prob > 0.0 and self.training:
            raise NotImplementedError(
                f"attention dropout in training mode is not ported yet ({_TAPS_ITEM})")
        qkv = dense_ln(x, ln.scale, ln.bias, self.in_proj.kernel, self.in_proj.bias, ln.eps)
        ctx = plain_attention_rows_qkv(qkv, heads=self.heads, seq=seq, causal=causal,
                                       kv_len=kv_len)
        return self.out_proj(ctx)
