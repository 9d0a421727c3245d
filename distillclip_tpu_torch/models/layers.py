"""Core layers: the dense layer, fp32 LayerNorm, QuickGELU, the CLIP MLP and
the CLIP attention.

Port of ``distillclip_tpu/models/layers.py``.  Parameters are fp32 masters;
the step (or the teacher, once) casts them to the compute dtype.  The blocks
run on ``[B·N, C]`` rows and fold their pre-LayerNorm into the consumer's
kernel: ``ln_1`` + ``in_proj`` is :func:`ops.dense_ln` (K1), ``ln_2`` + ``c_fc``
+ QuickGELU is :func:`ops.dense_act_ln` (K2); ``out_proj`` and ``c_proj`` are
plain products.  Under the ``fc1_ln: "0"`` perf knob (read when the block is
built) they do not fold: ``ln_1`` and ``ln_2`` run as
:func:`ops.layer_norm_rows` (K4), ``in_proj`` is a plain product and ``c_fc``
a plain product with a plain QuickGELU, as the JAX package leaves them to XLA.
Attention takes one of three routes, as in the JAX package:
:func:`ops.plain_attention_rows_qkv` on the fused rows when nothing is tapped,
:func:`ops.flash_attention` on ``[B, H, N, d]`` views of the fused qkv when
the stack collects hidden states (``need_rep``), and the materialised path
when the scores, probabilities or value map are the product, attention
dropout is active or the sequence is longer than the kernels take
(:func:`attention_kernel_ok`, the JAX towers' own dispatch by shape: 257
tokens of ViT-L/14, 577 of ViT-L/14@336px).

Randomness (dropout, drop-path) is drawn from an explicit ``torch.Generator``
when one is given, so that a step repeats from its seed; a module is
stochastic in training mode (``.train()``) and deterministic in eval mode.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distillclip_tpu_torch.config.perf import perf_knobs
from distillclip_tpu_torch.models.outputs import AttentionOutput, ControlFlags
from distillclip_tpu_torch.ops import (
    dense_act_ln,
    dense_ln,
    flash_attention,
    layer_norm_rows,
    plain_attention_rows_qkv,
)
from distillclip_tpu_torch.ops.transform_attention import MAX_SEQ

MASK_NEG = -1e9


def attention_kernel_ok(flags: ControlFlags, seq: int, dropout_active: bool,
                        rpe: bool = False) -> bool:
    """Whether a tower's attention goes to a kernel: nothing tapped, no
    active attention dropout, no iRPE tables, and at most ``MAX_SEQ`` (256)
    tokens.  The JAX towers' gate (``flash_ok`` in
    ``distillclip_tpu/models/layers.py`` and ``repeat_vit.py``), shared by
    both families of towers: past 256 tokens the JAX package runs XLA's
    materialised attention, because its Pallas kernels stop there, and the
    port materialises it in PyTorch.  A dispatch by shape, not a fallback: a
    kernel that fails still raises."""
    return not flags.attn_tap() and not dropout_active and not rpe and seq <= MAX_SEQ


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate).  The caller decides whether it is active."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, batch: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on a residual branch, per sample: ``x`` is ``[B·N, C]``
    rows of ``batch`` samples, and a dropped sample loses all its rows."""
    keep = 1.0 - rate
    mask = torch.rand((batch, 1, 1), device=x.device, generator=generator) < keep
    rows = x.view(batch, -1, x.shape[-1])
    return torch.where(mask, rows / keep, torch.zeros_like(rows)).view(x.shape)


def split_heads(qkv: torch.Tensor, heads: int, seq: int):
    """q, k, v as strided ``[B, H, N, d]`` views of the fused ``[B·N, 3·H·d]``
    rows: no copy is made."""
    rows, hd3 = qkv.shape
    return qkv.view(rows // seq, seq, 3, heads, hd3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """``[B, H, N, d]`` -> ``[B·N, H·d]`` rows (a view when the heads already
    lie inside the rows, as :func:`ops.flash_attention` returns them)."""
    B, H, N, d = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(B * N, H * d)


def key_mask(seq: int, causal: bool, kv_len: Optional[int], device) -> Optional[torch.Tensor]:
    """The additive fp32 ``[seq, seq]`` mask of the materialised path: -1e9
    above the diagonal when ``causal`` and at the keys past ``kv_len`` (twice
    where both hide a key, as the JAX package adds them), or None."""
    mask = None
    if causal:
        mask = torch.triu(torch.full((seq, seq), MASK_NEG, device=device), diagonal=1)
    if kv_len is not None and kv_len < seq:
        pad = torch.where(torch.arange(seq, device=device) < kv_len, 0.0, MASK_NEG)
        mask = pad.expand(seq, seq) if mask is None else mask + pad
    return mask


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
    ``ln_2`` is folded into the c_fc kernel unless ``fc1_ln: "0"``."""

    def __init__(self, width: int, expansion: int = 4):
        super().__init__()
        self.c_fc = Dense(width, width * expansion)
        self.c_proj = Dense(width * expansion, width)
        self.perf = perf_knobs()

    def forward(self, x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
        if self.perf.ln_fusion:
            h = dense_act_ln(x, ln.scale, ln.bias, self.c_fc.kernel, self.c_fc.bias,
                             "quick_gelu", ln.eps, self.perf.fc1_res)
        else:
            h = quick_gelu(self.c_fc(ln(x)))
        return self.c_proj(h)


class InstrumentedAttention(nn.Module):
    """CLIP's fused-qkv multi-head attention on ``[B·seq, C]`` rows, with
    optional taps; ``ln_1`` is folded into the in-projection kernel.

    Taps are fp32 ``[B, H, N, N]``: the scaled scores with the additive -1e9
    mask, their softmax, and the value map softmax(V·Vᵀ·scale).  The products
    take the operands upcast to fp32 (exact for bf16 values, and what the JAX
    einsums do with fp32 accumulation and output).  Dropout acts on the
    probabilities after the tap."""

    def __init__(self, width: int, heads: int, drop_prob: float = 0.0):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} not divisible by heads {heads}")
        self.heads = heads
        self.drop_prob = drop_prob
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)
        self.perf = perf_knobs()

    def forward(self, x: torch.Tensor, flags: ControlFlags, ln: LayerNorm, seq: int,
                causal: bool = False, kv_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> AttentionOutput:
        if self.perf.ln_fusion:
            qkv = dense_ln(x, ln.scale, ln.bias, self.in_proj.kernel, self.in_proj.bias, ln.eps)
        else:
            qkv = self.in_proj(ln(x))
        dropout_active = self.drop_prob > 0.0 and self.training
        if attention_kernel_ok(flags, seq, dropout_active):
            if flags.need_rep:
                q, k, v = split_heads(qkv, self.heads, seq)
                ctx = merge_heads(flash_attention(q, k, v, causal=causal, kv_len=kv_len))
            else:
                ctx = plain_attention_rows_qkv(qkv, heads=self.heads, seq=seq, causal=causal,
                                               kv_len=kv_len)
            return AttentionOutput(hidden=self.out_proj(ctx))

        q, k, v = split_heads(qkv, self.heads, seq)
        scale = q.shape[-1] ** -0.5
        # the buffers are fp32 when a loss reads them or the tower runs in
        # fp32, else the compute dtype
        buf = torch.float32 if (flags.attn_tap() or x.dtype == torch.float32) else x.dtype
        value_map = None
        if flags.need_value_map:
            v32 = v.float()
            value_map = torch.softmax(v32 @ v32.transpose(-1, -2) * scale, dim=-1)
        scores = (q.to(buf) @ k.to(buf).transpose(-1, -2)) * torch.tensor(scale, dtype=buf)
        mask = key_mask(seq, causal, kv_len, x.device)
        if mask is not None:
            scores = scores + mask.to(buf)
        probs = torch.softmax(scores, dim=-1)
        attn = dropout(probs, self.drop_prob, generator) if dropout_active else probs
        ctx = merge_heads(attn.to(v.dtype) @ v)
        return AttentionOutput(
            hidden=self.out_proj(ctx),
            attention_scores=scores if flags.need_attn_score else None,
            attention_probs=probs if flags.need_attn_prob else None,
            value_map=value_map)
