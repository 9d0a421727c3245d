"""Weight-share student transformers, for serving and for training.

Port of ``distillclip_tpu/models/repeat_vit.py``: ``depth`` logical layers run
as ``depth / repeated_times`` parameter blocks, each used ``repeated_times``
times.  Per repeat, the block has its own norm1/norm2 and its own [H, H]
head mixes ``conv_l`` / ``conv_w``; the qkv/proj and MLP weights are shared.

Each repeat runs, on ``[B·N, C]`` rows at the true token count:

1. norm1 + qkv              -- :func:`ops.dense_ln` (K1)
2. head-transform attention -- :func:`ops.transform_attention_rows_qkv` (K3),
   or, with ``use_transform=False``, plain attention without the head mixes
   -- :func:`ops.plain_attention_rows_qkv`
3. proj, residual add
4. norm2 + fc1 + exact GELU -- :func:`ops.dense_act_ln` (K2)
5. fc2, residual add

and after the last block the tower pools (the cls row, or the EOT row of
the text), normalises the pooled rows (:func:`ops.layer_norm_rows`, K4) and
projects them with ``head``.  Each of the four ops carries its gradient (a
``torch.autograd.Function`` over its backward kernel), so the same forward
trains: the step hands the towers their parameters cast to the compute dtype
(``training.train_state.cast_to_compute``), and on the card the kernels
refuse fp32 operands rather than compute in another precision.

Quirks kept from the reference: the text student is bidirectional (no causal
mask) and pools at ``argmax(tokens)``; the text qkv has no bias, the image
qkv has one (``qkv_bias: true`` in the configs).

Not ported yet, and refused rather than approximated: iRPE, the
``ControlFlags`` taps, and non-zero dropout / drop-path rates in training mode (in eval mode they do
nothing; the final configs set none).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distillclip_tpu_torch.models.layers import Dense
from distillclip_tpu_torch.models.outputs import ControlFlags
from distillclip_tpu_torch.models.text import TokenEmbedding, eot_pool
from distillclip_tpu_torch.models.vit import patchify
from distillclip_tpu_torch.ops import (
    dense_act_ln,
    dense_ln,
    layer_norm_rows,
    plain_attention_rows_qkv,
    transform_attention_rows_qkv,
)


class StudentLayerNorm(nn.Module):
    """LayerNorm with fp32 math on 2D rows (the students use torch defaults)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_rows(x, self.scale, self.bias, self.eps)


class MiniAttention(nn.Module):
    """Shared qkv/proj attention; with ``use_transform`` the per-repeat head
    mixes ``conv_l`` / ``conv_w`` exist and mix the heads, without it the
    attention is plain.  norm1 is folded into the qkv kernel."""

    def __init__(self, dim: int, num_heads: int, repeated_times: int = 1,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 use_transform: bool = False, rpe_config=None):
        super().__init__()
        if rpe_config is not None:
            raise NotImplementedError("iRPE is not ported yet (ROADMAP queue 1, item 10)")
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.use_transform = use_transform
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        if use_transform:
            self.conv_l = nn.Parameter(torch.empty(repeated_times, num_heads, num_heads))
            self.conv_w = nn.Parameter(torch.empty(repeated_times, num_heads, num_heads))
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, repeat_id: int, seq: int,
                norm1: StudentLayerNorm) -> torch.Tensor:
        qkv = dense_ln(x, norm1.scale, norm1.bias, self.qkv.kernel, self.qkv.bias, norm1.eps)
        if self.use_transform:
            ctx = transform_attention_rows_qkv(
                qkv, self.conv_l[repeat_id], self.conv_w[repeat_id], heads=self.num_heads,
                seq=seq, scale=self.scale)
        else:
            ctx = plain_attention_rows_qkv(qkv, heads=self.num_heads, seq=seq,
                                           scale=self.scale)
        return self.proj(ctx)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2; norm2 is folded into the fc1 kernel."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, in_features)

    def forward(self, x: torch.Tensor, norm2: StudentLayerNorm) -> torch.Tensor:
        h = dense_act_ln(x, norm2.scale, norm2.bias, self.fc1.kernel, self.fc1.bias,
                         "gelu_exact", norm2.eps)
        return self.fc2(h)


class RepeatedMiniBlock(nn.Module):
    """One parameter block run ``repeated_times`` times."""

    def __init__(self, dim: int, num_heads: int, repeated_times: int = 1,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, use_transform: bool = False,
                 rpe_config=None):
        super().__init__()
        self.attn = MiniAttention(dim, num_heads, repeated_times, qkv_bias, qk_scale,
                                  use_transform, rpe_config)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm1 = nn.ModuleList(StudentLayerNorm(dim) for _ in range(repeated_times))
        self.norm2 = nn.ModuleList(StudentLayerNorm(dim) for _ in range(repeated_times))

    def forward(self, x: torch.Tensor, seq: int) -> torch.Tensor:
        for r in range(len(self.norm1)):
            x = x + self.attn(x, r, seq, self.norm1[r])
            x = x + self.mlp(x, self.norm2[r])
        return x


class _RepeatTower(nn.Module):
    """Blocks, final norm and head shared by both towers."""

    def __init__(self, *, out_dim, embed_dim, depth, num_heads, mlp_ratio, qkv_bias,
                 qk_scale, drop_rate, attn_drop_rate, drop_path_rate, repeated_times,
                 use_transform, rpe_config):
        super().__init__()
        if depth % repeated_times:
            raise ValueError(f"depth {depth} is not a multiple of repeated_times "
                             f"{repeated_times}")
        self.embed_dim = embed_dim
        self.drop_rates = (drop_rate, attn_drop_rate, drop_path_rate)
        self.blocks = nn.ModuleList(
            RepeatedMiniBlock(embed_dim, num_heads, repeated_times, mlp_ratio, qkv_bias,
                              qk_scale, use_transform, rpe_config)
            for _ in range(depth // repeated_times))
        self.norm = StudentLayerNorm(embed_dim)
        self.head = Dense(embed_dim, out_dim)

    def _check_forward(self, flags: ControlFlags) -> None:
        flags.require_default()
        if self.training and any(r > 0.0 for r in self.drop_rates):
            raise NotImplementedError(
                "non-zero dropout / drop-path rates in training mode are not ported "
                "yet (ROADMAP queue 1, item 2: taps and dropout); call .eval() to serve")

    def _blocks_and_head(self, x: torch.Tensor, pool) -> torch.Tensor:
        """x: ``[B, N, C]`` embeddings; ``pool`` picks one row per sample."""
        B, N, C = x.shape
        rows = x.reshape(B * N, C)
        for blk in self.blocks:
            rows = blk(rows, N)
        pooled = pool(rows.view(B, N, C)).contiguous()
        return self.head(self.norm(pooled))


class RepeatVisionTransformer(_RepeatTower):
    """Weight-share student ViT; returns the cls representation ``[B, out_dim]``.

    Images are NHWC in the compute dtype (``serving.inputs.prepare_inputs``)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 out_dim: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 repeated_times: int = 1, use_transform: bool = False, rpe_config=None):
        super().__init__(out_dim=out_dim, embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, drop_rate=drop_rate,
                         attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                         repeated_times=repeated_times, use_transform=use_transform,
                         rpe_config=rpe_config)
        self.img_size = img_size
        self.patch_size = patch_size
        seq_len = (img_size // patch_size) ** 2 + 1
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * in_chans,
                                                     embed_dim))
        self.patch_bias = nn.Parameter(torch.zeros(embed_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, embed_dim))

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags()) -> torch.Tensor:
        self._check_forward(flags)
        B, H, W, _ = images.shape
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"RepeatVisionTransformer(img_size={self.img_size}) got images "
                             f"of shape {tuple(images.shape)} (expected NHWC)")
        dt = images.dtype
        x = patchify(images, self.patch_size) @ self.patch_kernel.to(dt) + self.patch_bias.to(dt)
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        return self._blocks_and_head(x, lambda h: h[:, 0])


class RepeatTextTransformer(_RepeatTower):
    """Weight-share student text transformer; returns the EOT representation
    ``[B, out_dim]``.  Bidirectional, like the reference student."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 out_dim: int = 512, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 repeated_times: int = 1, use_transform: bool = False,
                 compression_embedding: bool = False, embedding_compression_dim: int = 256,
                 rpe_config=None):
        super().__init__(out_dim=out_dim, embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, drop_rate=drop_rate,
                         attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                         repeated_times=repeated_times, use_transform=use_transform,
                         rpe_config=rpe_config)
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.pos_embed = nn.Parameter(torch.empty(context_length, embed_dim))
        self.patch_embed = TokenEmbedding(vocab_size, embed_dim, compression_embedding,
                                          embedding_compression_dim)

    def forward(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags()) -> torch.Tensor:
        self._check_forward(flags)
        # the pos_embed dtype is the tower's compute dtype; the vocab table
        # stays fp32 and only the gathered rows are cast
        x = self.patch_embed(tokens, dtype=self.pos_embed.dtype)
        x = x + self.pos_embed.to(x.dtype)
        return self._blocks_and_head(x, lambda h: eot_pool(h, tokens))
