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

Under the ``fc1_ln: "0"`` perf knob (``config.perf``, read when the tower is
built) the norms are not folded: norm1 and norm2 run as
:func:`ops.layer_norm_rows` (K4), qkv is a plain product and fc1 + GELU is
:func:`ops.dense_act` (the GEMM without the LayerNorm prologue).  Under
``fc1_res: u`` fc1 saves u only for its backward.  ``tf_impl: factored`` names
the per-head formulation that K3 computes already (``ops.transform_attention``).
The parameter names do not change.

After the last block the tower pools (the cls row, or the EOT row of
the text), normalises the pooled rows (:func:`ops.layer_norm_rows`, K4) and
projects them with ``head``; under ``need_last_layer`` it normalises and
projects all N rows and pools afterwards.

With taps (``ControlFlags``) only two things change: what attention returns
and what the blocks collect.  When the blocks collect hidden states
(``need_rep``) attention runs through :func:`ops.flash_attention` on strided
``[B, H, N, d]`` views of the fused qkv; when the scores, probabilities or
value map are the product, or attention dropout is active, they are
materialised in fp32 by plain PyTorch.  Past 256 tokens (a patch-14 student
at 224 px has 257) every attention is materialised, in the compute dtype
when nothing is tapped, as the JAX towers take XLA's attention there
(``models.layers.attention_kernel_ok``, the gate both tower families
share).  Tap semantics are the reference's: ``attention_scores`` is the
scaled q·kᵀ before ``conv_l``, ``attention_probs`` the softmax before
``conv_w``.  Every repeat's taps are returned:
``need_layers`` is accepted by neither tower, as the reference ignores it.
With the default flags a tower returns its pooled representation as a tensor
(the serving path); with any flag set it returns a
:class:`VisionOutput` / :class:`TextOutput`.  Each of the four ops carries its gradient (a
``torch.autograd.Function`` over its backward kernel), so the same forward
trains: the step hands the towers their parameters cast to the compute dtype
(``training.train_state.cast_to_compute``), and on the card the kernels
refuse fp32 operands rather than compute in another precision.

The towers run at the true token count, so the key limit (``kv_len``) that
the JAX towers pass for their padded sequences has no counterpart here.

Quirks kept from the reference: the text student is bidirectional (no causal
mask) and pools at ``argmax(tokens)``; the text qkv has no bias, the image
qkv has one (``qkv_bias: true`` in the configs).

Dropout (after ``proj``, in the MLP, on the embeddings and on the attention
probabilities) and per-sample drop-path act in training mode (``.train()``)
with non-zero rates, drawing from the ``generator`` the forward is given.

With ``rpe_config`` (:mod:`models.irpe`) a block holds its relative position
tables and every attention takes the materialised path, taps or not, as the
JAX package does: the encodings on keys and queries are added to the scaled
scores (after ``attention_scores`` is read, before ``conv_l``), the encoding
of the probabilities after dropout is added to the output.  The sequence must
be ``skip`` plus a square grid (the ViT's ``1 + patches``); the text tower's
``context_length`` rarely is, and then the tower raises ``ValueError`` when it
is built, where the JAX tower raises at its first call.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.config.perf import perf_knobs, require_kernels
from distillclip_tpu_torch.models.irpe import (
    RpeParams,
    bucket_index,
    rpe_config_from_dict,
    rpe_on_keys,
    rpe_on_queries,
    rpe_on_values,
    table_shapes,
)
from distillclip_tpu_torch.models.layers import (
    Dense,
    attention_kernel_ok,
    drop_path,
    dropout,
    merge_heads,
    split_heads,
)
from distillclip_tpu_torch.models.outputs import (
    AttentionOutput,
    ControlFlags,
    TextOutput,
    TransformerOutput,
    VisionOutput,
)
from distillclip_tpu_torch.models.text import TokenEmbedding, eot_pool
from distillclip_tpu_torch.models.vit import patchify
from distillclip_tpu_torch.ops import (
    dense_act,
    dense_act_ln,
    dense_ln,
    flash_attention,
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
    attention is plain.  norm1 is folded into the qkv kernel unless the
    ``fc1_ln: "0"`` knob unfuses it.  With ``rpe_config`` (a
    :class:`models.irpe.RpeConfig` or its dict) the module holds the iRPE
    tables of ``seq_len`` tokens, zero-initialised."""

    def __init__(self, dim: int, num_heads: int, repeated_times: int = 1,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 use_transform: bool = False, rpe_config=None, seq_len: Optional[int] = None):
        super().__init__()
        self.rpe = rpe_config_from_dict(rpe_config)
        self.seq_len = seq_len
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.use_transform = use_transform
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        if use_transform:
            self.conv_l = nn.Parameter(torch.empty(repeated_times, num_heads, num_heads))
            self.conv_w = nn.Parameter(torch.empty(repeated_times, num_heads, num_heads))
        if self.rpe is not None:
            if seq_len is None:
                raise ValueError("seq_len required when rpe_config is set")
            bucket_index(self.rpe, seq_len, "cpu")      # a length off the grid raises here
            for name, shape in table_shapes(self.rpe, dim // num_heads, num_heads,
                                            repeated_times).items():
                self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.proj = Dense(dim, dim)
        self.perf = perf_knobs()

    def _rpe_params(self, head_dim: int) -> Optional[RpeParams]:
        if self.rpe is None:
            return None
        kind = "bias" if self.rpe.mode == "bias" else "weight"
        return RpeParams(self.rpe, self.seq_len, self.num_heads, head_dim,
                         q_table=getattr(self, f"rpe_q_{kind}", None),
                         k_table=getattr(self, f"rpe_k_{kind}", None),
                         v_table=getattr(self, "rpe_v_weight", None))

    def _project(self, ctx: torch.Tensor, generator) -> torch.Tensor:
        out = self.proj(ctx)
        if self.proj_drop > 0.0 and self.training:
            out = dropout(out, self.proj_drop, generator)
        return out

    def forward(self, x: torch.Tensor, repeat_id: int, seq: int, norm1: StudentLayerNorm,
                flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> AttentionOutput:
        if self.perf.ln_fusion:
            qkv = dense_ln(x, norm1.scale, norm1.bias, self.qkv.kernel, self.qkv.bias,
                           norm1.eps)
        else:
            qkv = self.qkv(norm1(x))
        dropout_active = self.attn_drop > 0.0 and self.training
        if attention_kernel_ok(flags, seq, dropout_active, self.rpe is not None):
            if flags.need_rep:
                q, k, v = split_heads(qkv, self.num_heads, seq)
                mixes = ((self.conv_l[repeat_id], self.conv_w[repeat_id])
                         if self.use_transform else None)
                ctx = merge_heads(flash_attention(q, k, v, scale=self.scale,
                                                  head_transform=mixes))
            elif self.use_transform:
                ctx = transform_attention_rows_qkv(
                    qkv, self.conv_l[repeat_id], self.conv_w[repeat_id], heads=self.num_heads,
                    seq=seq, scale=self.scale)
            else:
                ctx = plain_attention_rows_qkv(qkv, heads=self.num_heads, seq=seq,
                                               scale=self.scale)
            return AttentionOutput(hidden=self._project(ctx, generator))

        # materialised path: fp32 buffers when a loss reads them or the tower
        # runs in fp32, else the compute dtype
        q, k, v = split_heads(qkv, self.num_heads, seq)
        buf = torch.float32 if (flags.attn_tap() or x.dtype == torch.float32) else x.dtype
        value_map = None
        if flags.need_value_map:
            v32 = v.float()
            value_map = torch.softmax(v32 @ v32.transpose(-1, -2) / q.shape[-1] ** 0.5, dim=-1)
        # q is scaled in the compute dtype first, as the reference does
        scale = torch.tensor(self.scale, dtype=x.dtype)
        q = q * scale
        attn = q.to(buf) @ k.to(buf).transpose(-1, -2)
        attention_scores = attn if flags.need_attn_score else None
        rpe = self._rpe_params(q.shape[-1])
        if rpe is not None:
            # the contextual encodings are fp32 and promote the scores; the
            # head mix returns them to the buffer dtype, as in the JAX package
            attn = attn + rpe_on_keys(rpe, repeat_id, q)
            attn = attn + rpe_on_queries(rpe, repeat_id, k * scale)
        if self.use_transform:
            attn = torch.einsum("hg,bgnm->bhnm", self.conv_l[repeat_id].to(attn.dtype),
                                attn).to(buf)
        attn = torch.softmax(attn, dim=-1)
        attention_probs = attn if flags.need_attn_prob else None
        if self.use_transform:
            attn = torch.einsum("hg,bgnm->bhnm", self.conv_w[repeat_id].to(buf), attn)
        if dropout_active:
            attn = dropout(attn, self.attn_drop, generator)
        if rpe is None:
            ctx = attn.to(v.dtype) @ v
        else:
            # P·v accumulated in fp32 with the values' encoding added, then
            # rounded once to the compute dtype
            probs = attn.to(v.dtype)
            ctx = (probs.float() @ v.float() + rpe_on_values(rpe, repeat_id, probs)).to(x.dtype)
        ctx = merge_heads(ctx)
        return AttentionOutput(hidden=self._project(ctx, generator),
                               attention_scores=attention_scores,
                               attention_probs=attention_probs, value_map=value_map)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> drop -> fc2 -> drop; norm2 is folded into the fc1
    kernel unless the ``fc1_ln: "0"`` knob unfuses it."""

    def __init__(self, in_features: int, hidden_features: int, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, in_features)
        self.perf = perf_knobs()

    def forward(self, x: torch.Tensor, norm2: StudentLayerNorm,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        active = self.drop > 0.0 and self.training
        if self.perf.ln_fusion:
            h = dense_act_ln(x, norm2.scale, norm2.bias, self.fc1.kernel, self.fc1.bias,
                             "gelu_exact", norm2.eps, self.perf.fc1_res)
        else:
            h = dense_act(norm2(x), self.fc1.kernel, self.fc1.bias, "gelu_exact",
                          self.perf.fc1_res)
        if active:
            h = dropout(h, self.drop, generator)
        out = self.fc2(h)
        return dropout(out, self.drop, generator) if active else out


class RepeatedMiniBlock(nn.Module):
    """One parameter block run ``repeated_times`` times; ``drop_paths`` holds
    each repeat's stochastic-depth rate."""

    def __init__(self, dim: int, num_heads: int, repeated_times: int = 1,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_paths: Optional[Sequence[float]] = None, use_transform: bool = False,
                 rpe_config=None, seq_len: Optional[int] = None):
        super().__init__()
        self.drop_paths = tuple(drop_paths) if drop_paths else (0.0,) * repeated_times
        if len(self.drop_paths) != repeated_times:
            raise ValueError(f"{len(self.drop_paths)} drop-path rates for {repeated_times} "
                             f"repeats")
        self.attn = MiniAttention(dim, num_heads, repeated_times, qkv_bias, qk_scale,
                                  attn_drop, drop, use_transform, rpe_config, seq_len)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.norm1 = nn.ModuleList(StudentLayerNorm(dim) for _ in range(repeated_times))
        self.norm2 = nn.ModuleList(StudentLayerNorm(dim) for _ in range(repeated_times))

    def _drop_path(self, branch: torch.Tensor, r: int, batch: int, generator) -> torch.Tensor:
        if self.drop_paths[r] > 0.0 and self.training:
            return drop_path(branch, self.drop_paths[r], batch, generator)
        return branch

    def forward(self, x: torch.Tensor, seq: int, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None) -> TransformerOutput:
        """``hidden`` is ``[B·seq, C]`` rows; the taps of every repeat are
        stacked on a leading axis (the value map is the last repeat's)."""
        batch = x.shape[0] // seq
        scores, probs, reps = [], [], []
        value_map = None
        for r in range(len(self.norm1)):
            a_out = self.attn(x, r, seq, self.norm1[r], flags, generator)
            x = x + self._drop_path(a_out.hidden, r, batch, generator)
            x = x + self._drop_path(self.mlp(x, self.norm2[r], generator), r, batch, generator)
            if flags.need_rep:
                reps.append(x.view(batch, seq, -1))
            if flags.need_attn_score:
                scores.append(a_out.attention_scores)
            if flags.need_attn_prob:
                probs.append(a_out.attention_probs)
            value_map = a_out.value_map
        stack = lambda xs: torch.stack(xs, dim=0) if xs else None
        return TransformerOutput(hidden=x, attention_scores=stack(scores),
                                 attention_probs=stack(probs), representations=stack(reps),
                                 value_map=value_map)


def _concat_opt(parts: list) -> Optional[torch.Tensor]:
    parts = [p for p in parts if p is not None]
    return torch.cat(parts, dim=0) if parts else None


class _RepeatTower(nn.Module):
    """Blocks, final norm and head shared by both towers."""

    _out_cls = VisionOutput

    def __init__(self, *, out_dim, embed_dim, depth, num_heads, mlp_ratio, qkv_bias,
                 qk_scale, drop_rate, attn_drop_rate, drop_path_rate, repeated_times,
                 use_transform, rpe_config, seq_len):
        super().__init__()
        if depth % repeated_times:
            raise ValueError(f"depth {depth} is not a multiple of repeated_times "
                             f"{repeated_times}")
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            RepeatedMiniBlock(embed_dim, num_heads, repeated_times, mlp_ratio, qkv_bias,
                              qk_scale, drop_rate, attn_drop_rate,
                              dpr[b * repeated_times:(b + 1) * repeated_times], use_transform,
                              rpe_config, seq_len)
            for b in range(depth // repeated_times))
        self.norm = StudentLayerNorm(embed_dim)
        self.head = Dense(embed_dim, out_dim)
        self.perf = perf_knobs()

    def _blocks_and_head(self, x: torch.Tensor, pool, flags: ControlFlags, generator):
        """x: ``[B, N, C]`` embeddings; ``pool`` picks one row per sample of a
        ``[B, N, ·]`` tensor.  The pooled tensor under the default flags, else
        the tower's output container."""
        B, N, C = x.shape
        if x.is_cuda:
            require_kernels(self.perf, x.device)
        embedding = x if flags.need_emb else None
        if self.drop_rate > 0.0 and self.training:
            x = dropout(x, self.drop_rate, generator)
        rows = x.reshape(B * N, C)
        scores, probs, reps = [], [], []
        value_map = None
        for blk in self.blocks:
            out = blk(rows, N, flags, generator)
            rows = out.hidden
            scores.append(out.attention_scores)
            probs.append(out.attention_probs)
            reps.append(out.representations)
            value_map = out.value_map
        if not flags.need_last_layer:
            # pool first: the norm and the head act per row
            rep = self.head(self.norm(pool(rows.view(B, N, C)).contiguous()))
            full = rep[:, None, :]
        else:
            full = self.head(self.norm(rows)).view(B, N, -1)
            rep = pool(full)
        if flags == ControlFlags():
            return rep
        return self._out_cls(
            last_representation=rep, last_layer_output=full,
            attention_scores=_concat_opt(scores), attention_probs=_concat_opt(probs),
            representations=_concat_opt(reps), value_map=value_map, embedding=embedding)


class RepeatVisionTransformer(_RepeatTower):
    """Weight-share student ViT; returns the cls representation ``[B, out_dim]``,
    or a :class:`VisionOutput` when any flag is set.

    Images are NHWC in the compute dtype (``serving.inputs.prepare_inputs``)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 out_dim: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 repeated_times: int = 1, use_transform: bool = False, rpe_config=None,
                 need_layers: Optional[Sequence[int]] = None):
        seq_len = (img_size // patch_size) ** 2 + 1
        super().__init__(out_dim=out_dim, embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, drop_rate=drop_rate,
                         attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                         repeated_times=repeated_times, use_transform=use_transform,
                         rpe_config=rpe_config, seq_len=seq_len)
        self.need_layers = need_layers      # accepted and not applied (reference quirk)
        self.img_size = img_size
        self.patch_size = patch_size
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * in_chans,
                                                     embed_dim))
        self.patch_bias = nn.Parameter(torch.zeros(embed_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, embed_dim))

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None):
        B, H, W, _ = images.shape
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"RepeatVisionTransformer(img_size={self.img_size}) got images "
                             f"of shape {tuple(images.shape)} (expected NHWC)")
        dt = images.dtype
        x = patchify(images, self.patch_size) @ self.patch_kernel.to(dt) + self.patch_bias.to(dt)
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        return self._blocks_and_head(x, lambda h: h[:, 0], flags, generator)


class RepeatTextTransformer(_RepeatTower):
    """Weight-share student text transformer; returns the EOT representation
    ``[B, out_dim]``, or a :class:`TextOutput` when any flag is set.
    Bidirectional, like the reference student."""

    _out_cls = TextOutput

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 out_dim: int = 512, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 repeated_times: int = 1, use_transform: bool = False,
                 compression_embedding: bool = False, embedding_compression_dim: int = 256,
                 rpe_config=None, need_layers: Optional[Sequence[int]] = None):
        super().__init__(out_dim=out_dim, embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, drop_rate=drop_rate,
                         attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
                         repeated_times=repeated_times, use_transform=use_transform,
                         rpe_config=rpe_config, seq_len=context_length)
        self.need_layers = need_layers      # accepted and not applied (reference quirk)
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.pos_embed = nn.Parameter(torch.empty(context_length, embed_dim))
        self.patch_embed = TokenEmbedding(vocab_size, embed_dim, compression_embedding,
                                          embedding_compression_dim)

    def forward(self, tokens: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator: Optional[torch.Generator] = None):
        # the pos_embed dtype is the tower's compute dtype; the vocab table
        # stays fp32 and only the gathered rows are cast
        x = self.patch_embed(tokens, dtype=self.pos_embed.dtype)
        x = x + self.pos_embed.to(x.dtype)
        return self._blocks_and_head(x, lambda h: eot_pool(h, tokens), flags, generator)
