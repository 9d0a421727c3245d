"""The towers, written out in plain PyTorch from their published equations.

* :func:`student_image` / :func:`student_text`: DistillCLIP's weight-share
  students (``model/component/weight_share_model.py`` of
  ForJadeForest/DistillCLIP): ``depth`` logical pre-LN layers run as
  ``depth / repeated_times`` parameter blocks, each applied
  ``repeated_times`` times with its own two LayerNorms and its own head
  mixes; the qkv, proj and MLP weights are shared between the repeats.
  Head-transform attention: scores q_h·k_hᵀ, mixed across heads by
  ``conv_l`` and scaled, softmax over the keys, the probabilities mixed by
  ``conv_w``, then the product with v.  The image tower pools the class row,
  the text tower (bidirectional, as the reference's student) the row of the
  largest token id; then the final LayerNorm and the head.
* :func:`clip_image` / :func:`clip_text`: OpenAI CLIP's ViT and text
  transformer (``clip/model.py`` of openai/CLIP) from a checkpoint's state
  dict in OpenAI's key names and layouts (``Linear`` weights ``[out, in]``).

Student parameters arrive as a ``{name: tensor}`` dict whose names are the
layout the benchmark hands both sides (dense kernels ``[in, out]``, patch
kernel ``[P·P·3, C]`` in (row, column, channel) order of the patch); the
reference reads them only by those names.  Everything is float32; each
product goes through the :class:`~benchmark.reference.numerics.Precision`.
"""

from __future__ import annotations

import torch

from benchmark.reference.numerics import (
    Precision,
    gelu_exact,
    layer_norm,
    normalize_images,
    quick_gelu,
)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, N, H·d]`` -> ``[B, H, N, d]``."""
    B, N, C = x.shape
    return x.view(B, N, heads, C // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


def _dense(p: dict, name: str, x: torch.Tensor, P: Precision) -> torch.Tensor:
    y = P.mm(x, p[name + ".kernel"])
    bias = p.get(name + ".bias")
    return y if bias is None else y + bias


def _student_blocks(p: dict, pre: str, x: torch.Tensor, geo: dict, P: Precision):
    heads, repeats = geo["num_heads"], geo["repeated_times"]
    scale = geo.get("qk_scale") or (geo["embed_dim"] // heads) ** -0.5
    for b in range(geo["depth"] // repeats):
        blk = f"{pre}blocks.{b}."
        for r in range(repeats):
            y = layer_norm(x, p[f"{blk}norm1.{r}.scale"], p[f"{blk}norm1.{r}.bias"])
            q, k, v = _dense(p, blk + "attn.qkv", y, P).chunk(3, dim=-1)
            q, k, v = _heads(q, heads), _heads(k, heads), _heads(v, heads)
            s = P.mm(q, k.transpose(-1, -2))
            if geo["use_transform"]:
                s = P.mix(p[blk + "attn.conv_l"][r], s)
            a = torch.softmax(s * scale, dim=-1)
            if geo["use_transform"]:
                a = P.mix(p[blk + "attn.conv_w"][r], a)
            x = x + _dense(p, blk + "attn.proj", _merge(P.mm(a, v)), P)
            y = layer_norm(x, p[f"{blk}norm2.{r}.scale"], p[f"{blk}norm2.{r}.bias"])
            x = x + _dense(p, blk + "mlp.fc2", gelu_exact(_dense(p, blk + "mlp.fc1", y, P)), P)
    return x


def _student_head(p: dict, pre: str, pooled: torch.Tensor, P: Precision) -> torch.Tensor:
    return _dense(p, pre + "head", layer_norm(pooled, p[pre + "norm.scale"], p[pre + "norm.bias"]),
                  P)


def student_image(p: dict, pre: str, images: torch.Tensor, geo: dict,
                  P: Precision) -> torch.Tensor:
    """``[B, out_dim]`` of uint8 NHWC images."""
    x = normalize_images(images)
    B, S = x.shape[0], geo["patch_size"]
    g = geo["img_size"] // S
    patches = x.reshape(B, g, S, g, S, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, S * S * 3)
    x = P.mm(patches, p[pre + "patch_kernel"]) + p[pre + "patch_bias"]
    cls = p[pre + "cls_token"].expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + p[pre + "pos_embed"]
    x = _student_blocks(p, pre, x, geo, P)
    return _student_head(p, pre, x[:, 0], P)


def student_text(p: dict, pre: str, tokens: torch.Tensor, geo: dict,
                 P: Precision) -> torch.Tensor:
    """``[B, out_dim]`` of ``[B, context_length]`` token ids."""
    x = p[pre + "patch_embed.embed.embedding"][tokens] + p[pre + "pos_embed"]
    x = _student_blocks(p, pre, x, geo, P)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return _student_head(p, pre, pooled, P)


# -- OpenAI CLIP -------------------------------------------------------------------

def _clip_blocks(sd: dict, pre: str, x: torch.Tensor, heads: int, causal: bool,
                 P: Precision) -> torch.Tensor:
    n = len({k[len(pre):].split(".")[0] for k in sd if k.startswith(pre)})
    N = x.shape[1]
    mask = None
    if causal:
        mask = torch.full((N, N), float("-inf"), device=x.device).triu(1)
    for i in range(n):
        blk = f"{pre}{i}."
        y = layer_norm(x, sd[blk + "ln_1.weight"], sd[blk + "ln_1.bias"])
        qkv = P.mm(y, sd[blk + "attn.in_proj_weight"].t()) + sd[blk + "attn.in_proj_bias"]
        q, k, v = (_heads(t, heads) for t in qkv.chunk(3, dim=-1))
        s = P.mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if mask is not None:
            s = s + mask
        o = _merge(P.mm(torch.softmax(s, dim=-1), v))
        x = x + P.mm(o, sd[blk + "attn.out_proj.weight"].t()) + sd[blk + "attn.out_proj.bias"]
        y = layer_norm(x, sd[blk + "ln_2.weight"], sd[blk + "ln_2.bias"])
        h = quick_gelu(P.mm(y, sd[blk + "mlp.c_fc.weight"].t()) + sd[blk + "mlp.c_fc.bias"])
        x = x + P.mm(h, sd[blk + "mlp.c_proj.weight"].t()) + sd[blk + "mlp.c_proj.bias"]
    return x


def clip_image(sd: dict, images: torch.Tensor, P: Precision) -> torch.Tensor:
    """CLIP's ViT: ``[B, embed_dim]`` of uint8 NHWC images (the class token
    after ``ln_post``, projected)."""
    x = normalize_images(images)
    conv = sd["visual.conv1.weight"]                  # [width, 3, S, S]
    width, S = conv.shape[0], conv.shape[-1]
    B, g = x.shape[0], x.shape[1] // S
    patches = x.reshape(B, g, S, g, S, 3).permute(0, 1, 3, 5, 2, 4).reshape(B, g * g, 3 * S * S)
    x = P.mm(patches, conv.reshape(width, -1).t())
    cls = sd["visual.class_embedding"].expand(B, 1, width)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"]
    x = layer_norm(x, sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"])
    x = _clip_blocks(sd, "visual.transformer.resblocks.", x, width // 64, False, P)
    cls = layer_norm(x[:, 0], sd["visual.ln_post.weight"], sd["visual.ln_post.bias"])
    return P.mm(cls, sd["visual.proj"])


def clip_text(sd: dict, tokens: torch.Tensor, P: Precision) -> torch.Tensor:
    """CLIP's causal text transformer: ``[B, embed_dim]`` at the EOT token
    (the largest id)."""
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    width = x.shape[-1]
    x = _clip_blocks(sd, "transformer.resblocks.", x, width // 64, True, P)
    x = layer_norm(x, sd["ln_final.weight"], sd["ln_final.bias"])
    eot = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return P.mm(eot, sd["text_projection"])
