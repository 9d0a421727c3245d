"""EVA-02-CLIP's vision tower, written out in plain PyTorch from its layer
equations: the plain reference of the ``eva02_l14`` configuration.

EVA-CLIP (arXiv:2303.15389) with EVA-02's block (arXiv:2303.11331), as
``EVA-CLIP/rei/eva_clip/eva_vit_model.py`` and ``rope.py`` of baaivision/EVA
define it for ``model_configs/EVA02-CLIP-L-14.json``, from a checkpoint's
state dict in EVA-CLIP's key names (``visual.*``, ``Linear`` weights
``[out, in]``).  LayerNorm ε = 1e-6, no ``ln_pre``, no layer scale:

* ``x = [cls; conv(img) + b] + pos_embed``;
* ``a = LN_1(x)``; ``q = a·Wqᵀ + q_bias``, ``k = a·Wkᵀ``, ``v = a·Wvᵀ + v_bias``;
  the 2-D rotary embedding on the patch rows of q and k (the class row is
  not turned): for patch p = g·r + c of a g × g grid, head column j < d/2
  takes the angle r'·f_⌊j/2⌋ and column j ≥ d/2 the angle c'·f_⌊(j - d/2)/2⌋,
  f_i = θ^(-2i / (d/2)), θ = 10000, the positions r' = r·pt/g, c' = c·pt/g
  (pt = 16, EVA's ``pt_hw_seq_len``); pairs (2i, 2i+1) turn together:
  ``out_2i = x_2i·cos - x_2i+1·sin``, ``out_2i+1 = x_2i+1·cos + x_2i·sin``;
* ``x ← x + proj(LN_inner(softmax(q·kᵀ·d^-0.5)·v))``, LN_inner over all heads;
* ``x ← x + w3(LN_ffn(silu(LN_2(x)·W1ᵀ + b1) ⊙ (LN_2(x)·W2ᵀ + b2)))``, LN_ffn over
  the true hidden width;
* ``y = LN(x)[cls]·W_headᵀ + b_head``.

Every product goes through the :class:`~benchmark.reference.numerics.Precision`
(the fp8 control rounds each operand).  Departures from the published code:
float32 throughout (EVA runs bf16 or fp16), a plain softmax attention where
EVA calls xformers' memory-efficient kernel (the same function), the
rotary table computed here in float64 then used in float32 (EVA: float32),
and the head applied to the class row alone (LayerNorm acts per row, so it
is the same row).  Imports nothing of the program.

``variant`` leaves out or alters one mechanism, as the controls that the
comparison's limits have to fail: ``no_rope`` (rotary left out),
``rope_halves`` (each column turned with its partner half a head away, the
``rotate_half`` split of other rotary codes, not interleaved pairs),
``silu_w2`` (SiLU on W2's half, not W1's), ``ffn_ln_padded`` (LN_ffn's
moments over the hidden width padded to a multiple of 32, zeros counted) and
``no_inner_ln`` (LN_inner left out).
"""

from __future__ import annotations

import torch

from benchmark.reference.numerics import Precision, layer_norm, normalize_images

EPS = 1e-6
PT_GRID = 16
THETA = 10000.0
VARIANTS = ("no_rope", "rope_halves", "silu_w2", "ffn_ln_padded", "no_inner_ln")


def rotary_angles(grid: int, head_dim: int, pt_grid: int = PT_GRID) -> torch.Tensor:
    """float64 ``[grid², head_dim]``: the angle of each patch at each head column."""
    quarter = head_dim // 4
    f = THETA ** (-2.0 * torch.arange(quarter, dtype=torch.float64) / (head_dim // 2))
    pos = torch.arange(grid, dtype=torch.float64) * pt_grid / grid
    r = pos.repeat_interleave(grid)                 # the patch's row
    c = pos.repeat(grid)                            # its column
    i = torch.arange(head_dim) // 2                 # the pair of each column
    lower = i < quarter
    return torch.where(lower, r[:, None] * f[i.clamp(max=quarter - 1)][None, :],
                       c[:, None] * f[(i - quarter).clamp(min=0)][None, :])


def rotate(x: torch.Tensor, angles: torch.Tensor, halves: bool = False) -> torch.Tensor:
    """The turn of ``x`` [B, H, N, d] on its rows 1.. (the patches); the class
    row passes.  ``halves``: each column's partner half a head away."""
    cos, sin = angles.cos().float(), angles.sin().float()
    p = x[:, :, 1:]
    if halves:
        h = p.shape[-1] // 2
        partner = torch.cat([-p[..., h:], p[..., :h]], dim=-1)
    else:
        partner = torch.stack([-p[..., 1::2], p[..., 0::2]], dim=-1).flatten(-2)
    return torch.cat([x[:, :, :1], p * cos + partner * sin], dim=2)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.view(B, N, heads, C // heads).transpose(1, 2)


def _linear(sd: dict, name: str, x: torch.Tensor, P: Precision) -> torch.Tensor:
    y = P.mm(x, sd[name + ".weight"].t())
    bias = sd.get(name + ".bias")
    return y if bias is None else y + bias


def _ln(sd: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, sd[name + ".weight"], sd[name + ".bias"], EPS)


def eva_block(sd: dict, pre: str, x: torch.Tensor, heads: int, angles: torch.Tensor,
              P: Precision, variant: str = None) -> torch.Tensor:
    a = _ln(sd, pre + "norm1", x)
    q = P.mm(a, sd[pre + "attn.q_proj.weight"].t()) + sd[pre + "attn.q_bias"]
    k = P.mm(a, sd[pre + "attn.k_proj.weight"].t())
    v = P.mm(a, sd[pre + "attn.v_proj.weight"].t()) + sd[pre + "attn.v_bias"]
    q, k, v = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    if variant != "no_rope":
        q = rotate(q, angles, variant == "rope_halves")
        k = rotate(k, angles, variant == "rope_halves")
    s = P.mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    o = P.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).flatten(2)
    if variant != "no_inner_ln":
        o = _ln(sd, pre + "attn.inner_attn_ln", o)
    x = x + _linear(sd, pre + "attn.proj", o, P)
    b = _ln(sd, pre + "norm2", x)
    x1, x2 = _linear(sd, pre + "mlp.w1", b, P), _linear(sd, pre + "mlp.w2", b, P)
    h = x1 * torch.nn.functional.silu(x2) if variant == "silu_w2" else \
        torch.nn.functional.silu(x1) * x2
    if variant == "ffn_ln_padded":
        width = h.shape[-1]
        h = torch.nn.functional.pad(h, (0, -(-width // 32) * 32 - width))
        mean = h.mean(-1, keepdim=True)
        var = (h - mean).square().mean(-1, keepdim=True)
        h = ((h - mean) / torch.sqrt(var + EPS))[..., :width]
        h = h * sd[pre + "mlp.ffn_ln.weight"] + sd[pre + "mlp.ffn_ln.bias"]
    else:
        h = _ln(sd, pre + "mlp.ffn_ln", h)
    return x + _linear(sd, pre + "mlp.w3", h, P)


def eva_image(sd: dict, images: torch.Tensor, P: Precision, heads: int,
              pt_grid: int = PT_GRID, variant: str = None) -> torch.Tensor:
    """``[B, output_dim]`` of uint8 NHWC images."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    x = normalize_images(images)
    conv = sd["visual.patch_embed.proj.weight"]              # [width, 3, S, S]
    width, S = conv.shape[0], conv.shape[-1]
    B, g = x.shape[0], x.shape[1] // S
    patches = x.reshape(B, g, S, g, S, 3).permute(0, 1, 3, 5, 2, 4).reshape(B, g * g, 3 * S * S)
    x = P.mm(patches, conv.reshape(width, -1).t()) + sd["visual.patch_embed.proj.bias"]
    cls = sd["visual.cls_token"].reshape(1, 1, width).expand(B, 1, width)
    x = torch.cat([cls, x], dim=1) + sd["visual.pos_embed"].reshape(-1, width)
    angles = rotary_angles(g, width // heads, pt_grid).to(x.device)
    layers = len([k for k in sd if k.startswith("visual.blocks.")
                  and k.endswith(".attn.q_proj.weight")])
    for i in range(layers):
        x = eva_block(sd, f"visual.blocks.{i}.", x, heads, angles, P, variant)
    return _linear(sd, "visual.head", _ln(sd, "visual.norm", x[:, 0]), P)

