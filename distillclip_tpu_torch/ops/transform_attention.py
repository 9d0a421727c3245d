"""Head-transform attention on the fused qkv projection (forward only).

Port of ``distillclip_tpu/ops/transform_attention.py::
transform_attention_rows_qkv``: per sample, scores q_h·k_hᵀ, a mix across
heads by ``wl`` [H, H] (conv_l) before the softmax, a per-head softmax over
keys, a mix of the probabilities by ``ww`` [H, H] (conv_w), then the product
with v.  ``qkv`` is ``[B·seq, 3·H·d]`` (q | k | v column blocks, head-major
inside each) and the result ``[B·seq, H·d]``.

On a CUDA tensor it launches K3 (``csrc/transform_attention.cu``) at the
true sequence length, for any head count; on a CPU tensor it runs
:func:`transform_attention_rows_qkv_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distillclip_tpu_torch.ops import _build


def transform_attention_rows_qkv_plain(qkv: torch.Tensor, wl: torch.Tensor,
                                       ww: torch.Tensor, *, heads: int, seq: int,
                                       scale: float) -> torch.Tensor:
    """The same math in fp32 PyTorch; output in qkv's dtype."""
    rows, hd3 = qkv.shape
    B, d = rows // seq, hd3 // 3 // heads
    qkv5 = qkv.float().view(B, seq, 3, heads, d).permute(2, 0, 3, 1, 4)  # [3, B, H, N, d]
    q, k, v = qkv5[0], qkv5[1], qkv5[2]
    s = q @ k.transpose(-1, -2)                                     # [B, H, N, N]
    s = torch.einsum("hg,bgnm->bhnm", wl.float(), s) * scale
    p = torch.softmax(s, dim=-1)
    p = torch.einsum("hg,bgnm->bhnm", ww.float(), p)
    o = p @ v                                                       # [B, H, N, d]
    return o.permute(0, 2, 1, 3).reshape(rows, heads * d).to(qkv.dtype)


def _pick_tq(lib, seq: int, heads: int, d: int) -> int:
    """Query rows per block: as many as fit in shared memory (at most the
    kernel's cap), then evened out over the tiles so the last one is full."""
    tq = min(lib.dc_tf_max_tq(), seq)
    while tq > 0 and lib.dc_tf_smem_bytes(seq, heads, d, tq) > _build.MAX_SMEM_BYTES:
        tq -= 1
    if tq == 0:
        raise ValueError(f"transform_attention_rows_qkv: the score tile of {heads} heads "
                         f"x {seq} keys does not fit in one block's shared memory")
    tiles = -(-seq // tq)
    return -(-seq // tiles)


def transform_attention_rows_qkv(qkv: torch.Tensor, wl: torch.Tensor, ww: torch.Tensor,
                                 *, heads: int, seq: int,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Fused head-transform attention; ``scale`` defaults to d ** -0.5."""
    rows, hd3 = qkv.shape
    if hd3 % (3 * heads) or rows % seq or wl.shape != (heads, heads) \
            or ww.shape != (heads, heads):
        raise ValueError(f"transform_attention_rows_qkv: qkv [B*{seq}, 3*{heads}*d] and "
                         f"[{heads}, {heads}] mixes, got {tuple(qkv.shape)}, "
                         f"{tuple(wl.shape)}, {tuple(ww.shape)}")
    d = hd3 // 3 // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _build.plain_only("transform_attention_rows_qkv", qkv):
        return transform_attention_rows_qkv_plain(qkv, wl, ww, heads=heads, seq=seq,
                                                  scale=scale)
    _build.check_operands("transform_attention_rows_qkv", qkv, unaligned=(wl, ww))
    if d % 8:
        raise ValueError(f"transform_attention_rows_qkv: head dim must be a multiple "
                         f"of 8, got {d}")
    lib = _build.lib()
    tq = _pick_tq(lib, seq, heads, d)
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    if rows == 0:
        return out
    _build.check(lib.dc_transform_attention(qkv.data_ptr(), wl.data_ptr(), ww.data_ptr(),
                                            out.data_ptr(), rows // seq, seq, heads, d, tq,
                                            float(scale), _build.stream_ptr(qkv)),
                 "transform_attention_rows_qkv")
    transform_attention_rows_qkv.launches += 1
    return out


transform_attention_rows_qkv.launches = 0
