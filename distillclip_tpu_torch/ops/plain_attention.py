"""Plain multi-head attention on the fused qkv projection, forward and backward.

Port of ``distillclip_tpu/ops/blockdiag_attention.py::blockdiag_attention_rows_qkv``
and of ``distillclip_tpu/ops/flash_attention.py::flash_attention_rows_qkv``, which
the JAX package dispatches to by head shape; here one pair of kernels takes any
head count.  Per sample and head: softmax(q_h·k_hᵀ·scale + mask)·v_h, where the
mask hides the keys ``j >= kv_len`` and, when ``causal``, the keys ``j > i``.
``qkv`` is ``[B·seq, 3·H·d]`` (q | k | v column blocks, head-major inside each)
and the result ``[B·seq, H·d]``.  This is the attention of the CLIP teacher
towers, of the plain CLIP-architecture students and of the weight-share
students with ``use_transform=False``.

On a CUDA tensor it launches ``csrc/plain_attention.cu`` at the true sequence
length (any head count, ``d`` a multiple of 8 up to 128, ``seq`` up to 256):
both products on the tensor cores, one warp per 16 query rows of a head (the
design is in ``csrc/mma_attention.cuh``).  On a CPU tensor it runs
:func:`plain_attention_rows_qkv_plain`.

Past 256 tokens the EVA-02 tower's attention goes to
:func:`plain_attention_long` (``csrc/plain_attention_long.cu``): the same
function without a mask, forward only, at ``d`` = 64 and up to
:data:`LONG_MAX_SEQ` tokens, on ``wgmma`` with k and v streamed through a ring
of 64-key tiles and an online softmax.  The CLIP towers keep the JAX towers'
gate and materialise there.

With a gradient it is a ``torch.autograd.Function``: the forward is the kernel
with its save-P flag (:func:`plain_attention_save_p`), which also stores the
probabilities P ``[B, H, N, N]`` in qkv's dtype, and the backward
(:func:`plain_attention_bwd`, ``csrc/plain_attention_bwd.cu``) makes the fused
dqkv from qkv, the output gradient and P, its four products on the tensor
cores as well (the routines of ``csrc/mma_attention_bwd.cuh``).  A masked key
is a skipped column: its probability is an exact 0 in P (the plain version
masks with -inf, which gives the same 0), and the backward, which takes no
mask, relies on that.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distillclip_tpu_torch.ops import _build
from distillclip_tpu_torch.ops.transform_attention import MAX_SEQ, _check_head_dim, _split_heads

MAX_HEAD_DIM = 128
# what plain_attention_long takes: heads of 64, up to 1024 tokens (577 at
# ViT-L/14@336px, the longest published CLIP geometry)
LONG_HEAD_DIM = 64
LONG_MAX_SEQ = 1024


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, N, d]`` -> ``[B·N, H·d]`` rows."""
    B, H, N, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * N, H * d)


def attention_mask(seq: int, causal: bool, kv_len: Optional[int], device) -> torch.Tensor:
    """``[seq, seq]`` bool, True where query i may see key j."""
    j = torch.arange(seq, device=device)
    keep = (j < (seq if kv_len is None else kv_len)).expand(seq, seq)
    if causal:
        keep = keep & (j[None, :] <= j[:, None])
    return keep


def plain_attention_save_p_plain(qkv: torch.Tensor, *, heads: int, seq: int, scale: float,
                                 causal: bool = False, kv_len: Optional[int] = None):
    """The same math in fp32 PyTorch: (o ``[B·N, H·d]``, P ``[B, H, N, N]``),
    both in qkv's dtype; masked entries of P are exactly 0."""
    q, k, v = _split_heads(qkv, heads, seq)
    s = q @ k.transpose(-1, -2) * scale                              # [B, H, N, N]
    s = s.masked_fill(~attention_mask(seq, causal, kv_len, qkv.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _merge_heads(p @ v).to(qkv.dtype), p.to(qkv.dtype)


def plain_attention_rows_qkv_plain(qkv: torch.Tensor, *, heads: int, seq: int, scale: float,
                                   causal: bool = False,
                                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the output only."""
    return plain_attention_save_p_plain(qkv, heads=heads, seq=seq, scale=scale,
                                        causal=causal, kv_len=kv_len)[0]


def plain_attention_bwd_plain(qkv, do, p, *, heads: int, seq: int, scale: float):
    """Plain PyTorch version of the backward kernel, by its explicit formulas
    in fp32 from the saved P: dqkv in qkv's dtype."""
    rows = qkv.shape[0]
    q, k, v = _split_heads(qkv, heads, seq)
    B, _, _, d = q.shape
    p32 = p.float()
    do4 = do.float().view(B, seq, heads, d).permute(0, 2, 1, 3)      # [B, H, N, d]
    dv = p32.transpose(-1, -2) @ do4
    dp = do4 @ v.transpose(-1, -2)
    ds = scale * p32 * (dp - (p32 * dp).sum(-1, keepdim=True))
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, 3 * heads * d)
    return dqkv.to(qkv.dtype)


def _check_shapes(qkv, heads: int, seq: int, kv_len: Optional[int]) -> int:
    if qkv.ndim != 2 or qkv.shape[1] % (3 * heads) or seq < 1 or qkv.shape[0] % seq:
        raise ValueError(f"plain_attention_rows_qkv: qkv [B*{seq}, 3*{heads}*d], got "
                         f"{tuple(qkv.shape)}")
    if kv_len is not None and not 1 <= kv_len <= seq:
        raise ValueError(f"plain_attention_rows_qkv: kv_len must be in [1, {seq}], "
                         f"got {kv_len}")
    return qkv.shape[1] // 3 // heads


def _check_kernel_limits(what: str, seq: int, d: int) -> None:
    _check_head_dim(d, what)
    if d > MAX_HEAD_DIM or seq > MAX_SEQ:
        raise ValueError(f"{what}: the kernel takes head dims up to {MAX_HEAD_DIM} and "
                         f"sequences up to {MAX_SEQ}, got d={d}, seq={seq}")


def _launch_fwd(wrapper, qkv, heads, seq, scale, causal, kv_len, save_p: bool):
    """The forward kernel on a CUDA tensor, with or without its save-P flag,
    counted on ``wrapper``; returns (o, P or None)."""
    what = wrapper.__name__
    rows, hd3 = qkv.shape
    d = hd3 // 3 // heads
    _build.check_operands(what, qkv)
    _check_kernel_limits(what, seq, d)
    lib = _build.lib()
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    p = None
    if save_p:
        p = torch.empty((rows // seq, heads, seq, seq), dtype=qkv.dtype, device=qkv.device)
    if rows == 0:
        return out, p
    _build.check(lib.dc_plain_attention(qkv.data_ptr(), out.data_ptr(),
                                        None if p is None else p.data_ptr(), rows // seq,
                                        seq, heads, d, float(scale), int(bool(causal)),
                                        seq if kv_len is None else int(kv_len),
                                        _build.stream_ptr(qkv)), what)
    wrapper.launches += 1
    return out, p


def plain_attention_save_p(qkv, *, heads: int, seq: int, scale: float, causal: bool = False,
                           kv_len: Optional[int] = None):
    """(o, P): the forward kernel with its save-P flag on a CUDA tensor,
    :func:`plain_attention_save_p_plain` on the CPU."""
    _check_shapes(qkv, heads, seq, kv_len)
    if _build.plain_only("plain_attention_save_p", qkv):
        return plain_attention_save_p_plain(qkv, heads=heads, seq=seq, scale=scale,
                                            causal=causal, kv_len=kv_len)
    return _launch_fwd(plain_attention_save_p, qkv, heads, seq, scale, causal, kv_len, True)


def plain_attention_bwd(qkv, do, p, *, heads: int, seq: int, scale: float):
    """dqkv from the saved P: the backward kernel on CUDA tensors,
    :func:`plain_attention_bwd_plain` on the CPU."""
    d = _check_shapes(qkv, heads, seq, None)
    if _build.plain_only("plain_attention_bwd", qkv):
        return plain_attention_bwd_plain(qkv, do, p, heads=heads, seq=seq, scale=scale)
    do = do.contiguous()
    _build.check_operands("plain_attention_bwd", qkv, do, unaligned=(p,))
    _check_kernel_limits("plain_attention_bwd", seq, d)
    rows = qkv.shape[0]
    B = rows // seq
    if do.shape != (rows, heads * d) or p.shape != (B, heads, seq, seq):
        raise ValueError(f"plain_attention_bwd: do [{rows}, {heads * d}] and P "
                         f"[{B}, {heads}, {seq}, {seq}], got {tuple(do.shape)}, "
                         f"{tuple(p.shape)}")
    dqkv = torch.empty_like(qkv)
    if rows > 0:
        _build.check(_build.lib().dc_plain_attention_bwd(
            qkv.data_ptr(), do.data_ptr(), p.data_ptr(), dqkv.data_ptr(), B, seq, heads, d,
            float(scale), _build.stream_ptr(qkv)), "plain_attention_bwd")
        plain_attention_bwd.launches += 1
    return dqkv


class _PlainAttention(torch.autograd.Function):
    """After ``_flash_bd_fwd`` / ``_flash_bd_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, qkv, heads, seq, scale, causal, kv_len):
        o, p = plain_attention_save_p(qkv, heads=heads, seq=seq, scale=scale, causal=causal,
                                      kv_len=kv_len)
        ctx.save_for_backward(qkv, p)
        ctx.args = (heads, seq, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, p = ctx.saved_tensors
        heads, seq, scale = ctx.args
        dqkv = plain_attention_bwd(qkv, do, p, heads=heads, seq=seq, scale=scale)
        return dqkv, None, None, None, None, None


def plain_attention_rows_qkv(qkv: torch.Tensor, *, heads: int, seq: int,
                             scale: Optional[float] = None, causal: bool = False,
                             kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain (optionally causal) attention; ``scale`` defaults to d ** -0.5.
    Differentiable in qkv."""
    d = _check_shapes(qkv, heads, seq, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _build.needs_grad(qkv):
        return _PlainAttention.apply(qkv, heads, seq, scale, causal, kv_len)
    if _build.plain_only("plain_attention_rows_qkv", qkv):
        return plain_attention_rows_qkv_plain(qkv, heads=heads, seq=seq, scale=scale,
                                              causal=causal, kv_len=kv_len)
    return _launch_fwd(plain_attention_rows_qkv, qkv, heads, seq, scale, causal, kv_len,
                       False)[0]


def plain_attention_long(qkv: torch.Tensor, *, heads: int, seq: int,
                         scale: Optional[float] = None, causal: bool = False,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Unmasked attention of the fused rows without a gradient, for any
    sequence up to :data:`LONG_MAX_SEQ` at heads of :data:`LONG_HEAD_DIM`
    (the EVA-02 tower past 256 tokens): the long-row kernel on a CUDA tensor,
    :func:`plain_attention_rows_qkv_plain` on the CPU.  ``scale`` defaults to
    d ** -0.5.  It refuses a mask (``causal``, ``kv_len``), another head dim,
    a longer sequence and a gradient, on every device."""
    what = "plain_attention_long"
    d = _check_shapes(qkv, heads, seq, kv_len)
    if causal or kv_len is not None:
        raise ValueError(f"{what}: the kernel takes unmasked attention only, got "
                         f"causal={causal}, kv_len={kv_len}")
    if d != LONG_HEAD_DIM or seq > LONG_MAX_SEQ:
        raise ValueError(f"{what}: the kernel takes heads of {LONG_HEAD_DIM} and sequences "
                         f"up to {LONG_MAX_SEQ}, got d={d}, seq={seq}")
    if _build.needs_grad(qkv):
        raise ValueError(f"{what}: forward only; the kernel has no backward")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _build.plain_only(what, qkv):
        return plain_attention_rows_qkv_plain(qkv, heads=heads, seq=seq, scale=scale)
    _build.check_operands(what, qkv)
    rows = qkv.shape[0]
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    if rows > 0:
        _build.check(_build.lib().dc_plain_attention_long(
            qkv.data_ptr(), out.data_ptr(), rows // seq, seq, heads, d, float(scale),
            _build.stream_ptr(qkv)), what)
        plain_attention_long.launches += 1
    return out


plain_attention_rows_qkv.launches = 0
plain_attention_long.launches = 0
plain_attention_save_p.launches = 0
plain_attention_bwd.launches = 0
