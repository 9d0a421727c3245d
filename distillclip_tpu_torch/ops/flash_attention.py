"""Attention on ``[B, H, N, d]`` operands with the row logsumexp as residual.

Port of ``distillclip_tpu/ops/flash_attention.py::flash_attention`` and
``reference_attention``: the attention the towers run when they collect
hidden states (``need_rep`` without an attention tap).  Per sample and head,
softmax(q·kᵀ·scale + mask)·v, where the mask hides the keys ``j >= kv_len``
and, when ``causal``, the keys ``j > i``; with ``head_transform=(Wl, Ww)`` the
scaled scores are mixed across heads by ``Wl`` before the softmax and the
probabilities by ``Ww`` after it (the weight-share students' conv_l / conv_w).

Three kernels, each beside its plain PyTorch version:

* :func:`flash_attention_fwd` (``csrc/flash_attention.cu``): o and the row
  logsumexp ``lse`` ``[B, H, N]`` fp32, both products on the tensor cores
  (the routine of ``csrc/mma_attention.cuh``, shared with the fused-qkv
  forward of ``ops.plain_attention``);
* :func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``): dq, dk, dv
  from q, k, v, o, lse and do, the probabilities recomputed as
  exp(s - lse), so no ``[B, H, N, N]`` tensor exists in either direction;
  every product on the tensor cores (the routine of
  ``csrc/mma_attention_bwd.cuh``);
* :func:`flash_transform_attention_fwd` (``csrc/flash_transform_attention_mma.cu``):
  the head-transform forward, on the tensor cores on K3's tile loop
  (``csrc/transform_attention_mma.cuh``) at the head shapes K3 takes (up to
  32 heads of 32 and 16 of 128, :func:`tensor_core_head_shape`), and past
  them, by shape, on its second route :func:`flash_transform_attention_fwd_wide`
  (``csrc/flash_transform_attention.cu``, the CUDA cores, any head count
  whose planes fit a block), which counts its own launches.  Its gradient is
  the JAX package's: a recompute of the forward in plain fp32 PyTorch
  (outside any kernel there too).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it runs
its plain version.  The kernels take bf16 views with unit stride in d and any
batch, head and row strides that are multiples of 8: a contiguous tensor and
the permuted view of a fused ``[B, N, 3, H, d]`` projection both go in without
a copy, and the output comes back in q's layout (heads inside rows when q's
are, so the ``[B·N, H·d]`` rows an output projection wants are a view of it).
Any head count, ``d`` a multiple of 8 up to 128, ``N`` up to 256.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from distillclip_tpu_torch.ops import _build
from distillclip_tpu_torch.ops.plain_attention import MAX_HEAD_DIM, MAX_SEQ, attention_mask
from distillclip_tpu_torch.ops.transform_attention import _check_head_dim, _pick_tq

NEG_INF = -1e9


def _masked_scores(q, k, scale: float, causal: bool, kv_len: Optional[int],
                   head_transform=None) -> torch.Tensor:
    """fp32 ``[B, H, N, N]`` scaled scores, mixed by ``Wl`` when given, with
    ``NEG_INF`` added at the hidden keys (the JAX package's finite mask)."""
    N = q.shape[2]
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if head_transform is not None:
        s = torch.einsum("hg,bgnm->bhnm", head_transform[0].float(), s)
    if causal or (kv_len is not None and kv_len < N):
        keep = attention_mask(N, causal, kv_len, q.device)
        s = s + torch.where(keep, 0.0, NEG_INF)
    return s


def reference_attention(q, k, v, *, scale: Optional[float] = None, causal: bool = False,
                        head_transform=None, kv_len: Optional[int] = None) -> torch.Tensor:
    """Unfused attention with the same math, in fp32, result in q's dtype: the
    plain version of :func:`flash_attention`, differentiable by autograd."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_masked_scores(q, k, scale, causal, kv_len, head_transform), dim=-1)
    if head_transform is not None:
        p = torch.einsum("hg,bgnm->bhnm", head_transform[1].float(), p)
    return (p @ v.float()).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, *, scale: float, causal: bool = False,
                              kv_len: Optional[int] = None):
    """Plain PyTorch version of the forward kernel: (o in q's dtype, lse fp32
    ``[B, H, N]``)."""
    s = _masked_scores(q, k, scale, causal, kv_len)
    lse = torch.logsumexp(s, dim=-1)
    return (torch.exp(s - lse[..., None]) @ v.float()).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, scale: float, causal: bool = False,
                              kv_len: Optional[int] = None):
    """Plain PyTorch version of the backward kernel, by its explicit formulas
    in fp32: (dq, dk, dv) in q's dtype."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(_masked_scores(q, k, scale, causal, kv_len) - lse[..., None])
    dv = p.transpose(-1, -2) @ do32
    dp = do32 @ v32.transpose(-1, -2)
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return ((ds @ k32).to(q.dtype), (ds.transpose(-1, -2) @ q32).to(q.dtype), dv.to(q.dtype))


def flash_transform_attention_fwd_plain(q, k, v, wl, ww, *, scale: float,
                                        causal: bool = False,
                                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the head-transform forward kernel."""
    return reference_attention(q, k, v, scale=scale, causal=causal, head_transform=(wl, ww),
                               kv_len=kv_len)


def _check_shapes(what: str, q, k, v, kv_len: Optional[int]) -> Tuple[int, int, int, int]:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one [B, H, N, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, d = q.shape
    if N > MAX_SEQ:
        raise ValueError(f"short-sequence fused attention requires N<={MAX_SEQ}, got {N}")
    if kv_len is not None and not 1 <= kv_len <= N:
        raise ValueError(f"{what}: kv_len must be in [1, {N}], got {kv_len}")
    return B, H, N, d


def _kernel_view(what: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: bf16 on the card, unit stride in d, the
    other strides multiples of 8 and the first element 16-byte aligned.  A
    view that is not (a transposed d, an odd offset) is copied."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes torch.bfloat16 here, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _check_kernel_operands(what: str, d: int, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every operand must be on {dev}, got {t.device}")
    _check_head_dim(d, what)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head dims up to {MAX_HEAD_DIM}, got d={d}")


def _strides(*tensors):
    """(batch, head, row) element strides of each ``[B, H, N, d]`` view, as
    the C array the entry points read."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _empty_like_layout(q: torch.Tensor, n: int = 1):
    """``n`` new ``[B, H, N, d]`` tensors in q's layout: heads inside rows
    (views of one ``[B, N, n, H, d]`` buffer) when q's are, else contiguous."""
    B, H, N, d = q.shape
    if q.stride(2) > q.stride(1):
        buf = torch.empty((B, N, n, H, d), dtype=q.dtype, device=q.device)
        return [buf[:, :, i].permute(0, 2, 1, 3) for i in range(n)]
    return [torch.empty((B, H, N, d), dtype=q.dtype, device=q.device) for _ in range(n)]


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = False,
                        kv_len: Optional[int] = None):
    """(o, lse): the forward kernel on CUDA tensors,
    :func:`flash_attention_fwd_plain` on the CPU."""
    what = "flash_attention_fwd"
    B, H, N, d = _check_shapes(what, q, k, v, kv_len)
    if _build.plain_only(what, q):
        return flash_attention_fwd_plain(q, k, v, scale=scale, causal=causal, kv_len=kv_len)
    _check_kernel_operands(what, d, q, k, v)
    q, k, v = (_kernel_view(what, t) for t in (q, k, v))
    lib = _build.lib()
    (o,) = _empty_like_layout(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if q.numel():
        _build.check(lib.dc_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), B, N, H, d, float(scale), int(bool(causal)),
            N if kv_len is None else int(kv_len), _build.stream_ptr(q)), what)
        flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool = False,
                        kv_len: Optional[int] = None):
    """(dq, dk, dv) from the forward's output and logsumexp: the backward
    kernel on CUDA tensors, :func:`flash_attention_bwd_plain` on the CPU."""
    what = "flash_attention_bwd"
    B, H, N, d = _check_shapes(what, q, k, v, kv_len)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, N):
        raise ValueError(f"{what}: o and do {tuple(q.shape)} and lse {(B, H, N)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if _build.plain_only(what, q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale, causal=causal,
                                         kv_len=kv_len)
    _check_kernel_operands(what, d, q, k, v, o, lse, do)
    if lse.dtype != torch.float32:
        raise TypeError(f"{what}: lse must be torch.float32, got {lse.dtype}")
    q, k, v, o, do = (_kernel_view(what, t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    lib = _build.lib()
    dq, dk, dv = _empty_like_layout(q, 3)
    if q.numel():
        _build.check(lib.dc_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, o, do, dq, dk, dv), B, N, H, d, float(scale),
            int(bool(causal)), N if kv_len is None else int(kv_len), _build.stream_ptr(q)),
            what)
        flash_attention_bwd.launches += 1
    return dq, dk, dv


def tensor_core_head_shape(heads: int, d: int) -> bool:
    """True where the tensor-core head-transform forward takes ``heads`` heads
    of ``d``: d a multiple of 8 up to 128, at most 32 heads, 16 once d > 32
    (every head of a 16 x 16 tile in one block), as K3 takes them.  The
    Python statement of the library's predicate
    (``dc_flash_tf_fwd_mma_smem_bytes``), which the wrapper asks."""
    return d % 8 == 0 and 8 <= d <= 128 and 1 <= heads <= (16 if d > 32 else 32)


def _tensor_core_shape(lib, heads: int, d: int) -> bool:
    """True where the library's tensor-core forward takes (heads, d)."""
    smem = lib.dc_flash_tf_fwd_mma_smem_bytes(heads, d)
    return 0 <= smem <= _build.MAX_SMEM_BYTES


def _check_mixes(what: str, wl, ww, H: int) -> None:
    if wl.shape != (H, H) or ww.shape != (H, H):
        raise ValueError(f"{what}: [{H}, {H}] mixes, got {tuple(wl.shape)}, {tuple(ww.shape)}")


def _check_kernel_mixes(what: str, wl, ww) -> None:
    for w in (wl, ww):
        if w.dtype != torch.bfloat16 or not w.is_contiguous():
            raise TypeError(f"{what}: the mixes must be contiguous torch.bfloat16, got "
                            f"{w.dtype}, strides {w.stride()}")


def flash_transform_attention_fwd(q, k, v, wl, ww, *, scale: float, causal: bool = False,
                                  kv_len: Optional[int] = None) -> torch.Tensor:
    """The head-transform forward on CUDA tensors: the tensor-core kernel where
    it takes the head shape, :func:`flash_transform_attention_fwd_wide`
    otherwise; :func:`flash_transform_attention_fwd_plain` on the CPU."""
    what = "flash_transform_attention_fwd"
    B, H, N, d = _check_shapes(what, q, k, v, kv_len)
    _check_mixes(what, wl, ww, H)
    if _build.plain_only(what, q):
        return flash_transform_attention_fwd_plain(q, k, v, wl, ww, scale=scale,
                                                   causal=causal, kv_len=kv_len)
    _check_kernel_operands(what, d, q, k, v, wl, ww)
    lib = _build.lib()
    if not _tensor_core_shape(lib, H, d):
        return flash_transform_attention_fwd_wide(q, k, v, wl, ww, scale=scale, causal=causal,
                                                  kv_len=kv_len)
    # k and v go to TMA maps, which take no zero stride along a dim longer than 1
    q, k, v = (_kernel_view(what, t) for t in (q, k, v))
    k, v = (t.contiguous() if any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))
            else t for t in (k, v))
    _check_kernel_mixes(what, wl, ww)
    (o,) = _empty_like_layout(q)
    if q.numel():
        _build.check(lib.dc_flash_transform_attention_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wl.data_ptr(), ww.data_ptr(),
            o.data_ptr(), _strides(q, k, v, o), B, N, H, d, float(scale), int(bool(causal)),
            N if kv_len is None else int(kv_len), _build.stream_ptr(q)), what)
        flash_transform_attention_fwd.launches += 1
    return o


def flash_transform_attention_fwd_wide(q, k, v, wl, ww, *, scale: float, causal: bool = False,
                                       kv_len: Optional[int] = None) -> torch.Tensor:
    """The head-transform forward's second route, the CUDA-core kernel
    (``csrc/flash_transform_attention.cu``), for the head shapes the
    tensor-core kernel does not take; any head count whose score tile fits a
    block, d up to 128.  :func:`flash_transform_attention_fwd` sends those
    shapes here; :func:`flash_transform_attention_fwd_plain` on the CPU."""
    what = "flash_transform_attention_fwd_wide"
    B, H, N, d = _check_shapes(what, q, k, v, kv_len)
    _check_mixes(what, wl, ww, H)
    if _build.plain_only(what, q):
        return flash_transform_attention_fwd_plain(q, k, v, wl, ww, scale=scale,
                                                   causal=causal, kv_len=kv_len)
    _check_kernel_operands(what, d, q, k, v, wl, ww)
    q, k, v = (_kernel_view(what, t) for t in (q, k, v))
    _check_kernel_mixes(what, wl, ww)
    lib = _build.lib()
    tq = _pick_tq(lib, lib.dc_fta_smem_bytes, N, H, d, what)
    (o,) = _empty_like_layout(q)
    if q.numel():
        _build.check(lib.dc_flash_transform_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wl.data_ptr(), ww.data_ptr(),
            o.data_ptr(), _strides(q, k, v, o), B, N, H, d, tq, float(scale),
            int(bool(causal)), N if kv_len is None else int(kv_len), _build.stream_ptr(q)),
            what)
        flash_transform_attention_fwd_wide.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    """After ``_flash_packed_fwd`` / ``_flash_packed_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, kv_len = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, scale=scale, causal=causal,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None


class _FlashTransformAttention(torch.autograd.Function):
    """After ``_flash_tf_fwd`` / ``_flash_tf_bwd`` of the JAX package: the
    backward recomputes the forward in plain fp32 and differentiates that."""

    @staticmethod
    def forward(ctx, q, k, v, wl, ww, scale, causal, kv_len):
        ctx.save_for_backward(q, k, v, wl, ww)
        ctx.args = (scale, causal, kv_len)
        return flash_transform_attention_fwd(q, k, v, wl, ww, scale=scale, causal=causal,
                                             kv_len=kv_len)

    @staticmethod
    def backward(ctx, do):
        scale, causal, kv_len = ctx.args
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            q, k, v, wl, ww = leaves
            o = reference_attention(q, k, v, scale=scale, causal=causal,
                                    head_transform=(wl, ww), kv_len=kv_len)
        grads = torch.autograd.grad(o, leaves, do)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = False,
                    head_transform: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Fused attention for ``[B, H, N, d]`` inputs (N <= 256); ``scale``
    defaults to d ** -0.5.  ``head_transform=(Wl, Ww)`` applies the ``[H, H]``
    mixes to the scores and to the probabilities.  ``kv_len`` is the number of
    valid keys when the caller padded the sequence.  Differentiable in q, k, v
    and both mixes."""
    _, _, _, d = _check_shapes("flash_attention", q, k, v, kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if head_transform is not None:
        wl, ww = head_transform
        if _build.needs_grad(q, k, v, wl, ww):
            return _FlashTransformAttention.apply(q, k, v, wl, ww, scale, causal, kv_len)
        return flash_transform_attention_fwd(q, k, v, wl, ww, scale=scale, causal=causal,
                                             kv_len=kv_len)
    if _build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale, causal, kv_len)
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal, kv_len=kv_len)[0]


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_transform_attention_fwd.launches = 0
flash_transform_attention_fwd_wide.launches = 0
