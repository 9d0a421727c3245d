"""Head-transform attention on the fused qkv projection, forward and backward.

Port of ``distillclip_tpu/ops/transform_attention.py::
transform_attention_rows_qkv``: per sample, scores q_h·k_hᵀ, a mix across
heads by ``wl`` [H, H] (conv_l) before the softmax, a per-head softmax over
keys, a mix of the probabilities by ``ww`` [H, H] (conv_w), then the product
with v.  ``qkv`` is ``[B·seq, 3·H·d]`` (q | k | v column blocks, head-major
inside each) and the result ``[B·seq, H·d]``.

On a CUDA tensor it launches K3 at the true sequence length: the
tensor-core kernel (``csrc/transform_attention_mma.cu``) where it takes the
head shape (head dim a multiple of 8, at most 32 heads up to a head dim of
32 and 16 up to 128; any length), and otherwise, by shape, its second route
:func:`transform_attention_rows_qkv_wide` (``csrc/transform_attention.cu``,
the CUDA cores, any head count), which counts its own launches.  On a CPU
tensor it runs :func:`transform_attention_rows_qkv_plain`.

With a gradient it is a ``torch.autograd.Function`` whose forward saves the
per-head softmax probabilities P ``[B, H, N, N]`` (after the softmax, before
the ``ww`` mix) in qkv's dtype and whose backward makes the fused dqkv and the
two mix gradients from qkv, the output gradient and P.  The mix gradients
leave the kernels as fp32 ``[H, H]`` and are cast to the parameters' dtype, as
the JAX package casts them.  Two pairs of kernels do this, and the function
picks one by shape before anything runs (:func:`grad_route`) and remembers it
for its backward:

* the tensor cores (``"tensor_core"``): K3 with its save-P flag
  (:func:`transform_attention_save_p`, #5) and
  :func:`transform_attention_bwd` (#6, ``csrc/transform_attention_bwd.cu``),
  where #6 takes the shape (:func:`tensor_core_takes`): at most 32 heads of
  up to 32 and 16 heads of up to 128, 32 heads of 32 and 12 of 128 among
  them;
* the CUDA cores (``"wide"``) for every other head shape:
  :func:`transform_attention_save_p_wide` (K3's second route with its save-P
  flag) and :func:`transform_attention_bwd_wide`
  (``csrc/transform_attention_bwd_wide.cu``), where one query row's score
  planes of all H heads fit a block's shared memory
  (:func:`wide_route_takes`): at 256 tokens, 48 heads of 8 and 32 of 64
  among others.

Both take up to :data:`MAX_SEQ` tokens, as the JAX package's Pallas kernels
do; past that its towers, and the port's (``models.layers.attention_kernel_ok``),
materialise the attention instead.  A shape neither route takes is refused
with a ``ValueError`` before the forward runs.

The JAX package's ``tf_impl: factored`` route
(``ops/transform_factored.py::tf_factored_qkv``, kernel #18) computes the same
function head by head: per-head q·kᵀ products, the two head mixes, a per-head
softmax max.  That is how K3, #5 and #6 compute it already, at the true
sequence length, so under that knob the port runs them unchanged; the TPU
keeps two implementations only because its 128 × 128 matrix unit favours one
or the other by shape.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distillclip_tpu_torch.ops import _build

# The longest sequence the attention kernels with a gradient take (and the
# plain attention's, ops.plain_attention): the JAX package's Pallas attention
# kernels take up to 256 tokens, and its towers materialise the attention past
# that, as the port's do.
MAX_SEQ = 256


def _split_heads(qkv: torch.Tensor, heads: int, seq: int):
    """q, k, v as fp32 ``[B, H, N, d]`` views of the fused rows."""
    rows, hd3 = qkv.shape
    B, d = rows // seq, hd3 // 3 // heads
    qkv5 = qkv.float().view(B, seq, 3, heads, d).permute(2, 0, 3, 1, 4)  # [3, B, H, N, d]
    return qkv5[0], qkv5[1], qkv5[2]


def transform_attention_save_p_plain(qkv: torch.Tensor, wl: torch.Tensor, ww: torch.Tensor,
                                     *, heads: int, seq: int, scale: float):
    """The same math in fp32 PyTorch: (o ``[B·N, H·d]``, P ``[B, H, N, N]``),
    both in qkv's dtype."""
    q, k, v = _split_heads(qkv, heads, seq)
    s = q @ k.transpose(-1, -2)                                     # [B, H, N, N]
    s = torch.einsum("hg,bgnm->bhnm", wl.float(), s) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("hg,bgnm->bhnm", ww.float(), p) @ v            # [B, H, N, d]
    o = o.permute(0, 2, 1, 3).reshape(qkv.shape[0], -1)
    return o.to(qkv.dtype), p.to(qkv.dtype)


def transform_attention_rows_qkv_plain(qkv: torch.Tensor, wl: torch.Tensor,
                                       ww: torch.Tensor, *, heads: int, seq: int,
                                       scale: float) -> torch.Tensor:
    """Plain PyTorch version of K3: the output only."""
    return transform_attention_save_p_plain(qkv, wl, ww, heads=heads, seq=seq,
                                            scale=scale)[0]


def transform_attention_bwd_plain(qkv, wl, ww, do, p, *, heads: int, seq: int, scale: float):
    """Plain PyTorch version of the backward kernel, by its explicit formulas
    in fp32 from the saved P: (dqkv in qkv's dtype, dwl fp32, dww fp32)."""
    rows = qkv.shape[0]
    q, k, v = _split_heads(qkv, heads, seq)
    B, _, _, d = q.shape
    wl32, ww32, p32 = wl.float(), ww.float(), p.float()
    do4 = do.float().view(B, seq, heads, d).permute(0, 2, 1, 3)      # [B, H, N, d]
    pm = torch.einsum("hg,bgnm->bhnm", ww32, p32)
    dpm = do4 @ v.transpose(-1, -2)
    dv = pm.transpose(-1, -2) @ do4
    dww = torch.einsum("bhnm,bgnm->hg", dpm, p32)
    dp = torch.einsum("hg,bhnm->bgnm", ww32, dpm)
    ds2 = p32 * (dp - (p32 * dp).sum(-1, keepdim=True))
    dwl = scale * torch.einsum("bhnm,bgnm->hg", ds2, q @ k.transpose(-1, -2))
    ds = scale * torch.einsum("hg,bhnm->bgnm", wl32, ds2)
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, 3 * heads * d)
    return dqkv.to(qkv.dtype), dwl, dww


def _pick_tq(lib, smem_bytes, seq: int, heads: int, d: int,
             what: str = "transform_attention_rows_qkv") -> int:
    """Rows per block: as many as fit in shared memory by ``smem_bytes`` (at
    most the kernels' cap), then evened out over the tiles so the last one is
    full."""
    tq = min(lib.dc_tf_max_tq(), seq)
    while tq > 0 and smem_bytes(seq, heads, d, tq) > _build.MAX_SMEM_BYTES:
        tq -= 1
    if tq == 0:
        raise ValueError(f"{what}: the score tile of one query row, {heads} heads x {seq} keys "
                         f"(fp32 planes: two in the forward, three in the backward), does not "
                         f"fit in one block's {_build.MAX_SMEM_BYTES} bytes of shared memory")
    tiles = -(-seq // tq)
    return -(-seq // tiles)


def _check_shapes(qkv, wl, ww, heads, seq):
    rows, hd3 = qkv.shape
    if hd3 % (3 * heads) or rows % seq or wl.shape != (heads, heads) \
            or ww.shape != (heads, heads):
        raise ValueError(f"transform_attention_rows_qkv: qkv [B*{seq}, 3*{heads}*d] and "
                         f"[{heads}, {heads}] mixes, got {tuple(qkv.shape)}, "
                         f"{tuple(wl.shape)}, {tuple(ww.shape)}")
    return hd3 // 3 // heads


def _check_head_dim(d, what: str = "transform_attention_rows_qkv"):
    if d % 8:
        raise ValueError(f"{what}: head dim must be a multiple of 8, got {d}")


def _tc_takes(lib, seq: int, heads: int, d: int) -> bool:
    """True where the tensor-core backward (#6) takes (seq, heads, d)."""
    smem = lib.dc_tf_bwd_smem_bytes(seq, heads, d)
    return 0 <= smem <= _build.MAX_SMEM_BYTES


def _check_bwd_shape(lib, seq, heads, d, what: str):
    """Raise unless the tensor-core backward's kernels take (seq, heads, d):
    they hold every head of a 16 x 16 tile in one block."""
    if not _tc_takes(lib, seq, heads, d):
        raise ValueError(f"{what}: {heads} heads of {d} at {seq} tokens do not fit the "
                         f"tensor-core backward's kernels (at most 32 heads with d up to 32, "
                         f"16 with d up to 128, up to {MAX_SEQ} tokens); "
                         f"transform_attention_rows_qkv trains other head shapes on the "
                         f"CUDA-core pair (*_wide)")


def _tensor_core_shape(lib, heads: int, d: int) -> bool:
    """True where the tensor-core forward takes (heads, d)."""
    smem = lib.dc_tf_fwd_mma_smem_bytes(heads, d)
    return 0 <= smem <= _build.MAX_SMEM_BYTES


# bf16 planes of a head's 16 x 16 chunk tile in the tensor-core kernels: rows
# of 24 elements, planes of 392 (kPP, kXP, kBP in the sources)
_PLANE = 16 * 24 + 8


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def _tc_heads_per_warp(heads: int, d: int) -> int:
    """Heads a warp's items span in #5 / #6 (K3 too), 0 where they do not
    take (heads, d): d a multiple of 8, at most 32 heads with d up to 32 and
    16 with d up to 128."""
    ks, hpw = _pad16(d) // 16, -(-heads // 16)
    if not (1 <= heads <= 32 and 8 <= d and d % 8 == 0 and ks <= 8) or (hpw == 2 and ks > 2):
        return 0
    return hpw


def _tc_fwd_smem(heads: int, d: int) -> int:
    """Shared memory of a block of the tensor-core forward (K3 / #5), as
    ``dc_tf_fwd_mma_smem_bytes`` counts it: two (or, where those do not fit,
    one) k and v chunks of 16 rows as 64-column TMA boxes, the q tile, the
    fp32 score plane X, P' hi / lo planes (none past 24 heads or d = 64,
    where P' lives in X), the two [H, H] mixes, the barriers and 1024 bytes
    to align the base."""
    pix = heads > 24 or d > 64
    kv = (heads * d + d % 16 + 63) // 64 * 2048
    pp = 0 if pix else heads * _PLANE * 2
    hp = _pad16(heads)
    q, x = heads * 16 * (_pad16(d) + 8) * 2, 16 * (16 * (hp + 8) + (4 if pix else 2)) * 4
    rest = q + x + 2 * pp + 2 * hp * (hp + 8) * 2 + 4 * 8 + 1024
    bufs = 1 if pix and 4 * kv + rest > _build.MAX_SMEM_BYTES else 2
    return 2 * bufs * kv + rest


def _tc_qk_smem(seq: int, heads: int, d: int) -> Optional[int]:
    """Shared memory of a block of #6's dq / dk kernel (its ``qk_plan``): the
    q and k rows of one or two heads (two where their key tiles fit the warps'
    slots and two blocks an SM) whole, up to 64 columns of d, and dS hi / lo
    in row chunks; None past 256 tokens (more key tiles than the slots)."""
    n = _pad16(seq)
    ld = _pad16(min(d, 64)) + 8
    size = lambda g, r: g * (2 * n * ld + 2 * r * (n + 8)) * 2
    if heads >= 2 and n // 16 <= 8 and size(2, n) <= _build.MAX_SMEM_BYTES // 2:
        return size(2, n)
    if n // 16 > 16:
        return None
    r = n
    while r > 16 and size(1, r) > _build.MAX_SMEM_BYTES:
        r -= 16
    return size(1, r) if size(1, r) <= _build.MAX_SMEM_BYTES else None


def _tc_bwd_smem(seq: int, heads: int, d: int) -> Optional[int]:
    """Shared memory of the largest block of the tensor-core backward (#6),
    as ``dc_tf_bwd_smem_bytes`` counts it: the row kernel (fp32 X and Y, δ,
    P's words, the v and k chunks, the two mixes; the dO and q tiles stay in
    registers), the column kernel and the dq / dk kernel."""
    hpw, ld, hp = _tc_heads_per_warp(heads, d), _pad16(d) + 8, _pad16(heads)
    xy = max(2 * heads * _PLANE * 4, 16 * (16 * hpw) ** 2 * 4)
    mixes = 2 * hp * (hp + 8) * 2
    rows = (xy + 16 * hp * 4 + heads * _PLANE * 2
            + heads * 2 * 16 * ld * 2 + mixes)
    cols = heads * (2 * 16 * ld + 4 * _PLANE) * 2 + mixes // 2
    qk = _tc_qk_smem(seq, heads, d)
    return None if qk is None else max(rows, cols, qk)


def tensor_core_takes(seq: int, heads: int, d: int) -> bool:
    """True where the tensor-core pair (#5 and #6) trains heads of ``d`` at
    ``seq`` tokens: d a multiple of 8, at most 32 heads with d up to 32 and
    16 with d up to 128, up to :data:`MAX_SEQ` tokens, every block within a
    block's shared memory.  A statement for the tests, which hold it to the
    library's limits (``dc_tf_bwd_smem_bytes``, ``dc_tf_fwd_mma_smem_bytes``)
    on the card and pin the routes by it on the CPU; nothing in the package
    calls it: the wrappers and :func:`grad_route` ask the library, so a
    change of the kernels' layout is made in both."""
    if _tc_heads_per_warp(heads, d) == 0 or not 1 <= seq <= MAX_SEQ:
        return False
    bwd = _tc_bwd_smem(seq, heads, d)
    return bwd is not None and max(bwd, _tc_fwd_smem(heads, d)) <= _build.MAX_SMEM_BYTES


def _wide_smem(seq: int, heads: int, d: int, tq: int, planes: int) -> int:
    """Shared memory of a block of the CUDA-core route at ``tq`` query rows:
    the q (dO) tile, ``planes`` [H, H] mixes and ``planes`` fp32 [H, tq, N]
    score planes (two in the forward, three in the backward's first kernel),
    as ``dc_tf_smem_bytes`` and ``dc_tf_bwd_wide_smem_bytes`` count them."""
    pad4 = (heads + 3) // 4 * 4
    return tq * heads * d * 2 + planes * heads * pad4 * 4 + planes * heads * tq * seq * 4


def wide_route_takes(seq: int, heads: int, d: int) -> bool:
    """True where the CUDA-core pair (#5 and #6's second route) trains heads
    of ``d`` at ``seq`` tokens: d a multiple of 8, up to :data:`MAX_SEQ`
    tokens, and one query row's three backward planes of all heads within a
    block's shared memory.  The Python statement of the library's limits
    (``dc_tf_smem_bytes``, ``dc_tf_bwd_wide_smem_bytes`` at one row), which
    the wrappers ask."""
    return (d % 8 == 0 and 1 <= seq <= MAX_SEQ
            and _wide_smem(seq, heads, d, 1, 3) <= _build.MAX_SMEM_BYTES)


def _check_seq(seq: int, what: str) -> None:
    if seq > MAX_SEQ:
        raise ValueError(f"{what}: the training kernels take up to {MAX_SEQ} tokens, as the "
                         f"JAX package's do (its towers and the port's materialise the "
                         f"attention past that), got {seq}")


def grad_route(qkv: torch.Tensor, heads: int, seq: int) -> str:
    """The kernels that train this call, chosen by shape before anything
    runs: ``"plain"`` on the CPU, ``"tensor_core"`` where #6 takes the shape,
    else ``"wide"``, whose save-P forward refuses before it launches what
    neither pair takes (past :data:`MAX_SEQ` tokens, or one row's planes past
    shared memory)."""
    what = "transform_attention_rows_qkv"
    if _build.plain_only(what, qkv):
        return "plain"
    d = qkv.shape[1] // 3 // heads
    _check_head_dim(d, what)
    return "tensor_core" if _tc_takes(_build.lib(), seq, heads, d) else "wide"


def _launch_fwd(wrapper, qkv, wl, ww, heads, seq, scale, save_p: bool):
    """The tensor-core K3 on CUDA tensors, with or without its save-P flag,
    counted on ``wrapper``; returns (o, P or None).  The save-P forward exists
    for the backward, so it refuses what the backward would refuse, before it
    runs."""
    what = wrapper.__name__
    rows, hd3 = qkv.shape
    d = hd3 // 3 // heads
    _build.check_operands(what, qkv, unaligned=(wl, ww))
    _check_head_dim(d)
    lib = _build.lib()
    if save_p:
        _check_bwd_shape(lib, seq, heads, d, what)
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    p = None
    if save_p:
        p = torch.empty((rows // seq, heads, seq, seq), dtype=qkv.dtype, device=qkv.device)
    if rows == 0:
        return out, p
    _build.check(lib.dc_transform_attention_mma(
        qkv.data_ptr(), wl.data_ptr(), ww.data_ptr(), out.data_ptr(),
        None if p is None else p.data_ptr(), rows // seq, seq, heads, d, float(scale),
        _build.stream_ptr(qkv)), what)
    wrapper.launches += 1
    return out, p


def _launch_wide_fwd(wrapper, qkv, wl, ww, heads, seq, scale, save_p: bool):
    """K3's CUDA-core route on CUDA tensors, with or without its save-P flag,
    counted on ``wrapper``; returns (o, P or None).  The save-P mode refuses
    what the CUDA-core backward would refuse, before it runs."""
    what = wrapper.__name__
    rows = qkv.shape[0]
    d = _check_shapes(qkv, wl, ww, heads, seq)
    _build.check_operands(what, qkv, unaligned=(wl, ww))
    _check_head_dim(d, what)
    lib = _build.lib()
    if save_p:
        _check_seq(seq, what)
        _pick_tq(lib, lib.dc_tf_bwd_wide_smem_bytes, seq, heads, d, what)
    tq = _pick_tq(lib, lib.dc_tf_smem_bytes, seq, heads, d, what)
    out = torch.empty((rows, heads * d), dtype=qkv.dtype, device=qkv.device)
    p = None
    if save_p:
        p = torch.empty((rows // seq, heads, seq, seq), dtype=qkv.dtype, device=qkv.device)
    if rows == 0:
        return out, p
    _build.check(lib.dc_transform_attention(
        qkv.data_ptr(), wl.data_ptr(), ww.data_ptr(), out.data_ptr(),
        None if p is None else p.data_ptr(), rows // seq, seq, heads, d, tq, float(scale),
        _build.stream_ptr(qkv)), what)
    wrapper.launches += 1
    return out, p


def transform_attention_save_p(qkv, wl, ww, *, heads: int, seq: int, scale: float):
    """(o, P): K3 with its save-P flag on CUDA tensors,
    :func:`transform_attention_save_p_plain` on the CPU."""
    if _build.plain_only("transform_attention_save_p", qkv):
        return transform_attention_save_p_plain(qkv, wl, ww, heads=heads, seq=seq, scale=scale)
    return _launch_fwd(transform_attention_save_p, qkv, wl, ww, heads, seq, scale, True)


def transform_attention_rows_qkv_wide(qkv, wl, ww, *, heads: int, seq: int, scale: float):
    """K3's second route, the CUDA-core kernel (``csrc/transform_attention.cu``),
    for the head shapes the tensor-core kernel does not take; any head shape
    whose score tile fits a block.  The lean forward sends those shapes here;
    :func:`transform_attention_rows_qkv_plain` on the CPU."""
    what = "transform_attention_rows_qkv_wide"
    if _build.plain_only(what, qkv):
        return transform_attention_rows_qkv_plain(qkv, wl, ww, heads=heads, seq=seq,
                                                  scale=scale)
    return _launch_wide_fwd(transform_attention_rows_qkv_wide, qkv, wl, ww, heads, seq, scale,
                            False)[0]


def transform_attention_save_p_wide(qkv, wl, ww, *, heads: int, seq: int, scale: float):
    """(o, P): #5's second route, the CUDA-core kernel with its save-P flag,
    for the head shapes that train on :func:`transform_attention_bwd_wide`
    (:func:`wide_route_takes`); :func:`transform_attention_save_p_plain` on
    the CPU.  o is the lean route's bits."""
    if _build.plain_only("transform_attention_save_p_wide", qkv):
        return transform_attention_save_p_plain(qkv, wl, ww, heads=heads, seq=seq, scale=scale)
    return _launch_wide_fwd(transform_attention_save_p_wide, qkv, wl, ww, heads, seq, scale,
                            True)


def transform_attention_bwd(qkv, wl, ww, do, p, *, heads: int, seq: int, scale: float):
    """(dqkv, dwl fp32, dww fp32) from the saved P: the backward kernels on
    CUDA tensors (a row kernel, a dq kernel, a column kernel and the reduction
    of the mix gradients' partials, one wrapper launch),
    :func:`transform_attention_bwd_plain` on the CPU."""
    if _build.plain_only("transform_attention_bwd", qkv):
        return transform_attention_bwd_plain(qkv, wl, ww, do, p, heads=heads, seq=seq,
                                             scale=scale)
    do = do.contiguous()
    _build.check_operands("transform_attention_bwd", qkv, do, unaligned=(wl, ww, p))
    rows, hd3 = qkv.shape
    d = hd3 // 3 // heads
    _check_head_dim(d, "transform_attention_bwd")
    B = rows // seq
    lib = _build.lib()
    _check_bwd_shape(lib, seq, heads, d, "transform_attention_bwd")
    if p.data_ptr() % 16:
        raise ValueError("transform_attention_bwd: P must be 16-byte aligned (the kernels "
                         "copy its rows as the 16-byte words that hold them)")
    dqkv = torch.empty_like(qkv)
    grads = torch.zeros(2 * heads * heads, dtype=torch.float32, device=qkv.device)
    if rows > 0:
        padded = -(-seq // 16) * 16
        ds = torch.empty((2, B, heads, seq, padded), dtype=qkv.dtype, device=qkv.device)
        partial = torch.empty((B * padded // 16, 2 * heads * heads), dtype=torch.float32,
                              device=qkv.device)
        _build.check(lib.dc_transform_attention_bwd(
            qkv.data_ptr(), wl.data_ptr(), ww.data_ptr(), do.data_ptr(), p.data_ptr(),
            dqkv.data_ptr(), ds[0].data_ptr(), ds[1].data_ptr(), partial.data_ptr(),
            grads.data_ptr(), B, seq, heads, d, float(scale), _build.stream_ptr(qkv)),
            "transform_attention_bwd")
        transform_attention_bwd.launches += 1
    hh = heads * heads
    return dqkv, grads[:hh].view(heads, heads), grads[hh:].view(heads, heads)


def transform_attention_bwd_wide(qkv, wl, ww, do, p, *, heads: int, seq: int,
                                 scale: float):
    """(dqkv, dwl fp32, dww fp32) from the P that
    :func:`transform_attention_save_p_wide` saved: #6's second route on CUDA
    tensors (``csrc/transform_attention_bwd_wide.cu``: a query-tile kernel, a
    key-tile kernel and the reduction of the mix gradients' partials, one
    wrapper launch), :func:`transform_attention_bwd_plain` on the CPU."""
    what = "transform_attention_bwd_wide"
    if _build.plain_only(what, qkv):
        return transform_attention_bwd_plain(qkv, wl, ww, do, p, heads=heads, seq=seq,
                                             scale=scale)
    do = do.contiguous()
    _build.check_operands(what, qkv, do, unaligned=(wl, ww, p))
    rows, hd3 = qkv.shape
    d = hd3 // 3 // heads
    _check_head_dim(d, what)
    _check_seq(seq, what)
    B = rows // seq
    lib = _build.lib()
    tq = _pick_tq(lib, lib.dc_tf_bwd_wide_smem_bytes, seq, heads, d, what)
    dqkv = torch.empty_like(qkv)
    grads = torch.zeros(2 * heads * heads, dtype=torch.float32, device=qkv.device)
    if rows > 0:
        f32 = dict(dtype=torch.float32, device=qkv.device)
        pm = torch.empty((B, heads, seq, seq), **f32)
        ds = torch.empty((B, heads, seq, seq), **f32)
        partial = torch.empty((B * -(-seq // tq), 2 * heads * heads), **f32)
        _build.check(lib.dc_transform_attention_bwd_wide(
            qkv.data_ptr(), wl.data_ptr(), ww.data_ptr(), do.data_ptr(), p.data_ptr(),
            dqkv.data_ptr(), pm.data_ptr(), ds.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), B, seq, heads, d, tq, float(scale), _build.stream_ptr(qkv)), what)
        transform_attention_bwd_wide.launches += 1
    hh = heads * heads
    return dqkv, grads[:hh].view(heads, heads), grads[hh:].view(heads, heads)


# route -> (the forward that saves P, the backward that reads it)
_GRAD_ROUTES = {
    "plain": (transform_attention_save_p_plain, transform_attention_bwd_plain),
    "tensor_core": (transform_attention_save_p, transform_attention_bwd),
    "wide": (transform_attention_save_p_wide, transform_attention_bwd_wide),
}


class _TransformAttention(torch.autograd.Function):
    """After ``_tf_flat_qkv_fwd`` / ``_tf_flat_qkv_bwd`` of the JAX package.
    The backward is the one of the route whose forward wrote P."""

    @staticmethod
    def forward(ctx, qkv, wl, ww, heads, seq, scale):
        save_p, ctx.bwd = _GRAD_ROUTES[grad_route(qkv, heads, seq)]
        o, p = save_p(qkv, wl, ww, heads=heads, seq=seq, scale=scale)
        ctx.save_for_backward(qkv, wl, ww, p)
        ctx.args = (heads, seq, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, wl, ww, p = ctx.saved_tensors
        heads, seq, scale = ctx.args
        dqkv, dwl, dww = ctx.bwd(qkv, wl, ww, do, p, heads=heads, seq=seq, scale=scale)
        return dqkv, dwl.to(wl.dtype), dww.to(ww.dtype), None, None, None


def transform_attention_rows_qkv(qkv: torch.Tensor, wl: torch.Tensor, ww: torch.Tensor,
                                 *, heads: int, seq: int,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Fused head-transform attention; ``scale`` defaults to d ** -0.5.
    Differentiable in qkv and both mixes."""
    d = _check_shapes(qkv, wl, ww, heads, seq)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _build.needs_grad(qkv, wl, ww):
        return _TransformAttention.apply(qkv, wl, ww, heads, seq, scale)
    if _build.plain_only("transform_attention_rows_qkv", qkv):
        return transform_attention_rows_qkv_plain(qkv, wl, ww, heads=heads, seq=seq,
                                                  scale=scale)
    _check_head_dim(d)
    if not _tensor_core_shape(_build.lib(), heads, d):
        return transform_attention_rows_qkv_wide(qkv, wl, ww, heads=heads, seq=seq,
                                                 scale=scale)
    return _launch_fwd(transform_attention_rows_qkv, qkv, wl, ww, heads, seq, scale, False)[0]


transform_attention_rows_qkv.launches = 0
transform_attention_rows_qkv_wide.launches = 0
transform_attention_save_p.launches = 0
transform_attention_bwd.launches = 0
transform_attention_save_p_wide.launches = 0
transform_attention_bwd_wide.launches = 0
