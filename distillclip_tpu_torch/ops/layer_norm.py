"""Row LayerNorm with fp32 math, forward and backward.

Port of ``distillclip_tpu/ops/layer_norm.py::layer_norm_rows``.  On a CUDA
tensor the forward launches K4 (``csrc/layer_norm.cu``), which also writes
the rows' mean and rstd when a gradient will need them, on a grid this module
picks from the row count (:func:`_fwd_grid`), and the backward
launches the kernel beside it, once: dx, dscale and dbias in one launch (the
design is in the source); on a CPU tensor both run the plain versions below,
the same math in plain PyTorch.

Gradients of the scale and bias leave the kernels as fp32 ``[C]`` and are
cast to the parameters' dtype, as the JAX package casts them.
"""

from __future__ import annotations

import threading

import torch

from distillclip_tpu_torch.ops import _build


def _moments(x32: torch.Tensor, eps: float):
    mean = x32.mean(-1, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return d, mean, rstd


def layer_norm_rows_stats_plain(x, scale, bias, eps: float = 1e-5):
    """(y, mean, rstd): y = (x - mean) * rstd * scale + bias over the last
    dim in fp32, y in x's dtype, mean and rstd fp32 ``[rows]``."""
    d, mean, rstd = _moments(x.float(), eps)
    y = (d * rstd * scale.float() + bias.float()).to(x.dtype)
    return y, mean[:, 0], rstd[:, 0]


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K4: y only."""
    return layer_norm_rows_stats_plain(x, scale, bias, eps)[0]


def layer_norm_rows_bwd_plain(x, scale, g, mean, rstd):
    """Plain PyTorch version of the backward kernel: (dx in x's dtype,
    dscale fp32, dbias fp32) from the saved row statistics."""
    g32, s32 = g.float(), scale.float()
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    gs = g32 * s32
    m1 = gs.mean(-1, keepdim=True)
    m2 = (gs * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (gs - m1 - xhat * m2)
    return dx.to(x.dtype), (g32 * xhat).sum(0), g32.sum(0)


def _check_shapes(x, scale, bias):
    if x.ndim != 2 or scale.shape != (x.shape[1],) or bias.shape != (x.shape[1],):
        raise ValueError(f"layer_norm_rows: x [rows, C] with scale/bias [C], got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")


# Warps a block of the forward: two for calls too small to fill the card,
# eight (the kernel's most) otherwise.
_SMALL_BLOCK_WARPS, _BLOCK_WARPS = 2, 8
# (device index, rows, C) -> (threads, blocks) of the forward, per process:
# worked out once, since a call's host cost counts at [256, C].
_fwd_grids: dict = {}


def _fwd_grid(rows: int, sms: int, warps_per_sm: int) -> tuple[int, int]:
    """(threads, blocks) of the forward: warp w of the grid takes rows w,
    w + W, ... (W warps).  Each warp takes k = ceil(rows / (warps the card
    holds at once)) rows, so that the grid is one wave in which the warps take
    k or k - 1 rows; a grid of W = ceil(rows / k) warps that would fill under
    eight of them an SM runs two warps a block, spread over more SMs."""
    k = -(-rows // (sms * warps_per_sm))
    warps = -(-rows // k)
    per_block = _SMALL_BLOCK_WARPS if warps < _BLOCK_WARPS * sms else _BLOCK_WARPS
    return 32 * per_block, -(-warps // per_block)


def layer_norm_rows_fwd(x, scale, bias, eps: float = 1e-5, stats: bool = False):
    """K4 on a CUDA tensor, its plain version on a CPU tensor; with
    ``stats`` also mean and rstd (else None)."""
    if _build.plain_only("layer_norm_rows", x):
        y, mean, rstd = layer_norm_rows_stats_plain(x, scale, bias, eps)
        return (y, mean, rstd) if stats else (y, None, None)
    _build.check_operands("layer_norm_rows", x, scale, bias)
    rows, C = x.shape
    if C % 8:
        raise ValueError(f"layer_norm_rows: C must be a multiple of 8, got {C}")
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    lib = _build.lib()
    key = (x.device.index, rows, C)
    if key not in _fwd_grids:
        warps = lib.dc_layer_norm_rows_warps_per_sm(C)     # -(CUDA error) on failure
        _build.check(max(0, -warps), "layer_norm_rows")
        if warps == 0:
            raise RuntimeError("layer_norm_rows: no block of the kernel fits an SM")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _fwd_grids[key] = _fwd_grid(rows, sms, warps)
    threads, blocks = _fwd_grids[key]
    _build.check(lib.dc_layer_norm_rows(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        y.data_ptr(),
                                        None if mean is None else mean.data_ptr(),
                                        None if rstd is None else rstd.data_ptr(),
                                        rows, C, float(eps), threads, blocks,
                                        _build.stream_ptr(x)),
                 "layer_norm_rows")
    layer_norm_rows.launches += 1
    return y, mean, rstd


# Rows of the backward's device ticket counters (csrc/layer_norm.cu,
# kLnBwdSlots).
_TICKET_SLOTS = 64
# (device index, stream) -> its row of the device counters, for the process:
# the counters live in the loaded library, one set per process and device.
_ticket_slots: dict = {}
_ticket_lock = threading.Lock()


def _bwd_rows_per_block(rows: int, sms: int) -> int:
    """Rows a block of the backward kernel takes: one a warp at least (16),
    and no more blocks than the card has SMs (one block fills one), each of
    which writes a ``[2·C]`` fp32 partial that the blocks finishing last add
    up."""
    return max(16, -(-rows // sms))


def _ticket_slot(x) -> int:
    """The ticket counter's slot of ``x``'s device and current stream: calls
    on one stream run in order, so no two launches share a slot at once."""
    key = (x.device.index, _build.stream_ptr(x))
    with _ticket_lock:
        if key not in _ticket_slots:
            if len(_ticket_slots) == _TICKET_SLOTS:
                raise RuntimeError(f"layer_norm_rows_bwd: more than {_TICKET_SLOTS} "
                                   "(device, stream) pairs")
            _ticket_slots[key] = len(_ticket_slots)
        return _ticket_slots[key]


def layer_norm_rows_bwd(x, scale, g, mean, rstd):
    """(dx, dscale fp32, dbias fp32) of the row LayerNorm: the backward
    kernel on CUDA tensors (one launch), :func:`layer_norm_rows_bwd_plain` on
    the CPU."""
    if _build.plain_only("layer_norm_rows_bwd", x):
        return layer_norm_rows_bwd_plain(x, scale, g, mean, rstd)
    g = g.contiguous()
    _build.check_operands("layer_norm_rows_bwd", x, scale, g, fp32=(mean, rstd))
    rows, C = x.shape
    lib = _build.lib()
    if C % 8 or C > lib.dc_layer_norm_rows_bwd_max_c():
        raise ValueError(f"layer_norm_rows_bwd: C must be a multiple of 8 up to "
                         f"{lib.dc_layer_norm_rows_bwd_max_c()}, got {C}")
    dx = torch.empty_like(x)
    grads = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    rpb = _bwd_rows_per_block(rows, torch.cuda.get_device_properties(x.device)
                              .multi_processor_count)
    partial = torch.empty((max(1, -(-rows // rpb)), 2 * C), dtype=torch.float32,
                          device=x.device)
    _build.check(lib.dc_layer_norm_rows_bwd(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                                            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                                            partial.data_ptr(), grads.data_ptr(), rows, C, rpb,
                                            _ticket_slot(x), _build.stream_ptr(x)),
                 "layer_norm_rows_bwd")
    layer_norm_rows_bwd.launches += 1
    return dx, grads[:C], grads[C:]


class _LayerNormRows(torch.autograd.Function):
    """After ``_ln_rows_fwd`` / ``_ln_rows_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_rows_fwd(x, scale, bias, eps, stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, ds, db = layer_norm_rows_bwd(x, scale, g, mean, rstd)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of 2D ``[rows, C]`` inputs; fp32 math, output in x's dtype.
    Differentiable in x, scale and bias."""
    _check_shapes(x, scale, bias)
    if _build.needs_grad(x, scale, bias):
        return _LayerNormRows.apply(x, scale, bias, eps)
    return layer_norm_rows_fwd(x, scale, bias, eps, stats=False)[0]


layer_norm_rows.launches = 0
layer_norm_rows_bwd.launches = 0
