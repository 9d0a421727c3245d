"""The dense layers of ``distillclip_tpu/ops/fc1_act.py``, forward and backward.

* :func:`dense_ln`      u = (LN(x)·γ+β)·W (+b)          -- K1, the qkv projection
* :func:`dense_act_ln`  h = act((LN(x)·γ+β)·W + b)      -- K2, fc1 + GELU
* :func:`dense_act`     h = act(x·W + b)                -- the GEMM without the
  LN, the "no-LN mode" (#12; #10 or #11 under a gradient), which the blocks run
  when the ``fc1_ln: "0"`` knob unfuses their LayerNorms

W is ``[C, N]`` (the Flax Dense layout, which the converter keeps).  On a
CUDA tensor K1, K2 and K2's residual mode (#8) launch the hand-written
kernels of ``csrc/dense_ln_wgmma.cu`` (the rows' statistics with W's fp16
copy, then the product on wgmma and TMA, the main loop of
``csrc/wgmma_gemm.cuh``, with LN(x) made in registers and the activation in
the epilogue), and the GEMM without the LN that of ``csrc/dense_act.cu``
(wgmma and TMA); on a CPU tensor they run the plain versions below.  All
take the LN in fp32 and the product, bias and activation in fp32 before one
final rounding to x's dtype.  The plain version rounds the LN output to x's
dtype before the product, as the TPU kernel does; the CUDA kernels round it
to fp16, which keeps the bf16 result within its limits (see the header of
dense_ln_wgmma.cu).

Without a gradient (serving, the frozen teachers) the lean modes run: K1
writes u, K2 writes h only.  With one, each function is a
``torch.autograd.Function``:

* forward: K1 also keeps the rows' LN mean and rstd; K2 runs in its
  residual mode (:func:`dense_act_ln_res`) and writes h, u, e = erf(u/√2) or
  σ(1.702u), mean and rstd.  The JAX package recombines h from the rounded
  (u, e) outside its kernel; here the kernel writes h from the fp32 sum, the
  same bits as the lean K2 (every mode writes mean and rstd, into scratch in
  the lean ones, so all run the same launches);
* backward: :func:`dense_ln_bwd` (``csrc/dense_ln_bwd.cu``: wgmma and TMA,
  one thread-block cluster along C per 128 rows) makes dx, the normalised
  rows xn and dγ, dβ from du in one pass; K2's backward hands it dh, u and e
  instead, and the kernel forms du = dh·act'(u) in registers as its A
  operand and stores it once (its activation mode, where the JAX package
  leaves the derivative to XLA).  dW = xnᵀ·du and db = Σ du stay plain
  PyTorch, as the JAX package leaves them to XLA.

With ``res="u"`` (the ``fc1_res: u`` knob) fc1 under a gradient saves u
only: :func:`dense_act_ln` runs K1 with its statistics and :func:`dense_act`
the no-LN mode that writes u (#11); h and e come from u in PyTorch with an
exact erf, and the backward recomputes e from u (in #9's registers on the
card), as the JAX package's ``_recombine_u`` and ``_dense_act_bwd`` do.  In
the default ``"ue"`` mode :func:`dense_act` runs the no-LN mode that writes h,
u and e (#10).  The
backward of :func:`dense_act` is the JAX package's XLA backward in PyTorch:
dx = du·Wᵀ, dW = xᵀ·du and db = Σ du.

The GEMM without the LN takes x and W as bf16 (not fp16: without the
LayerNorm x is unbounded); its plain versions are :func:`dense_act_plain`,
:func:`dense_act_res_plain` and :func:`dense_act_u_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distillclip_tpu_torch.ops import _build

_ACTS = {"gelu_exact": 1, "quick_gelu": 2}
_RES_MODES = ("ue", "u")
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _ln_stats(x, ls, lb, eps):
    """(LN(x)·γ+β in fp32, mean [rows], rstd [rows])."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return d * rstd * ls.float() + lb.float(), mean[:, 0], rstd[:, 0]


def _act_e(u: torch.Tensor, act: str) -> torch.Tensor:
    """The activation's transcendental value e from fp32 u."""
    if act == "gelu_exact":
        return torch.erf(u * _INV_SQRT2)
    if act == "quick_gelu":
        return torch.sigmoid(1.702 * u)
    raise ValueError(f"unknown activation {act!r}")


def _recombine(u: torch.Tensor, e: torch.Tensor, act: str) -> torch.Tensor:
    return 0.5 * u * (1.0 + e) if act == "gelu_exact" else u * e


def _act_grad(u: torch.Tensor, e: torch.Tensor, act: str) -> torch.Tensor:
    """d act(u) / du from fp32 u and its saved e."""
    if act == "gelu_exact":
        return 0.5 * (1.0 + e) + u * torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    return e + 1.702 * u * e * (1.0 - e)


def dense_ln_stats_plain(x, ls, lb, w, b=None, eps: float = 1e-5):
    """Plain PyTorch version of K1 with its statistics: (u, mean, rstd)."""
    xn, mean, rstd = _ln_stats(x, ls, lb, eps)
    u = xn.to(x.dtype).float() @ w.float()
    if b is not None:
        u = u + b.float()
    return u.to(x.dtype), mean, rstd


def dense_act_ln_res_plain(x, ls, lb, w, b, act: str = "gelu_exact", eps: float = 1e-5):
    """Plain PyTorch version of K2's residual mode: (h, u, e, mean, rstd),
    with h, u and e each rounded once from the fp32 sum."""
    xn, mean, rstd = _ln_stats(x, ls, lb, eps)
    u = xn.to(x.dtype).float() @ w.float() + b.float()
    e = _act_e(u, act)
    return (_recombine(u, e, act).to(x.dtype), u.to(x.dtype), e.to(x.dtype), mean, rstd)


def dense_ln_plain(x, ls, lb, w, b=None, eps: float = 1e-5, act: Optional[str] = None):
    """Plain PyTorch version of K1 (``act=None``) and K2."""
    if act is None:
        return dense_ln_stats_plain(x, ls, lb, w, b, eps)[0]
    return dense_act_ln_res_plain(x, ls, lb, w, b, act, eps)[0]


def _recombine_u(u: torch.Tensor, act: str) -> torch.Tensor:
    """h from u alone, in u's dtype: e recomputed in fp32 (the u mode)."""
    uf = u.float()
    return _recombine(uf, _act_e(uf, act), act).to(u.dtype)


def dense_act_u_plain(x, w, b):
    """Plain PyTorch version of the no-LN mode that writes u = x·W + b (#11)."""
    return (x.float() @ w.float() + b.float()).to(x.dtype)


def dense_act_res_plain(x, w, b, act: str = "gelu_exact"):
    """Plain PyTorch version of the no-LN residual mode (#10): (h, u, e), each
    rounded once from the fp32 sum."""
    u = x.float() @ w.float() + b.float()
    e = _act_e(u, act)
    return _recombine(u, e, act).to(x.dtype), u.to(x.dtype), e.to(x.dtype)


def dense_act_plain(x, w, b, act: str = "gelu_exact"):
    """Plain PyTorch version of the no-LN mode that writes h only (#12)."""
    return dense_act_res_plain(x, w, b, act)[0]


def dense_ln_bwd_plain(x, ls, lb, w, g, mean, rstd, act=None, u=None, e=None):
    """Plain PyTorch version of the backward kernel: (dx, xn in x's dtype,
    dγ fp32, dβ fp32) from g = du and the saved row statistics.  With
    ``act``, g is dh, the gradient of h = act(u); du = dh·act'(u) is formed
    first (e recomputed from u when None) and returned last, in g's dtype."""
    if act is not None:
        du = _act_du(g, u, e, act)
        return (*dense_ln_bwd_plain(x, ls, lb, w, du, mean, rstd), du)
    du = g
    ls32 = ls.float()
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    xn = xhat * ls32 + lb.float()
    dxn = du.float() @ w.float().t()
    dxhat = dxn * ls32
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), xn.to(x.dtype), (dxn * xhat).sum(0), dxn.sum(0)


def _check_shapes(what, x, ls, lb, w, b):
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: x [rows, C] and w [C, N], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    C, N = w.shape
    if ls.shape != (C,) or lb.shape != (C,) or (b is not None and b.shape != (N,)):
        raise ValueError(f"{what}: LN params must be [{C}] and the bias [{N}]")


def _check_widths(what, C, N, too_wide: bool, rows: int):
    """Refuse widths the kernel does not take: ``too_wide`` says C is more
    than its tiles hold; ``rows`` are checked against the grid of a wgmma
    kernel, which has a row of blocks per 128 rows."""
    if C % 32 or N % 8:
        raise ValueError(f"{what}: the kernel takes C % 32 == 0 and N % 8 == 0, "
                         f"got C={C}, N={N}")
    if too_wide:
        raise ValueError(f"{what}: C={C} is too wide for the kernel's row tile")
    if rows > _WGMMA_MAX_ROWS:
        raise ValueError(f"{what}: the kernel takes at most {_WGMMA_MAX_ROWS} rows, "
                         f"got {rows}")


# the wgmma GEMMs' grid has one row of blocks per 128 rows, at most 65535
_WGMMA_MAX_ROWS = 65535 * 128


def _check_dense_shapes(what, x, w, b):
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1] or b.shape != (w.shape[1],):
        raise ValueError(f"{what}: x [rows, C], w [C, N] and b [N], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stats_buffers(x):
    return (torch.empty(x.shape[0], dtype=torch.float32, device=x.device),
            torch.empty(x.shape[0], dtype=torch.float32, device=x.device))


def _launch_dense_ln(wrapper, x, ls, lb, w, b, eps, act_code: int = 0, res: bool = False):
    """The LN GEMM on CUDA tensors, counted on ``wrapper``: (out, u, e, mean,
    rstd), out being u with act_code 0 (K1) and h otherwise (K2), u and e
    None unless ``res`` (#8).  The kernel writes mean and rstd in every mode,
    so that every mode runs the same launches and gives the same out."""
    what = wrapper.__name__
    if act_code and b is None:
        raise ValueError(f"{what}: the activation's GEMM takes a bias")
    _build.check_operands(what, *(t for t in (x, ls, lb, w, b) if t is not None))
    rows, C = x.shape
    N = w.shape[1]
    lib = _build.lib()
    _check_widths(what, C, N, lib.dc_dense_ln_wgmma_smem_bytes(C) > _build.MAX_SMEM_BYTES,
                  rows)
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    u, e = (torch.empty_like(out), torch.empty_like(out)) if res else (None, None)
    mean, rstd = _stats_buffers(x)
    if rows:
        w16 = torch.empty((C, N), dtype=torch.float16, device=x.device)
        _build.check(lib.dc_dense_ln_wgmma(x.data_ptr(), ls.data_ptr(), lb.data_ptr(),
                                           w.data_ptr(), w16.data_ptr(), _ptr(b),
                                           out.data_ptr(), _ptr(u), _ptr(e), mean.data_ptr(),
                                           rstd.data_ptr(), rows, C, N, float(eps), act_code,
                                           int(res), _build.stream_ptr(x)), what)
        wrapper.launches += 1
    return out, u, e, mean, rstd


def dense_ln_fwd(x, ls, lb, w, b=None, eps: float = 1e-5, stats: bool = False):
    """(u, mean, rstd) by K1 on CUDA tensors (mean and rstd None without
    ``stats``), by the plain version on the CPU."""
    if _build.plain_only("dense_ln", x):
        u, mean, rstd = dense_ln_stats_plain(x, ls, lb, w, b, eps)
    else:
        u, _, _, mean, rstd = _launch_dense_ln(dense_ln, x, ls, lb, w, b, eps)
    return (u, mean, rstd) if stats else (u, None, None)


def dense_act_ln_res(x, ls, lb, w, b, act: str = "gelu_exact", eps: float = 1e-5):
    """(h, u, e, mean, rstd): K2 in its residual mode (#8) on CUDA tensors,
    :func:`dense_act_ln_res_plain` on the CPU."""
    if _build.plain_only("dense_act_ln_res", x):
        return dense_act_ln_res_plain(x, ls, lb, w, b, act, eps)
    return _launch_dense_ln(dense_act_ln_res, x, ls, lb, w, b, eps, _ACTS[act], True)


def _launch_dense_act(wrapper, x, w, b, act_code: int, res: bool):
    """The no-LN mode on CUDA tensors, counted on ``wrapper``: h (or u with
    act_code 0), and with ``res`` also u and e."""
    what = wrapper.__name__
    _build.check_operands(what, x, w, b)
    rows, C = x.shape
    N = w.shape[1]
    _check_widths(what, C, N, False, rows)
    lib = _build.lib()
    outs = [torch.empty((rows, N), dtype=x.dtype, device=x.device)
            for _ in range(3 if res else 1)]
    if rows == 0:
        return outs
    h, u, e = outs if res else (outs[0], None, None)
    _build.check(lib.dc_dense_act(x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
                                  _ptr(u), _ptr(e), rows, C, N, act_code, int(res),
                                  _build.stream_ptr(x)), what)
    wrapper.launches += 1
    return outs


def dense_act_res(x, w, b, act: str = "gelu_exact"):
    """(h, u, e) of act(x·W + b): the no-LN residual mode (#10) on CUDA
    tensors, :func:`dense_act_res_plain` on the CPU."""
    if _build.plain_only("dense_act_res", x):
        return dense_act_res_plain(x, w, b, act)
    return tuple(_launch_dense_act(dense_act_res, x, w, b, _ACTS[act], True))


def dense_act_u(x, w, b):
    """u = x·W + b: the no-LN mode that writes u only (#11) on CUDA tensors,
    :func:`dense_act_u_plain` on the CPU."""
    if _build.plain_only("dense_act_u", x):
        return dense_act_u_plain(x, w, b)
    return _launch_dense_act(dense_act_u, x, w, b, 0, False)[0]


def dense_ln_bwd(x, ls, lb, w, g, mean, rstd, act: Optional[str] = None, u=None, e=None):
    """(dx, xn, dγ fp32, dβ fp32) of u = LN(x)·W from g = du: the backward
    kernel on CUDA tensors, :func:`dense_ln_bwd_plain` on the CPU.

    With ``act`` (K2's backward) g is dh, the gradient of h = act(u), and u
    (with the saved e, or None to recompute it) comes beside it: the kernel
    forms du = dh·act'(u) itself and the call also returns that du, last
    (counted on ``dense_ln_bwd.act_launches`` too)."""
    if (act is None) != (u is None) or (u is None and e is not None):
        raise ValueError("dense_ln_bwd: an activation takes u (and e or None), and only it")
    if act is not None and act not in _ACTS:
        raise ValueError(f"dense_ln_bwd: unknown activation {act!r}")
    if _build.plain_only("dense_ln_bwd", x):
        return dense_ln_bwd_plain(x, ls, lb, w, g, mean, rstd, act, u, e)
    g = g.contiguous()
    acts = tuple(t for t in (u, e) if t is not None)
    _build.check_operands("dense_ln_bwd", x, ls, lb, w, g, *acts, fp32=(mean, rstd))
    rows, C = x.shape
    N = w.shape[1]
    if any(t.shape != g.shape for t in acts):
        raise ValueError(f"dense_ln_bwd: u and e must be shaped as dh {tuple(g.shape)}")
    lib = _build.lib()
    _check_widths("dense_ln_bwd", C, N, C > lib.dc_dense_ln_bwd_max_c(), rows)
    dx, xn = torch.empty_like(x), torch.empty_like(x)
    du = None if act is None else torch.empty_like(g)
    grads = torch.zeros(2 * C, dtype=torch.float32, device=x.device)
    out = (dx, xn, grads[:C], grads[C:]) + (() if du is None else (du,))
    if rows == 0:
        return out
    partial = torch.empty((lib.dc_dense_ln_bwd_blocks(rows), 2 * C), dtype=torch.float32,
                          device=x.device)
    _build.check(lib.dc_dense_ln_bwd(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w.data_ptr(),
                                     g.data_ptr(), _ptr(u), _ptr(e), _ptr(du),
                                     mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                                     xn.data_ptr(), partial.data_ptr(), grads.data_ptr(), rows,
                                     C, N, _ACTS.get(act, 0),
                                     _build.stream_ptr(x)), "dense_ln_bwd")
    dense_ln_bwd.launches += 1
    if act is not None:
        dense_ln_bwd.act_launches += 1
    return out


def _weight_grads(xn, du, w, has_bias: bool):
    """dW = xnᵀ·du and db = Σ du in fp32 sums, in w's dtype: plain products,
    outside any kernel, as in the JAX package."""
    dw = (xn.t() @ du).to(w.dtype)
    db = du.sum(0, dtype=torch.float32).to(w.dtype) if has_bias else None
    return dw, db


class _DenseLn(torch.autograd.Function):
    """After ``_dense_ln_fwd`` / ``_dense_ln_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, ls, lb, w, b, eps):
        u, mean, rstd = dense_ln_fwd(x, ls, lb, w, b, eps, stats=True)
        ctx.save_for_backward(x, ls, lb, w, mean, rstd)
        ctx.has_bias = b is not None
        return u

    @staticmethod
    def backward(ctx, du):
        x, ls, lb, w, mean, rstd = ctx.saved_tensors
        dx, xn, dls, dlb = dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
        dw, db = _weight_grads(xn, du, w, ctx.has_bias)
        return dx, dls.to(ls.dtype), dlb.to(lb.dtype), dw, db, None


def _act_du(dh, u, e, act):
    """du = dh · act'(u) in dh's dtype; e is recomputed from u when not saved."""
    uf = u.float()
    ef = _act_e(uf, act) if e is None else e.float()
    return (dh.float() * _act_grad(uf, ef, act)).to(dh.dtype)


class _DenseActLn(torch.autograd.Function):
    """After ``_dense_act_ln_fwd`` / ``_dense_act_ln_bwd`` of the JAX package:
    ``res="ue"`` saves (u, e) from K2's residual mode, ``res="u"`` saves u
    from K1 with its statistics."""

    @staticmethod
    def forward(ctx, x, ls, lb, w, b, act, eps, res):
        if res == "u":
            u, mean, rstd = dense_ln_fwd(x, ls, lb, w, b, eps, stats=True)
            h, e = _recombine_u(u, act), None
        else:
            h, u, e, mean, rstd = dense_act_ln_res(x, ls, lb, w, b, act, eps)
        ctx.save_for_backward(x, ls, lb, w, u, e, mean, rstd)
        ctx.act = act
        return h

    @staticmethod
    def backward(ctx, dh):
        x, ls, lb, w, u, e, mean, rstd = ctx.saved_tensors
        dx, xn, dls, dlb, du = dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, ctx.act, u, e)
        dw, db = _weight_grads(xn, du, w, True)
        return dx, dls.to(ls.dtype), dlb.to(lb.dtype), dw, db, None, None, None


class _DenseAct(torch.autograd.Function):
    """After ``_dense_act_fwd`` / ``_dense_act_bwd`` of the JAX package; the
    backward is its XLA backward: dx and dW are plain products."""

    @staticmethod
    def forward(ctx, x, w, b, act, res):
        if res == "u":
            u, e = dense_act_u(x, w, b), None
            h = _recombine_u(u, act)
        else:
            h, u, e = dense_act_res(x, w, b, act)
        ctx.save_for_backward(x, w, u, e)
        ctx.act = act
        return h

    @staticmethod
    def backward(ctx, dh):
        x, w, u, e = ctx.saved_tensors
        du = _act_du(dh, u, e, ctx.act)
        dx = (du @ w.t()).to(x.dtype)
        dw, db = _weight_grads(x, du, w, True)
        return dx, dw, db, None, None


def dense_ln(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """u = LN(x; ls, lb) @ w (+ b) on 2D rows (K1).  Differentiable in every
    tensor argument."""
    _check_shapes("dense_ln", x, ls, lb, w, b)
    if _build.needs_grad(x, ls, lb, w, b):
        return _DenseLn.apply(x, ls, lb, w, b, eps)
    return dense_ln_fwd(x, ls, lb, w, b, eps)[0]


def _check_modes(what, act, res):
    if act not in _ACTS:
        raise ValueError(f"{what}: unknown activation {act!r}")
    if res not in _RES_MODES:
        raise ValueError(f"{what}: res must be one of {_RES_MODES}, got {res!r}")


def dense_act_ln(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, act: str = "gelu_exact", eps: float = 1e-5,
                 res: str = "ue") -> torch.Tensor:
    """h = act(LN(x; ls, lb) @ w + b) on 2D rows (K2); act is
    ``gelu_exact`` or ``quick_gelu``; ``res`` what a gradient saves ("ue" or
    "u").  Differentiable in every tensor argument."""
    _check_modes("dense_act_ln", act, res)
    _check_shapes("dense_act_ln", x, ls, lb, w, b)
    if _build.needs_grad(x, ls, lb, w, b):
        return _DenseActLn.apply(x, ls, lb, w, b, act, eps, res)
    if _build.plain_only("dense_act_ln", x):
        return dense_ln_plain(x, ls, lb, w, b, eps, act)
    return _launch_dense_ln(dense_act_ln, x, ls, lb, w, b, eps, _ACTS[act])[0]


def dense_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str = "gelu_exact",
              res: str = "ue") -> torch.Tensor:
    """h = act(x @ w + b) on 2D rows without a LayerNorm: the no-LN mode
    writing h (#12); under a gradient (h, u, e) (#10) or, with ``res="u"``, u
    (#11).  Differentiable in x, w and b."""
    _check_modes("dense_act", act, res)
    _check_dense_shapes("dense_act", x, w, b)
    if _build.needs_grad(x, w, b):
        return _DenseAct.apply(x, w, b, act, res)
    if _build.plain_only("dense_act", x):
        return dense_act_plain(x, w, b, act)
    return _launch_dense_act(dense_act, x, w, b, _ACTS[act], False)[0]


# -- EVA-02's forward modes ---------------------------------------------------------
#
# The blocks of EVA-02-CLIP's vision tower (``models/eva_vit.py``) run three more
# lean modes of the LN GEMM (``csrc/dense_ln_wgmma.cu``), forward only (the
# teacher is frozen): K1 with the rotary turn of q and k in its epilogue, K2
# with SwiGLU over interleaved [W1 | W2] columns writing half width, and K1 with
# the LayerNorm's moments over a true width below the padded one.


def _ln_width(x, ls, lb, eps, width):
    """LN(x)·γ+β in fp32 with the moments over the first ``width`` columns."""
    x32 = x.float()
    mean = x32[:, :width].mean(-1, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt(d[:, :width].square().mean(-1, keepdim=True) + eps)
    return d * rstd * ls.float() + lb.float()


def rotate_pairs(u: torch.Tensor, cs: torch.Tensor, seq: int, hd: int, rot: int) -> torch.Tensor:
    """The rotary turn of fp32 rows ``u`` [B·seq, N]: on the columns below
    ``rot``, each pair (2i, 2i+1) of a head of ``hd`` columns in the row of
    patch p (the token after the class token) turned by ``cs[p, i]`` = (cos,
    sin): (a, b) -> (a·cos - b·sin, b·cos + a·sin).  The class rows and the
    columns from ``rot`` on pass unchanged."""
    rows, N = u.shape
    out = u.clone()
    pairs = out.view(rows // seq, seq, N)[:, 1:, :rot].unflatten(-1, (rot // hd, hd // 2, 2))
    cos, sin = cs[None, :, None, :, 0], cs[None, :, None, :, 1]
    a, b = pairs[..., 0].clone(), pairs[..., 1].clone()
    pairs[..., 0] = a * cos - b * sin
    pairs[..., 1] = b * cos + a * sin
    return out


def dense_ln_rope_plain(x, ls, lb, w, b, cs, seq: int, hd: int, rot: int, eps: float = 1e-6):
    """Plain PyTorch version of K1's rotary mode: u = LN(x)·W + b (the LN
    output rounded to x's dtype, as :func:`dense_ln_plain`), turned in fp32,
    rounded once."""
    u = _ln_stats(x, ls, lb, eps)[0].to(x.dtype).float() @ w.float() + b.float()
    return rotate_pairs(u, cs.float(), seq, hd, rot).to(x.dtype)


def swiglu_pairs(u: torch.Tensor) -> torch.Tensor:
    """silu(u[:, 2j])·u[:, 2j+1]: SwiGLU over interleaved [W1 | W2] sums."""
    return torch.nn.functional.silu(u[:, 0::2]) * u[:, 1::2]


def dense_swiglu_ln_plain(x, ls, lb, w, b, eps: float = 1e-6):
    """Plain PyTorch version of K2's SwiGLU mode: [rows, N / 2]."""
    u = _ln_stats(x, ls, lb, eps)[0].to(x.dtype).float() @ w.float() + b.float()
    return swiglu_pairs(u).to(x.dtype)


def dense_ln_width_plain(x, ls, lb, w, b, width: int, eps: float = 1e-6):
    """Plain PyTorch version of K1 with the moments over ``width`` columns."""
    u = _ln_width(x, ls, lb, eps, width).to(x.dtype).float() @ w.float() + b.float()
    return u.to(x.dtype)


def _forward_only(what, *tensors):
    if _build.needs_grad(*tensors):
        raise ValueError(f"{what}: a forward-only mode (the frozen teacher's); "
                         "no gradient flows through it")


def _launch_mode(wrapper, fn, x, ls, lb, w, b, eps, n_out: int, inputs=(), ints=()):
    """One of EVA-02's modes on CUDA tensors, counted on ``wrapper``: the C
    entry ``fn`` takes x, γ, β, w, w16, b, the further ``inputs``' pointers,
    then out (``n_out`` columns), mean, rstd, rows, C, N, eps, the mode's
    ``ints`` and the stream."""
    what = wrapper.__name__
    _build.check_operands(what, x, ls, lb, w, b)
    rows, C = x.shape
    N = w.shape[1]
    lib = _build.lib()
    _check_widths(what, C, N, lib.dc_dense_ln_wgmma_smem_bytes(C) > _build.MAX_SMEM_BYTES,
                  rows)
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    if rows:
        mean, rstd = _stats_buffers(x)
        w16 = torch.empty((C, N), dtype=torch.float16, device=x.device)
        _build.check(fn(*(t.data_ptr() for t in (x, ls, lb, w, w16, b, *inputs, out, mean,
                                                   rstd)),
                        rows, C, N, float(eps), *ints,
                        _build.stream_ptr(x)), what)
        wrapper.launches += 1
    return out


def dense_ln_rope(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, cs: torch.Tensor, seq: int, hd: int, rot: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """u = LN(x)·W + b on rows of ``seq`` tokens (the first a class token),
    with the rotary turn (:func:`rotate_pairs`, ``cs`` fp32 [seq - 1, hd / 2,
    2]) on the columns below ``rot``: K1's rotary mode on CUDA tensors, the
    plain version on the CPU.  Forward only."""
    _check_shapes("dense_ln_rope", x, ls, lb, w, b)
    _forward_only("dense_ln_rope", x, ls, lb, w, b)
    if cs.shape != (seq - 1, hd // 2, 2) or hd % 2 or rot % hd or rot > w.shape[1] \
            or x.shape[0] % seq:
        raise ValueError(f"dense_ln_rope: cs [{seq - 1}, {hd // 2}, 2], hd even, rot a "
                         f"multiple of hd <= N and rows a multiple of seq; got cs "
                         f"{tuple(cs.shape)}, hd={hd}, rot={rot}, rows={x.shape[0]}")
    if _build.plain_only("dense_ln_rope", x):
        return dense_ln_rope_plain(x, ls, lb, w, b, cs, seq, hd, rot, eps)
    _build.check_operands("dense_ln_rope", x, fp32=(cs,))
    return _launch_mode(dense_ln_rope, _build.lib().dc_dense_ln_rope_wgmma, x, ls, lb, w, b,
                        eps, w.shape[1], inputs=(cs,), ints=(seq, hd, rot))


def dense_swiglu_ln(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """h = silu(u_2j)·u_2j+1 of u = LN(x)·W + b over W = [W1 | W2] interleaved
    by columns, [rows, N / 2]: K2's SwiGLU mode on CUDA tensors, the plain
    version on the CPU.  Forward only."""
    _check_shapes("dense_swiglu_ln", x, ls, lb, w, b)
    _forward_only("dense_swiglu_ln", x, ls, lb, w, b)
    if w.shape[1] % 16:
        raise ValueError(f"dense_swiglu_ln: N % 16 == 0 (pairs, a half width of whole "
                         f"16-byte words), got N={w.shape[1]}")
    if _build.plain_only("dense_swiglu_ln", x):
        return dense_swiglu_ln_plain(x, ls, lb, w, b, eps)
    return _launch_mode(dense_swiglu_ln, _build.lib().dc_dense_swiglu_ln_wgmma, x, ls, lb, w,
                        b, eps, w.shape[1] // 2)


def dense_ln_width(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, width: int, eps: float = 1e-6) -> torch.Tensor:
    """u = LN_width(x)·W + b on rows zero past ``width`` (γ, β and W's rows
    zero there too), the moments over the first ``width`` columns: K1's width
    mode on CUDA tensors, the plain version on the CPU.  Forward only."""
    _check_shapes("dense_ln_width", x, ls, lb, w, b)
    _forward_only("dense_ln_width", x, ls, lb, w, b)
    if not 1 <= width <= x.shape[1]:
        raise ValueError(f"dense_ln_width: 1 <= width <= C, got {width} of {x.shape[1]}")
    if _build.plain_only("dense_ln_width", x):
        return dense_ln_width_plain(x, ls, lb, w, b, width, eps)
    return _launch_mode(dense_ln_width, _build.lib().dc_dense_ln_width_wgmma, x, ls, lb, w, b,
                        eps, w.shape[1], ints=(width,))


dense_ln.launches = 0
dense_act_ln.launches = 0
dense_act.launches = 0
dense_act_res.launches = 0
dense_act_u.launches = 0
dense_act_ln_res.launches = 0
dense_ln_bwd.launches = 0
dense_ln_rope.launches = 0
dense_swiglu_ln.launches = 0
dense_ln_width.launches = 0
# the calls of dense_ln_bwd that formed du in the kernel (K2's backward)
dense_ln_bwd.act_launches = 0
