"""LayerNorm-prologue dense layers (forward only).

Port of ``distillclip_tpu/ops/fc1_act.py``'s no-grad entry points:

* :func:`dense_ln`      u = (LN(x)·γ+β)·W (+b)          -- K1, the qkv projection
* :func:`dense_act_ln`  h = act((LN(x)·γ+β)·W + b)      -- K2, fc1 + GELU

W is ``[C, N]`` (the Flax Dense layout, which the converter keeps).  On a
CUDA tensor both launch the hand-written GEMM of ``csrc/dense_ln.cu``; on a
CPU tensor they run the plain versions below.  Both take the LN in fp32 and
the product, bias and activation in fp32 before one final rounding to x's
dtype.  The plain version rounds the LN output to x's dtype before the
product, as the TPU kernel does; the CUDA kernel rounds it to fp16, which
keeps the bf16 result within its limits (see the header of dense_ln.cu).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distillclip_tpu_torch.ops import _build

_ACTS = {"gelu_exact": 1, "quick_gelu": 2}


def _ln_in_dtype(x, ls, lb, eps):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return (d * rstd * ls.float() + lb.float()).to(x.dtype)


def _act(u: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu_exact":
        return 0.5 * u * (1.0 + torch.erf(u * (1.0 / math.sqrt(2.0))))
    if act == "quick_gelu":
        return u * torch.sigmoid(1.702 * u)
    raise ValueError(f"unknown activation {act!r}")


def dense_ln_plain(x, ls, lb, w, b=None, eps: float = 1e-5, act: Optional[str] = None):
    """Plain PyTorch version of K1 (``act=None``) and K2."""
    u = _ln_in_dtype(x, ls, lb, eps).float() @ w.float()
    if b is not None:
        u = u + b.float()
    if act is not None:
        u = _act(u, act)
    return u.to(x.dtype)


def _check_shapes(what, x, ls, lb, w, b):
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: x [rows, C] and w [C, N], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    C, N = w.shape
    if ls.shape != (C,) or lb.shape != (C,) or (b is not None and b.shape != (N,)):
        raise ValueError(f"{what}: LN params must be [{C}] and the bias [{N}]")


def _launch(wrapper, x, ls, lb, w, b, eps, act_code):
    """Launch K1 (act_code 0) or K2 and count it on ``wrapper``."""
    what = wrapper.__name__
    _build.check_operands(what, *(t for t in (x, ls, lb, w, b) if t is not None))
    rows, C = x.shape
    N = w.shape[1]
    if C % 32 or N % 8:
        raise ValueError(f"{what}: the kernel takes C % 32 == 0 and N % 8 == 0, "
                         f"got C={C}, N={N}")
    lib = _build.lib()
    if lib.dc_dense_ln_smem_bytes(C) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{what}: C={C} is too wide for the kernel's row tile")
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    _build.check(lib.dc_dense_ln(x.data_ptr(), ls.data_ptr(), lb.data_ptr(), w.data_ptr(),
                                 None if b is None else b.data_ptr(), out.data_ptr(),
                                 rows, C, N, float(eps), act_code, _build.stream_ptr(x)),
                 what)
    wrapper.launches += 1
    return out


def dense_ln(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """u = LN(x; ls, lb) @ w (+ b) on 2D rows (K1)."""
    _check_shapes("dense_ln", x, ls, lb, w, b)
    if _build.plain_only("dense_ln", x):
        return dense_ln_plain(x, ls, lb, w, b, eps)
    return _launch(dense_ln, x, ls, lb, w, b, eps, 0)


def dense_act_ln(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, act: str = "gelu_exact", eps: float = 1e-5) -> torch.Tensor:
    """h = act(LN(x; ls, lb) @ w + b) on 2D rows (K2); act is
    ``gelu_exact`` or ``quick_gelu``."""
    if act not in _ACTS:
        raise ValueError(f"dense_act_ln: unknown activation {act!r}")
    _check_shapes("dense_act_ln", x, ls, lb, w, b)
    if _build.plain_only("dense_act_ln", x):
        return dense_ln_plain(x, ls, lb, w, b, eps, act)
    return _launch(dense_act_ln, x, ls, lb, w, b, eps, _ACTS[act])


dense_ln.launches = 0
dense_act_ln.launches = 0
