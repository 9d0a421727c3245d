"""Row LayerNorm with fp32 math (forward only).

Port of ``distillclip_tpu/ops/layer_norm.py::layer_norm_rows``.  On a CUDA
tensor it launches K4 (``csrc/layer_norm.cu``); on a CPU tensor it runs
:func:`layer_norm_rows_plain`, the same math in plain PyTorch.
"""

from __future__ import annotations

import torch

from distillclip_tpu_torch.ops import _build


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """y = (x - mean) * rstd * scale + bias over the last dim, in fp32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return (d * rstd * scale.float() + bias.float()).to(x.dtype)


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of 2D ``[rows, C]`` inputs; fp32 math, output in x's dtype."""
    if x.ndim != 2 or scale.shape != (x.shape[1],) or bias.shape != (x.shape[1],):
        raise ValueError(f"layer_norm_rows: x [rows, C] with scale/bias [C], got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    if _build.plain_only("layer_norm_rows", x):
        return layer_norm_rows_plain(x, scale, bias, eps)
    _build.check_operands("layer_norm_rows", x, scale, bias)
    rows, C = x.shape
    if C % 8:
        raise ValueError(f"layer_norm_rows: C must be a multiple of 8, got {C}")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.lib()
    _build.check(lib.dc_layer_norm_rows(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        y.data_ptr(), rows, C, float(eps),
                                        _build.stream_ptr(x)), "layer_norm_rows")
    layer_norm_rows.launches += 1
    return y


layer_norm_rows.launches = 0
