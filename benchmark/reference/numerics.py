"""The arithmetic every reference tower shares, and its precision.

The reference computes in float32 with TF32 off.  Its control, the same
reference one precision below what the configurations state (bf16 compute),
is ``fp8``: every operand of every product (the dense layers, q·kᵀ, P·v and
the head mixes) is rounded to float8 e4m3 with one scale per tensor (its
largest magnitude onto e4m3's 448), the products summed in float32, as an
fp8 training path would.  The rounding is a straight-through estimator:
gradients pass it unchanged.
"""

from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0

# CLIP's pixel statistics (openai/CLIP clip/clip.py, _transform)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def fp32_mode() -> None:
    """Products in full float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Precision:
    """``fp32`` or ``fp8`` (the control); :meth:`op` rounds an operand."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _round_fp8(x) if self.name == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def mix(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A head mix: ``out[b, h] = Σ_g w[h, g] · x[b, g]`` over ``[B, H, N, M]``."""
        return torch.einsum("hg,bgnm->bhnm", self.op(w), self.op(x))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels -> float32 ``(x / 255 - mean) / std``."""
    mean = torch.tensor(IMAGE_MEAN, device=images.device)
    std = torch.tensor(IMAGE_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)
