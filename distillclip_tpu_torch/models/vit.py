"""Patch extraction for the vision towers.

Port of ``patchify`` (``distillclip_tpu/models/vit.py:26-37``).  The patch
convolution is a reshape plus one ``[P·P·C, width]`` product; the (ph, pw, c)
flatten order is the JAX package's, so its ``patch_kernel`` drops in as it is.
"""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, (H/P)·(W/P), P·P·C]``."""
    B, H, W, C = images.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = images.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, P * P * C)
