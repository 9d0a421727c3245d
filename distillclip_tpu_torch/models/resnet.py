"""CLIP's ModifiedResNet image tower, for RN50-class teachers.

Port of ``distillclip_tpu/models/resnet.py`` (reference
``model/component/resnet_encoder.py``): a 3-conv stem with an average pool,
anti-aliased bottlenecks (an average pool before each stride-2 convolution,
and on the downsample branch), and the QKV attention pool, of which only the
mean token's query is used.

The tower is load-only and always frozen (reference ``distil_model.py:59-60``):
BatchNorm runs in inference mode on the checkpoint's running statistics,
folded to a scale and a bias in fp32 and then cast to the compute dtype, as
the JAX package's ``_bn`` does.  Its statistics are parameters like every
other leaf, so the teacher's compute copy (``cast_to_compute``) rounds them
to the compute dtype first, as the JAX teacher's cast does.

Images arrive NHWC, as in every tower of the port; the permute to NCHW is a
view with channels-last strides, which the convolutions (cuDNN on the card)
take as they are.  Neither the convolutions nor the attention pool reach a
TPU kernel in the JAX package (they are XLA there), so they run as PyTorch's
own calls here.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distillclip_tpu_torch.models.outputs import ControlFlags, VisionOutput


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d on NCHW: the checkpoint's ``weight``,
    ``bias``, ``running_mean`` and ``running_var``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        scale = self.weight.float() * inv
        bias = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k))


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k <= 1 else F.avg_pool2d(x, k, k)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (resnet_encoder.py:10-53)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample = nn.ParameterList([_conv(inplanes, planes * 4, 1)])
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        out = F.relu(self.bn1(F.conv2d(x, self.conv1.to(dt))))
        out = F.relu(self.bn2(F.conv2d(out, self.conv2.to(dt), padding=1)))
        out = _avgpool(out, self.stride)
        out = self.bn3(F.conv2d(out, self.conv3.to(dt)))
        identity = x
        if hasattr(self, "downsample"):
            identity = self.downsample_bn(
                F.conv2d(_avgpool(x, self.stride), self.downsample[0].to(dt)))
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    """QKV attention pooling (resnet_encoder.py:56-90): the mean token
    prepended as the query, separate q/k/v projections (``[in, out]``
    kernels), output token 0."""

    def __init__(self, spacial: int, embed: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial ** 2 + 1, embed))
        for name, out in (("q", embed), ("k", embed), ("v", embed), ("c", output_dim)):
            setattr(self, f"{name}_kernel", nn.Parameter(torch.empty(embed, out)))
            setattr(self, f"{name}_bias", nn.Parameter(torch.empty(out)))

    def _proj(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return (t @ getattr(self, f"{name}_kernel").to(t.dtype)
                + getattr(self, f"{name}_bias").to(t.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)                          # [B, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        N, hd = tokens.shape[1], C // self.heads
        q = self._proj("q", tokens[:, :1]).view(B, 1, self.heads, hd).transpose(1, 2)
        k = self._proj("k", tokens).view(B, N, self.heads, hd).transpose(1, 2)
        v = self._proj("v", tokens).view(B, N, self.heads, hd).transpose(1, 2)
        # products of the compute dtype accumulate in fp32 (exact in fp32)
        attn = torch.softmax((q.float() @ k.float().transpose(-1, -2)) / float(hd) ** 0.5,
                             dim=-1)
        out = (attn.to(v.dtype).float() @ v.float()).transpose(1, 2).reshape(B, 1, C)
        return self._proj("c", out.to(tokens.dtype))[:, 0]


class ModifiedResNet(nn.Module):
    """The RN teacher tower; ``forward(images NHWC, flags)`` returns a
    :class:`VisionOutput` with the pooled representation and, as the cached
    paths do, its ``[B, 1, D]`` stand-in for the last layer.  The tower has no
    taps: ``flags`` is accepted and ignored, as in the JAX package."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.layers = tuple(layers)
        self.input_resolution = input_resolution
        self.conv1, self.bn1 = _conv(3, width // 2, 3), FrozenBatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), FrozenBatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), FrozenBatchNorm(width)
        inplanes = width
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), self.layers), start=1):
            planes, stage_blocks = width * mult, []
            for b in range(blocks):
                stride = 2 if (stage > 1 and b == 0) else 1
                stage_blocks.append(Bottleneck(inplanes, planes, stride,
                                               stride > 1 or inplanes != planes * 4))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.ModuleList(stage_blocks))
        self.attnpool = AttentionPool(input_resolution // 32, width * 32, heads, output_dim)

    def forward(self, images: torch.Tensor, flags: ControlFlags = ControlFlags(),
                generator=None) -> VisionOutput:
        x = images.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels-last strides
        dt = x.dtype
        for i, stride in ((1, 2), (2, 1), (3, 1)):   # stem (resnet_encoder.py:136-140)
            conv = getattr(self, f"conv{i}").to(dt)
            x = F.relu(getattr(self, f"bn{i}")(F.conv2d(x, conv, stride=stride, padding=1)))
        x = _avgpool(x, 2)
        for stage in range(1, len(self.layers) + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x)
        rep = self.attnpool(x)
        return VisionOutput(last_representation=rep, last_layer_output=rep[:, None, :])


def map_resnet_weights(sd: Dict[str, torch.Tensor], layers: Sequence[int]
                       ) -> Dict[str, torch.Tensor]:
    """``visual.*`` keys of an RN checkpoint -> the state dict of a
    :class:`ModifiedResNet`: convolutions stay OIHW, Linear weights become
    ``[in, out]`` kernels."""
    out: Dict[str, torch.Tensor] = {}

    def bn(src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    for i in (1, 2, 3):
        out[f"conv{i}"] = sd[f"visual.conv{i}.weight"]
        bn(f"visual.bn{i}", f"bn{i}")
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            src, dst = f"visual.layer{stage}.{b}", f"layer{stage}.{b}"
            for j in (1, 2, 3):
                out[f"{dst}.conv{j}"] = sd[f"{src}.conv{j}.weight"]
                bn(f"{src}.bn{j}", f"{dst}.bn{j}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample.0"] = sd[f"{src}.downsample.0.weight"]
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    out["attnpool.positional_embedding"] = sd["visual.attnpool.positional_embedding"]
    for name in ("q", "k", "v", "c"):
        out[f"attnpool.{name}_kernel"] = sd[f"visual.attnpool.{name}_proj.weight"].t()
        out[f"attnpool.{name}_bias"] = sd[f"visual.attnpool.{name}_proj.bias"]
    return {k: v.contiguous().clone() for k, v in out.items()}
