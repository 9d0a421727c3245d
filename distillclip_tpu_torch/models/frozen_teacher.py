"""The frozen CLIP teacher as the tasks and the datasets' pre-encoding run
it: loaded at first use, cast once per device, its encodes lean (no
gradient).  ``training`` builds its teacher steps on it and
``data.component.utils`` encodes corpora with it."""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from distillclip_tpu_torch.config.perf import perf_knobs, set_perf
from distillclip_tpu_torch.models.clip import CLIPModel
from distillclip_tpu_torch.models.teacher import teacher_load
from distillclip_tpu_torch.serving.inputs import cast_to_compute as cast_module_to_compute
from distillclip_tpu_torch.serving.inputs import prepare_inputs


class FrozenTeacher:
    """The CLIP teacher, loaded at first use and never trained.

    ``module`` is the fp32 teacher on the CPU (it seeds fp32 masters: the
    embedding copy of ``freeze_embed``, the teacher warm start).
    :meth:`compute` is its copy in the compute dtype on a device, made once per
    device: the frozen weights never change, so nothing is cast inside a step.
    It runs under ``torch.no_grad()``, so its kernels are the lean ones and no
    probabilities or residuals are saved.  It runs under the perf knobs that
    were set when the task was built (``config.perf``), even though it is
    loaded later."""

    def __init__(self, name: str, download_root: Optional[str], model_type: str,
                 need_layers: Optional[Sequence[int]], dtype: torch.dtype):
        self._perf = perf_knobs()
        self._load = lambda: set_perf(teacher_load(name, download_root, model_type,
                                                   need_layers=need_layers, device="cpu"),
                                      self._perf)
        self._dtype = dtype
        self._module: Optional[nn.Module] = None
        self._compute: Dict[str, nn.Module] = {}

    @property
    def module(self) -> nn.Module:
        if self._module is None:
            self._module = self._load()
        return self._module

    def compute(self, device) -> nn.Module:
        key = str(torch.device(device))
        if key not in self._compute:
            self._compute[key] = cast_module_to_compute(
                copy.deepcopy(self.module), self._dtype).to(device).eval()
        return self._compute[key]

    def tower(self, device, which: str) -> nn.Module:
        """The ``image`` or ``text`` tower of :meth:`compute`."""
        teacher = self.compute(device)
        if isinstance(teacher, CLIPModel):
            return teacher.image_tower if which == "image" else teacher.text_tower
        return teacher

    def image_encode(self, device) -> Callable:
        """``encode(images) -> fp32 last representations`` of the image tower
        on ``device``: uint8 pixels are normalised there, float ones taken as
        normalised."""
        tower, dtype = self.tower(device, "image"), self._dtype

        @torch.no_grad()
        def encode(images):
            return tower(prepare_inputs(torch.as_tensor(images).to(device), dtype)
                         ).last_representation.float()

        return encode

    def text_encode(self, device) -> Callable:
        """``encode(tokens) -> fp32 last representations`` of the text tower
        on ``device``."""
        tower = self.tower(device, "text")

        @torch.no_grad()
        def encode(tokens):
            return tower(torch.as_tensor(tokens).to(device).long()).last_representation.float()

        return encode

    def state(self, scope: str) -> Dict[str, torch.Tensor]:
        """The fp32 state dict under ``scope`` (``visual``, ``text``,
        ``image_tower.visual`` ...), without the prefix."""
        prefix = scope + "."
        return {k[len(prefix):]: v for k, v in self.module.state_dict().items()
                if k.startswith(prefix)}
