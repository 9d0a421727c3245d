"""L-CLIPScore batch inference with the two student towers.

Port of ``distillclip_tpu/serving/lclip_score.py::LCLIPScorer``: encode the
image and the caption tokens, L2-normalise both in fp32, and score each
aligned pair by their cosine.  Images arrive NHWC as uint8 (normalised on the
device) or as pre-normalised floats; captions arrive as token ids.

The JAX scorer pads each request to a batch bucket so that XLA does not
recompile per size; eager PyTorch has no such cost, so requests run at their
own size.  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import yaml
from torch import nn

from distillclip_tpu_torch.models import (
    ImageEncoder,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
    l2_normalize,
)
from distillclip_tpu_torch.models.transformer import clip_init_stds
from distillclip_tpu_torch.serving.inputs import cast_to_compute, prepare_inputs

# the reference's class paths, which the configs use for the students
# (distillclip_tpu/config/loader.py:25-41 maps them to the JAX towers)
_TOWERS = {
    "model.component.weight_share_model.RepeatVisionTransformer": RepeatVisionTransformer,
    "model.component.weight_share_model.RepeatTextTransformer": RepeatTextTransformer,
}


def build_tower(spec: dict) -> nn.Module:
    """A student tower from a config's ``{class_path, init_args}`` entry."""
    cls = _TOWERS.get(spec["class_path"])
    if cls is None:
        raise NotImplementedError(f"tower {spec['class_path']!r} is not ported yet; the "
                                  f"port serves {sorted(_TOWERS)}")
    return cls(**(spec.get("init_args") or {}))


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    v = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(v) > 2.0
    while bad.any():
        v[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(v) > 2.0
    return v * np.float32(std)


def _clip_std(name: str, shape, width: int, layers: int) -> float:
    """CLIP's init scheme for one parameter of a plain encoder."""
    attn_std, proj_std, fc_std = clip_init_stds(width, layers)
    if ".in_proj." in name:
        return attn_std                      # the in-projection's weight and bias
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return 0.0
    if name.endswith(("out_proj.kernel", "c_proj.kernel")):
        return proj_std
    if name.endswith("c_fc.kernel"):
        return fc_std
    if leaf in ("class_embedding", "embedding"):
        return 0.02
    if leaf == "positional_embedding":
        return 0.01
    if leaf in ("patch_kernel", "proj", "text_projection"):
        return width ** -0.5
    return shape[0] ** -0.5                  # the compression embedding's expand


@torch.no_grad()
def seeded_clip_init(encoder: nn.Module, rng: np.random.Generator) -> nn.Module:
    """Random weights for an ``ImageEncoder`` / ``TextEncoder`` from a numpy
    generator, by CLIP's init scheme: LN scale 1, normals at the stds of
    ``clip_init_stds`` and of the embeddings and projections."""
    tower = encoder.visual if isinstance(encoder, ImageEncoder) else encoder.text
    width, layers = tower.transformer.width, tower.transformer.layers
    for name, p in encoder.named_parameters():
        if name.endswith(".scale"):
            v = np.ones(p.shape, np.float32)
        else:
            std = _clip_std(name, p.shape, width, layers)
            v = rng.standard_normal(p.shape, dtype=np.float32) * np.float32(std)
        p.copy_(torch.from_numpy(v))
    return encoder


@torch.no_grad()
def seeded_init(module: nn.Module, rng: np.random.Generator) -> nn.Module:
    """Random weights from a numpy generator, by the towers' init rules.  The
    weight-share students: LN scale 1, biases 0, embedding tables N(0, 0.02),
    everything else a normal truncated at 2σ with σ = 0.02.  The plain CLIP
    encoders: :func:`seeded_clip_init`."""
    if isinstance(module, (ImageEncoder, TextEncoder)):
        return seeded_clip_init(module, rng)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            v = np.ones(p.shape, np.float32)
        elif leaf in ("bias", "patch_bias"):
            v = np.zeros(p.shape, np.float32)
        elif leaf == "embedding":
            v = rng.standard_normal(p.shape, dtype=np.float32) * np.float32(0.02)
        else:
            v = _trunc_normal(rng, p.shape, 0.02)
        p.copy_(torch.from_numpy(v))
    return module


class LCLIPScorer:
    """Cosine L-CLIPScore of (image, caption-token) pairs on one device.

    The towers' weights are cast to ``dtype`` once (``cast_to_compute``) and
    moved to ``device`` once; requests move only their own tensors.
    """

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        self.dtype = dtype
        self.image_tower = cast_to_compute(image_tower.eval(), dtype).to(self.device)
        self.text_tower = cast_to_compute(text_tower.eval(), dtype).to(self.device)

    @classmethod
    def from_config(cls, config_yaml: str, image_params: Optional[dict] = None,
                    text_params: Optional[dict] = None, device="cuda",
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> "LCLIPScorer":
        """Both students from ``model.init_args.{image,text}_student`` of a
        stage-3 config.  ``*_params`` are state dicts (``convert.py`` makes
        them from JAX params); a tower without one gets seeded random weights."""
        with open(config_yaml) as f:
            init_args = yaml.safe_load(f)["model"]["init_args"]
        rng = np.random.default_rng(seed)
        towers = []
        for key, params in (("image_student", image_params), ("text_student", text_params)):
            tower = build_tower(init_args[key])
            if params is None:
                seeded_init(tower, rng)
            else:
                tower.load_state_dict(params, strict=True)
            towers.append(tower)
        return cls(*towers, device=device, dtype=dtype)

    # -- device legs ---------------------------------------------------------

    def _to_device(self, x, pin: bool = False) -> torch.Tensor:
        t = torch.as_tensor(x)
        if t.device == self.device:
            return t
        if pin and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _image_features(self, images: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.image_tower(prepare_inputs(images, self.dtype)).float())

    def _text_features(self, tokens: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.text_tower(tokens.long()).float())

    def _score_on_device(self, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        if len(images) != len(tokens):
            raise ValueError(f"score_tokens expects aligned pairs, got {len(images)} "
                             f"images and {len(tokens)} token rows")
        with torch.inference_mode():
            return (self._image_features(images) * self._text_features(tokens)).sum(dim=1)

    # -- public API ----------------------------------------------------------

    def encode_images(self, images) -> np.ndarray:
        """[B, out_dim] unit-norm fp32 features of NHWC uint8 or float images."""
        with torch.inference_mode():
            return self._image_features(self._to_device(images)).cpu().numpy()

    def encode_tokens(self, tokens) -> np.ndarray:
        """[B, out_dim] unit-norm fp32 features of ``[B, context_length]`` ids."""
        with torch.inference_mode():
            return self._text_features(self._to_device(tokens)).cpu().numpy()

    def score_tokens(self, images, tokens) -> np.ndarray:
        """Per-pair cosine of aligned images and token rows, ``[B]`` fp32."""
        scores = self._score_on_device(self._to_device(images), self._to_device(tokens))
        return scores.cpu().numpy()

    def score_tokens_stream(self, batches: Iterable[Tuple[object, object]],
                            depth: int = 2) -> Iterator[np.ndarray]:
        """Score a stream of (images, tokens) batches, yielding each batch's
        scores in order, with up to ``depth`` batches in flight.

        On a CUDA device each batch's inputs are copied from pinned host
        memory without blocking, its scores come back the same way, and the
        host waits only on the oldest batch, so it stages the next batches
        while the card computes.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        cuda = self.device.type == "cuda"
        inflight = deque()
        for images, tokens in batches:
            scores = self._score_on_device(self._to_device(images, pin=True),
                                           self._to_device(tokens, pin=True))
            done = None
            if cuda:
                host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
                host.copy_(scores, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                scores = host
            inflight.append((scores, done))
            if len(inflight) >= depth:
                yield self._collect(*inflight.popleft())
        while inflight:
            yield self._collect(*inflight.popleft())

    @staticmethod
    def _collect(scores: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return scores.numpy().copy()

    def similarity_matrix(self, images, tokens) -> np.ndarray:
        """[N_img, N_txt] cosine matrix of images against token rows."""
        return self.encode_images(images) @ self.encode_tokens(tokens).T
