"""L-CLIPScore batch inference, with the two students or the CLIP teacher.

Port of ``distillclip_tpu/serving/lclip_score.py::LCLIPScorer``: encode the
image and the caption, L2-normalise both in fp32, and score each aligned pair
by their cosine.  Images arrive NHWC as uint8 (normalised on the device), as
pre-normalised floats, or as files (:meth:`LCLIPScorer.score_files`: the
native JPEG decoder, else PIL); captions as strings (tokenised on the host by
``data.tokenizer``) or as token ids.  The scorer is built from a config with
seeded or converted weights (:meth:`from_config`), from stage checkpoints in
the port's format (:meth:`from_checkpoints`), or from a CLIP teacher
checkpoint (:meth:`from_teacher`).

The JAX scorer pads each request to a batch bucket so that XLA does not
recompile per size; eager PyTorch has no such cost, so requests run at their
own size.  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import yaml
from torch import nn

from distillclip_tpu_torch.config.perf import require_module_kernels
from distillclip_tpu_torch.data.tokenizer import build_tokenizer
from distillclip_tpu_torch.models import (
    ImageEncoder,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
    l2_normalize,
    teacher_load,
)
from distillclip_tpu_torch.models.transformer import clip_init_stds
from distillclip_tpu_torch.serving.inputs import cast_to_compute, prepare_inputs

# the reference's class paths, which the configs use for the students
# (distillclip_tpu/config/loader.py:25-41 maps them to the JAX towers)
TOWERS = {
    "model.component.weight_share_model.RepeatVisionTransformer": RepeatVisionTransformer,
    "model.component.weight_share_model.RepeatTextTransformer": RepeatTextTransformer,
}


def build_tower(spec: dict) -> nn.Module:
    """A student tower from a config's ``{class_path, init_args}`` entry."""
    cls = TOWERS.get(spec["class_path"])
    if cls is None:
        raise NotImplementedError(f"tower {spec['class_path']!r} is not a student tower of "
                                  f"the configs; the port serves {sorted(TOWERS)}")
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
    weight-share students: LN scale 1, biases and iRPE tables 0, embedding
    tables N(0, 0.02), everything else a normal truncated at 2σ with σ = 0.02.  The plain CLIP
    encoders: :func:`seeded_clip_init`."""
    if isinstance(module, (ImageEncoder, TextEncoder)):
        return seeded_clip_init(module, rng)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            v = np.ones(p.shape, np.float32)
        elif leaf in ("bias", "patch_bias") or leaf.startswith("rpe_"):
            v = np.zeros(p.shape, np.float32)        # the iRPE tables start at zero
        elif leaf == "embedding":
            v = rng.standard_normal(p.shape, dtype=np.float32) * np.float32(0.02)
        else:
            v = _trunc_normal(rng, p.shape, 0.02)
        p.copy_(torch.from_numpy(v))
    return module


def image_size_of(tower: nn.Module) -> int:
    """The input resolution of a weight-share student, a CLIP ViT encoder or
    the ResNet teacher tower."""
    for owner in (tower, getattr(tower, "visual", None)):
        for name in ("img_size", "input_resolution"):
            if hasattr(owner, name):
                return getattr(owner, name)
    raise ValueError(f"{type(tower).__name__} states no input resolution")


def _text_dims(tower: nn.Module) -> Tuple[int, int]:
    """(context length, vocabulary size) of a text tower of either family."""
    if hasattr(tower, "context_length"):
        return tower.context_length, tower.vocab_size
    text = tower.text
    return text.context_length, text.token_embedding.embed.embedding.shape[0]


def _rep(out) -> torch.Tensor:
    """The pooled representation: a student's tensor or an encoder's field."""
    return out if isinstance(out, torch.Tensor) else out.last_representation


class LCLIPScorer:
    """Cosine L-CLIPScore of (image, caption) pairs on one device.

    The towers' weights are cast to ``dtype`` once (``cast_to_compute``) and
    moved to ``device`` once; requests move only their own tensors.
    ``tokenizer`` turns captions into ids (by default :func:`data.tokenizer.
    build_tokenizer` without a vocabulary file: the hash tokenizer).
    """

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16, tokenizer=None):
        self.device = torch.device(device)
        for tower in (image_tower, text_tower):
            require_module_kernels(tower, self.device)
        self.dtype = dtype
        self.image_size = image_size_of(image_tower)
        self.context_length = _text_dims(text_tower)[0]
        self.tokenizer = tokenizer or _tokenizer(None, text_tower)
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

    @classmethod
    def from_teacher(cls, teacher_name: str = "ViT-B/32", download_root: str = "./.cache",
                     bpe_path: Optional[str] = None, device="cuda",
                     dtype: torch.dtype = torch.bfloat16) -> "LCLIPScorer":
        """Score with the full CLIP teacher (the reference CLIPScore baseline):
        ``teacher_name`` is a model name (downloaded into ``download_root``
        unless there already) or a checkpoint path."""
        clip = teacher_load(teacher_name, download_root, "all", device="cpu")
        return cls(clip.image_tower, clip.text_tower, device=device, dtype=dtype,
                   tokenizer=_tokenizer(bpe_path, clip.text_tower))

    @classmethod
    def from_checkpoints(cls, image_ckpt: Optional[str] = None,
                         text_ckpt: Optional[str] = None, config: Optional[str] = None,
                         bpe_path: Optional[str] = None, teacher_name: str = "ViT-B/32",
                         download_root: str = "./.cache", device="cuda",
                         dtype: torch.dtype = torch.bfloat16) -> "LCLIPScorer":
        """Both students from a stage-3 config's ``model.init_args`` with their
        weights from stage checkpoints in the port's format
        (``training.checkpoints``; a stage-3 checkpoint serves both towers).
        Without checkpoints (None or empty strings) it is the teacher scorer;
        student checkpoints without ``config`` raise."""
        from distillclip_tpu_torch.training.checkpoints import restore_tower_params

        image_ckpt, text_ckpt = image_ckpt or None, text_ckpt or None
        if image_ckpt is None and text_ckpt is None:
            return cls.from_teacher(teacher_name, download_root, bpe_path, device, dtype)
        if config is None:
            raise ValueError("score with student checkpoints needs --config (the stage-3 "
                             "YAML describing the student tower architectures)")
        if image_ckpt is None or text_ckpt is None:
            raise ValueError("score with student checkpoints needs both --image-ckpt and "
                             "--text-ckpt (one stage-3 checkpoint may serve both)")
        with open(config) as f:
            init_args = yaml.safe_load(f)["model"]["init_args"]
        towers = []
        for key, ckpt, scope in (("image_student", image_ckpt, "image_tower"),
                                 ("text_student", text_ckpt, "text_tower")):
            tower = build_tower(init_args[key])
            tower.load_state_dict(restore_tower_params(ckpt, tower.state_dict(), tower=scope),
                                  strict=True)
            towers.append(tower)
        return cls(*towers, device=device, dtype=dtype,
                   tokenizer=_tokenizer(bpe_path, towers[1]))

    # -- device legs ---------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        return t if t.device == self.device else t.to(self.device)

    def _pinned(self, x) -> torch.Tensor:
        """``x`` as a tensor; in pinned host memory where it is to be copied
        to a card without blocking."""
        t = torch.as_tensor(x)
        return t.pin_memory() if self.device.type == "cuda" and t.device.type == "cpu" else t

    def _image_features(self, images: torch.Tensor) -> torch.Tensor:
        return l2_normalize(_rep(self.image_tower(prepare_inputs(images, self.dtype))).float())

    def _text_features(self, tokens: torch.Tensor) -> torch.Tensor:
        return l2_normalize(_rep(self.text_tower(tokens.long())).float())

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

        Under ``torch.profiler`` each batch shows three spans
        (``training.profiling.span``): ``score.stage`` (its inputs copied into
        pinned memory), ``score.launch`` (the copies to the device, the
        towers, the readback queued) and ``score.wait`` (the host waiting for
        its scores and copying them out).
        """
        # imported here: the training package imports this module
        from distillclip_tpu_torch.training.profiling import span

        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        cuda = self.device.type == "cuda"
        inflight = deque()

        def oldest() -> np.ndarray:
            with span("score.wait"):
                return self._collect(*inflight.popleft())

        for images, tokens in batches:
            with span("score.stage"):
                images, tokens = self._pinned(images), self._pinned(tokens)
            with span("score.launch"):
                scores = self._score_on_device(images.to(self.device, non_blocking=True),
                                               tokens.to(self.device, non_blocking=True))
                done = None
                if cuda:
                    host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
                    host.copy_(scores, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    scores = host
                inflight.append((scores, done))
            if len(inflight) >= depth:
                yield oldest()
        while inflight:
            yield oldest()

    @staticmethod
    def _collect(scores: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return scores.numpy().copy()

    def _tokenize(self, captions: Sequence[str]) -> np.ndarray:
        """``[N, context_length]`` ids of the captions (host work)."""
        return self.tokenizer.tokenize(list(captions), context_length=self.context_length)

    def encode_captions(self, captions: Sequence[str]) -> np.ndarray:
        """[N, out_dim] unit-norm fp32 features of caption strings."""
        return self.encode_tokens(self._tokenize(captions))

    def score_arrays(self, images, captions: Sequence[str]) -> np.ndarray:
        """Per-pair cosine L-CLIPScore of aligned images and caption strings."""
        return self.score_tokens(images, self._tokenize(captions))

    def score_files(self, image_paths: Sequence[str], captions: Sequence[str]) -> np.ndarray:
        """Per-pair score of image files and caption strings: the files are
        decoded, resized, center-cropped and normalised on the host (the
        native decoder, else PIL), the captions tokenised."""
        from distillclip_tpu_torch.data import native_loader

        images = native_loader.decode_batch_files([str(p) for p in image_paths],
                                                  size=self.image_size)
        return self.score_arrays(images, captions)

    def similarity_matrix(self, images, captions: Sequence[str]) -> np.ndarray:
        """[N_img, N_txt] cosine matrix of images against caption strings."""
        return self._similarity_matrix_tokens(images, self._tokenize(captions))

    def _similarity_matrix_tokens(self, images, tokens) -> np.ndarray:
        """[N_img, N_txt] cosine matrix of images against token rows."""
        return self.encode_images(images) @ self.encode_tokens(tokens).T


def _tokenizer(bpe_path: Optional[str], text_tower: nn.Module):
    """The caption tokenizer for ``text_tower``: CLIP's BPE where a
    vocabulary file is given or ``CLIP_BPE_PATH`` names one, else the hash
    tokenizer bounded by the tower's vocabulary."""
    ctx, vocab = _text_dims(text_tower)
    return build_tokenizer(bpe_path, context_length=ctx, vocab_size=vocab)
