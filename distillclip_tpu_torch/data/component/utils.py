"""Dataset-name tables and the teacher's pre-encoding of a corpus.

Port of ``distillclip_tpu/data/component/utils.py``.  The encoders run the
frozen CLIP teacher of the port (``models.frozen_teacher.FrozenTeacher``, the
lean encodes that ``DualDistillTask.make_teacher_image_encode`` /
``make_teacher_text_encode`` return) on ``device``, which the caller names:
``prepare()`` takes the run's device from its arguments
(``MainDataModule.prepare_data(device)``), and there is no default.  They
encode in chunks of ``batch_size`` rows, the last chunk not padded, in bf16
(the kernels' dtype) on the card and in fp32 elsewhere, as the JAX package
encodes.  The reference runs the clip package on CUDA (utils.py:15-40).  Each
encode logs its rows, chunks and seconds at INFO (the record's ``encode``
attribute holds them).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from distillclip_tpu_torch.data.tokenizer import build_tokenizer
from distillclip_tpu_torch.data.transforms import eval_image_transform

log = logging.getLogger(__name__)

IMAGE_DATASET_NAME = ["coco", "data_256", "imagenet"]
IMAGE_PREFIX = {"coco": "0", "data_256": "data_256", "imagenet": "imagenet"}


def prepare_device(prepare_args: dict) -> torch.device:
    """The run's device that ``MainDataModule.prepare_data`` put in the
    prepare arguments; a ``prepare`` called without one is an error."""
    device = prepare_args.get("device")
    if device is None:
        raise ValueError("prepare() encodes with the teacher on the run's device: call "
                         "MainDataModule.prepare_data(device), or pass prepare_args['device']")
    return torch.device(device)


def _teacher(teacher_name: str, download_root: Optional[str], model_type: str, device):
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher

    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return FrozenTeacher(teacher_name, download_root, model_type, None, dtype)


def _chunked(name: str, encode: Callable, rows: Sequence, batch_size: int,
             make) -> np.ndarray:
    t0 = time.perf_counter()
    out = [encode(make(rows[i:i + batch_size])).cpu().numpy()     # each chunk read back
           for i in range(0, len(rows), batch_size)]
    seconds = time.perf_counter() - t0
    log.info("%s: %d rows in %d chunks of %d, %.2f s, %.1f rows/s", name, len(rows), len(out),
             batch_size, seconds, len(rows) / seconds,
             extra={"encode": {"encoder": name, "rows": len(rows), "chunks": len(out),
                               "batch_size": batch_size, "seconds": seconds}})
    return np.concatenate(out, axis=0).astype(np.float32)


def encode_images(path_list: Sequence, teacher_name: str, device,
                  download_root: Optional[str] = None, batch_size: int = 64) -> np.ndarray:
    """The image teacher's last representations ``[N, D]`` fp32 of image
    files, each through the eval transform at the teacher's resolution."""
    from PIL import Image

    teacher = _teacher(teacher_name, download_root, "image", device)
    from distillclip_tpu_torch.serving.lclip_score import image_size_of

    transform = eval_image_transform(image_size_of(teacher.module))
    return _chunked("encode_images", teacher.image_encode(device), list(path_list), batch_size,
                    lambda chunk: np.stack([transform(Image.open(str(p))) for p in chunk]))


def encode_tokens(tokens: np.ndarray, teacher_name: str, device,
                  download_root: Optional[str] = None, batch_size: int = 512) -> np.ndarray:
    """The text teacher's last representations ``[N, D]`` fp32 of a token
    array ``[N, L]``: the stage-2 train corpus, so that the train step can
    drop the teacher (the reference pre-encodes only the validation set,
    combine_text_dataset.py:59-82)."""
    teacher = _teacher(teacher_name, download_root, "text", device)
    return _chunked("encode_tokens", teacher.text_encode(device), tokens, batch_size,
                    lambda chunk: chunk)


def encode_texts(caption_list: Sequence[str], teacher_name: str, device,
                 download_root: Optional[str] = None, bpe_path: Optional[str] = None,
                 batch_size: int = 256) -> np.ndarray:
    """The text teacher's last representations ``[N, D]`` fp32 of captions,
    tokenised at the teacher's context length."""
    teacher = _teacher(teacher_name, download_root, "text", device)
    context_length = teacher.module.text.context_length
    tokenizer = build_tokenizer(bpe_path, context_length=context_length)
    return _chunked("encode_texts", teacher.text_encode(device), list(caption_list), batch_size,
                    lambda chunk: tokenizer.tokenize(chunk, context_length=context_length))


def encoder_args(prepare_args: dict) -> dict:
    """The keyword arguments every encoder takes, from ``prepare``'s."""
    return {"device": prepare_device(prepare_args),
            "download_root": prepare_args.get("download_root")}
