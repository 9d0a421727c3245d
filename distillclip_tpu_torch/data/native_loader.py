"""ctypes binding of the native JPEG decode pipeline.

Port of ``distillclip_tpu/data/native_loader.py``: loads
``native/libdcloader.so`` (threaded libjpeg decode, bilinear resize and
center crop, CLIP normalisation; source ``native/dataloader.cc``, shared as a
file with the JAX package) and decodes

* a batch of files (:func:`decode_batch_files`, for scoring): where the
  library is absent or does not load (it links ``libjpeg.so.62``), every file
  is decoded with PIL through :func:`data.transforms.eval_image_transform`,
  and a missing or unreadable file raises, as the JAX package's
  ``score_files`` does;
* a batch of in-memory encoded images (:func:`decode_batch_buffers`): without
  the library PIL decodes them, and a buffer it cannot read stays a zero row,
  as in the JAX package;
* one file to uint8 pixels before normalisation (:func:`decode_raw_file`, the
  train path, where RandAugment needs the pixels): ``None`` where the library
  is absent or the decode fails, and the caller decodes with PIL.

Rows the native decoder failed (a PNG) are retried with PIL, and a row PIL
cannot read either stays zero, as in the JAX package's decoder.  Host
decoding, not a kernel: the card's machine decodes with PIL (ROADMAP §3).
"""

from __future__ import annotations

import ctypes
import io
import os
from typing import List, Optional, Sequence

import numpy as np

from distillclip_tpu_torch.data.transforms import IMAGE_MEAN, IMAGE_STD, eval_image_transform

_LIB = None
_SEARCHED = False


def _find_lib() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for c in (os.environ.get("DCLOADER_PATH") or "",
              os.path.join(root, "native", "libdcloader.so")):
        if c and os.path.exists(c):
            return c
    return None


def load_library():
    """The loaded library, or None where it is absent or does not load."""
    global _LIB, _SEARCHED
    if _LIB is not None or _SEARCHED:
        return _LIB
    _SEARCHED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.dc_decode_batch_files.restype = ctypes.c_int
    lib.dc_decode_batch_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.dc_decode_batch_buffers.restype = ctypes.c_int
    lib.dc_decode_batch_buffers.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    if hasattr(lib, "dc_decode_raw_file"):
        lib.dc_decode_raw_file.restype = ctypes.c_int
        lib.dc_decode_raw_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
    _LIB = lib
    return lib


def available() -> bool:
    return load_library() is not None


def decode_batch_files(paths: Sequence[str], size: int = 224,
                       num_threads: int = 8) -> np.ndarray:
    """[N, size, size, 3] float32 CLIP-normalised NHWC batch of image files:
    the native decoder, and PIL for the rows it could not decode (a PNG).
    Without the library every file goes through PIL, and one that cannot be
    opened or decoded raises."""
    lib = load_library()
    n = len(paths)
    if lib is None:
        from PIL import Image

        tf = eval_image_transform(size)
        if not n:
            return np.zeros((0, size, size, 3), np.float32)
        return np.stack([tf(Image.open(p)) for p in paths])
    out = np.zeros((n, size, size, 3), np.float32)
    mean, std = _mean_std()
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.dc_decode_batch_files(arr, n, size, _fp(mean), _fp(std), _fp(out),
                                         num_threads)
    if failures:
        zero_rows = np.where(np.abs(out).sum(axis=(1, 2, 3)) == 0)[0]
        _pil_batch([paths[i] for i in zero_rows], size, out, rows=zero_rows)
    return out


def decode_batch_buffers(buffers: List[bytes], size: int = 224,
                         num_threads: int = 8) -> np.ndarray:
    """[N, size, size, 3] float32 CLIP-normalised NHWC batch of encoded
    images in memory; a buffer that neither decoder reads is a zero row."""
    lib = load_library()
    n = len(buffers)
    out = np.zeros((n, size, size, 3), np.float32)
    if lib is None:
        return _pil_batch([io.BytesIO(b) for b in buffers], size, out, range(n))
    mean, std = _mean_std()
    arr = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in buffers])
    failures = lib.dc_decode_batch_buffers(arr, lens, n, size, _fp(mean), _fp(std), _fp(out),
                                           num_threads)
    if failures:
        zero_rows = np.where(np.abs(out).sum(axis=(1, 2, 3)) == 0)[0]
        _pil_batch([io.BytesIO(buffers[i]) for i in zero_rows], size, out, rows=zero_rows)
    return out


def decode_raw_file(path: str, size: int = 224) -> Optional[np.ndarray]:
    """One JPEG file -> uint8 RGB ``[size, size, 3]`` (shorter side resized,
    center crop, not normalised) through the native pipeline; None where the
    library is absent or the decode fails, and the caller decodes with PIL."""
    lib = load_library()
    if lib is None or not hasattr(lib, "dc_decode_raw_file"):
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.dc_decode_raw_file(path.encode(), size,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def _mean_std():
    return np.asarray(IMAGE_MEAN, np.float32), np.asarray(IMAGE_STD, np.float32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _pil_batch(sources, size, out, rows):
    """Decode ``sources`` (paths or file objects) with PIL into ``rows`` of
    ``out``; a row PIL cannot read stays zero."""
    from PIL import Image

    tf = eval_image_transform(size)
    for row, src in zip(rows, sources):
        try:
            out[row] = tf(Image.open(src))
        except Exception:
            pass
    return out
