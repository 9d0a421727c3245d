"""ctypes binding of the native JPEG decode pipeline, for scoring files.

Port of ``distillclip_tpu/data/native_loader.py::decode_batch_files``: loads
``native/libdcloader.so`` (threaded libjpeg decode, bilinear resize and
center crop, CLIP normalisation; source ``native/dataloader.cc``, shared as a
file with the JAX package) and decodes a batch of files.  Where the library
is absent or does not load (it links ``libjpeg.so.62``), every file is decoded
with PIL through :func:`data.transforms.eval_image_transform`, and a missing or
unreadable file raises, as the JAX package's ``score_files`` does.  Rows the
native decoder failed (a PNG) are retried with PIL, and a row PIL cannot read
either stays zero, as in the JAX package's decoder.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

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
    mean = np.asarray(IMAGE_MEAN, np.float32)
    std = np.asarray(IMAGE_STD, np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.dc_decode_batch_files(arr, n, size, fp(mean), fp(std), fp(out), num_threads)
    if failures:
        zero_rows = np.where(np.abs(out).sum(axis=(1, 2, 3)) == 0)[0]
        _pil_batch([paths[i] for i in zero_rows], size, out, rows=zero_rows)
    return out


def _pil_batch(paths, size, out, rows):
    """Retry the rows the native decoder failed; a row PIL cannot read
    either stays zero."""
    from PIL import Image

    tf = eval_image_transform(size)
    for row, p in zip(rows, paths):
        try:
            out[row] = tf(Image.open(p))
        except Exception:
            pass
    return out
