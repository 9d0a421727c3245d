"""The port's native decoders against the JAX package's: ``decode_raw_file``
and ``decode_batch_buffers`` give the same arrays through
``native/libdcloader.so`` (skipped where it does not load, as
``tests/test_native_loader.py`` skips), and without the library they give
what the JAX package's give without it (``None`` / PIL)."""

import ctypes
import io
import os

import numpy as np
import pytest
from PIL import Image

from distillclip_tpu.data import native_loader as jax_native
from distillclip_tpu_torch.data import native_loader as native

LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                   "libdcloader.so")


@pytest.fixture(scope="module")
def lib():
    try:
        ctypes.CDLL(LIB)
    except OSError as e:
        pytest.skip(f"native/libdcloader.so does not load: {e}")
    assert native.load_library() is not None and jax_native.load_library() is not None


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(300, 200), (64, 96), (224, 224), (50, 40)]):
        low = rng.integers(0, 255, size=(h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
        p = root / f"img{i}.jpg"
        Image.fromarray(low).resize((w, h), Image.BICUBIC).save(str(p), quality=90)
        paths.append(str(p))
    png = root / "img.png"
    Image.fromarray(rng.integers(0, 255, size=(40, 30, 3), dtype=np.uint8)).save(str(png))
    (root / "broken.jpg").write_bytes(b"not an image")
    return paths, str(png), str(root / "broken.jpg")


@pytest.mark.parametrize("size", [32, 224])
def test_raw_file_equals_jax(lib, files, size):
    paths, png, broken = files
    for p in paths:
        a, b = native.decode_raw_file(p, size), jax_native.decode_raw_file(p, size)
        assert a.dtype == np.uint8 and a.shape == (size, size, 3)
        np.testing.assert_array_equal(a, b)
    for p in (png, broken, paths[0] + ".missing"):
        assert native.decode_raw_file(p, size) is None is jax_native.decode_raw_file(p, size)


@pytest.mark.parametrize("size", [32, 224])
def test_batch_buffers_equal_jax(lib, files, size):
    paths, png, broken = files
    buffers = [open(p, "rb").read() for p in paths + [png, broken]]
    a = native.decode_batch_buffers(buffers, size, num_threads=2)
    b = jax_native.decode_batch_buffers(buffers, size, num_threads=2)
    assert a.dtype == np.float32 and a.shape == (len(buffers), size, size, 3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a[-2]).sum() > 0 and np.abs(a[-1]).sum() == 0   # PNG by PIL; junk zero


@pytest.fixture()
def no_library(monkeypatch):
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_SEARCHED", True)


def test_without_the_library_raw_is_none_and_buffers_go_through_pil(files, no_library):
    paths, png, broken = files
    assert native.decode_raw_file(paths[0]) is None is jax_native.decode_raw_file(paths[0])
    buffers = [open(p, "rb").read() for p in paths + [png, broken]]
    a = native.decode_batch_buffers(buffers, 32)
    np.testing.assert_array_equal(a, jax_native.decode_batch_buffers(buffers, 32))
    from distillclip_tpu_torch.data.transforms import eval_image_transform

    np.testing.assert_array_equal(a[0], eval_image_transform(32)(
        Image.open(io.BytesIO(buffers[0]))))
    assert np.abs(a[-1]).sum() == 0
