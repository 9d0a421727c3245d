"""The port's train-time transforms against the JAX package's: given the same
``random.Random(seed)``, RandAugment draws the same ops and magnitudes and
both return the same pixels, for every op and for the whole train transform."""

import random

import numpy as np
import pytest
from PIL import Image

from distillclip_tpu.data import transforms as jax_tf
from distillclip_tpu_torch.data import transforms as tf

OPS = ["Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate", "Brightness",
       "Color", "Contrast", "Sharpness", "Posterize", "Solarize", "AutoContrast",
       "Equalize", "Invert"]


def _image(seed, w=61, h=47):
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 255, size=(h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
    return Image.fromarray(low).resize((w, h), Image.BICUBIC)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("magnitude", [0.0, 0.3, -0.45, 7.0])
def test_every_op_gives_jax_s_pixels(op, magnitude):
    img = _image(1)
    mag = magnitude if op not in ("Posterize",) else abs(magnitude) % 8 + 1
    np.testing.assert_array_equal(np.asarray(tf._apply_op(img, op, mag)),
                                  np.asarray(jax_tf._apply_op(img, op, mag)))


def test_unknown_op_raises_like_jax():
    for mod in (tf, jax_tf):
        with pytest.raises(ValueError, match="unknown RandAugment op"):
            mod._apply_op(_image(0), "Blur", 1.0)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("num_ops,magnitude", [(2, 9), (4, 9), (4, 30), (3, 0)])
def test_rand_augment_draws_and_pixels_equal_jax(seed, num_ops, magnitude):
    img = _image(seed)
    ours = tf.RandAugment(num_ops, magnitude, rng=random.Random(seed))
    ref = jax_tf.RandAugment(num_ops, magnitude, rng=random.Random(seed))
    for _ in range(3):     # the rng carries on across calls
        np.testing.assert_array_equal(np.asarray(ours(img)), np.asarray(ref(img)))
    assert ours.rng.random() == ref.rng.random()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("size", [32, 224])
def test_train_transform_equals_jax(seed, size):
    img = _image(seed + 10, 300, 200)
    ours = tf.train_image_transform(size, 4, rng=random.Random(seed))
    ref = jax_tf.train_image_transform(size, 4, rng=random.Random(seed))
    for _ in range(2):
        a, b = ours(img), ref(img)
        assert a.dtype == b.dtype == np.float32 and a.shape == (size, size, 3)
        np.testing.assert_array_equal(a, b)


def test_every_op_name_is_drawn():
    """The op space is JAX's: 14 names, each reachable."""
    space = tf.RandAugment()._space((32, 32))
    assert list(space) == list(jax_tf.RandAugment()._space((32, 32)))
    ra = tf.RandAugment(1, rng=random.Random(0))
    seen = {list(space)[ra.rng.randrange(len(space))] for _ in range(400)}
    assert seen == set(space)
