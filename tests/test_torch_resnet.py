"""The ResNet (ModifiedResNet) teacher in the port against the JAX package, on
the CPU: a fabricated RN-class checkpoint read by both loaders, the image
tower's representations in fp32 and in the teachers' bf16 compute copy, the
fabricator's tensors, and the port's users of a teacher (the "all" load, the
scorer, a stage-1 step) on it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import teacher as jax_teacher
from distillclip_tpu.tools import fabricate_teacher as jax_fabricate
from distillclip_tpu_torch.models import CLIPModel, ControlFlags, ModifiedResNet, teacher
from distillclip_tpu_torch.tools import fabricate_teacher

LAYERS = (1, 2, 1, 1)      # a stage with two blocks: one without a downsample branch


@pytest.fixture(scope="module")
def rn_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("rn") / "tiny_rn.pt"
    torch.save(fabricate_teacher.make_rn_state_dict(layers=LAYERS), str(path))
    return str(path)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32)


def test_fabricated_rn_checkpoint_equals_jax_s():
    for kw in ({}, dict(layers=(3, 4, 6, 3), width=8, image_resolution=96, seed=3)):
        ours, ref = fabricate_teacher.make_rn_state_dict(**kw), \
            jax_fabricate.make_rn_state_dict(**kw)
        assert list(ours) == list(ref)
        for k in ref:
            assert torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), LAYERS], ids=["defaults", "two_blocks"])
def test_rn_image_tower_equals_jax_fp32(layers, tmp_path, images):
    rn_path = str(tmp_path / "rn.pt")
    torch.save(fabricate_teacher.make_rn_state_dict(layers=layers), rn_path)
    jmod, jvars = jax_teacher.load_image_teacher(rn_path)
    pmod = teacher.teacher_load(rn_path, None, "image", device="cpu")
    assert isinstance(pmod, ModifiedResNet) and pmod.layers == jmod.layers == layers
    assert (pmod.input_resolution, pmod.attnpool.heads) == (jmod.input_resolution, jmod.heads)
    assert not any(p.requires_grad for p in pmod.parameters()) and not pmod.training
    ref = jax.jit(lambda v, x: jmod.apply(v, x, JaxFlags()))(jvars, jnp.asarray(images))
    with torch.no_grad():
        out = pmod(torch.from_numpy(images), ControlFlags(need_rep=True))
        again = pmod(torch.from_numpy(images))
    want = np.asarray(ref.last_representation)
    assert out.last_representation.shape == want.shape == (3, 32)
    np.testing.assert_allclose(out.last_representation.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.last_layer_output.numpy(),
                               np.asarray(ref.last_layer_output), rtol=0, atol=1e-4)
    assert torch.equal(out.last_representation, again.last_representation)     # deterministic


def test_rn_compute_copy_equals_jax_bf16(rn_path, images):
    """The teachers' bf16 compute copy: every leaf rounded first, the
    BatchNorm folded from the rounded statistics in fp32, as in JAX."""
    from distillclip_tpu.training.train_state import cast_to_compute as jax_cast
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher

    jmod, jvars = jax_teacher.load_image_teacher(rn_path)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, JaxFlags()))(
        {"params": jax_cast(jvars["params"], jnp.bfloat16)}, jnp.asarray(images, jnp.bfloat16))
    encode = FrozenTeacher(rn_path, None, "image", None, torch.bfloat16).image_encode("cpu")
    got = encode(torch.from_numpy(images))
    want = np.asarray(ref.last_representation.astype(jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-2 * np.abs(want).max())


def test_rn_teacher_all_load_scorer_and_stage1_step(rn_path, images):
    from distillclip_tpu_torch.models import RepeatVisionTransformer
    from distillclip_tpu_torch.serving import LCLIPScorer
    from distillclip_tpu_torch.training import DistillTask

    clip = teacher.teacher_load(rn_path, None, "all", device="cpu")
    assert isinstance(clip, CLIPModel) and isinstance(clip.image_tower, ModifiedResNet)
    scorer = LCLIPScorer.from_teacher(rn_path, device="cpu", dtype=torch.float32)
    assert scorer.image_size == 64 and scorer.context_length == 12
    tokens = np.zeros((3, 12), np.int64)
    tokens[:, 0], tokens[:, 1:4], tokens[:, 4] = 98, 5, 99
    scores = scorer.score_tokens(images, tokens)
    assert scores.shape == (3,) and np.isfinite(scores).all() and np.abs(scores).max() <= 1.0

    task = DistillTask(
        student=RepeatVisionTransformer(img_size=64, patch_size=32, out_dim=32, embed_dim=32,
                                        depth=2, num_heads=4, repeated_times=2,
                                        use_transform=True),
        loss_control_para={"loss_name": ["out_l1", "out_cos"]}, teacher_name=rn_path,
        model_type="image", compute_dtype="float32", lr=1e-2, warm_steps=0)
    state, tx = task.init_state(0, steps_per_epoch=1, device="cpu")
    step = task.make_train_step(tx)
    batch = torch.from_numpy((np.random.default_rng(1).random((4, 64, 64, 3)) * 255)
                             .astype(np.uint8))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
