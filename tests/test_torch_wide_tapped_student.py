"""A tapped 32-head student's stage-1 step against the JAX package, on the CPU.

A loss that reads the towers' hidden states (``hidden_rep_mse``, ``vit_kd``)
sends the weight-share student's attention to the head-transform forward on
``[B, H, N, d]`` views (#17) and its gradient to the plain fp32 recompute,
where JAX's students call their head-transform Pallas kernel at any head
count.  Here the student has 32 heads of 8 (256 wide, depth 2, repeated twice)
against a fabricated 256-wide teacher (4 heads of 64), both at 17 tokens; the
tensor-core #17 takes 32 heads of 8 on the card.  fp32, the JAX towers on their
XLA path (DISTILLCLIP_FLASH=0), the JAX task initialises the student and its
tree crosses through ``convert``: loss and parts within 1e-5 relative, every
leaf's gradient within 1e-4 of its largest entry (as
``test_torch_tap_steps.py`` holds the narrow students); two port train
steps then move the head mixes.  ``vit_kd``'s token mask is numpy-seeded and
patched into both packages.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.losses import vit_kd as jax_vit_kd
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.training.distill import DistillTask as JaxDistillTask
from distillclip_tpu_torch.convert import jax_distill_params_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.losses import vit_kd as port_vit_kd
from distillclip_tpu_torch.models import RepeatVisionTransformer
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
from distillclip_tpu_torch.training import DistillTask

from test_torch_training import TASK_ARGS, _flat, _np_tree, _rel

# ``ops.flash_attention`` is the public function; this is its module
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

B, RES, PATCH, WIDTH, HEADS, OUT = 4, 32, 8, 256, 32, 48
TEACHER = dict(vision_width=WIDTH, vision_layers=3, patch_size=PATCH, image_resolution=RES,
               text_width=64, text_layers=1, context_length=12, vocab_size=100, embed_dim=OUT)
STUDENT = dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=WIDTH, depth=2,
               num_heads=HEADS, repeated_times=2, qkv_bias=True, use_transform=True)
LOSSES = {
    "hidden_rep_mse": {"loss_name": ["out_l1", "out_cos", "hidden_rep_mse"]},
    "hidden_rep_mse, embedding_mse, vit_kd": {
        "loss_name": ["out_l1", "hidden_rep_mse", "embedding_mse", "vit_kd"],
        "loss_scale": {"vit_kd": 100.0},
        "vit_kd_para": dict(student_dims=WIDTH, teacher_dims=WIDTH, low_layers_num=1,
                            high_layers_num=1)},
}


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "clip_256.pt"
    torch.save(make_clip_state_dict(**TEACHER), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(19)
    return dict(image=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                mask=(rng.random((B, (RES // PATCH) ** 2)) < 0.5).astype(np.float32))


@pytest.fixture
def same_mask(batch, monkeypatch):
    """The JAX towers on XLA; vit_kd's token mask the same in both packages."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    monkeypatch.setattr(jax_vit_kd, "random_masking",
                        lambda rng, x, ratio: jnp.asarray(batch["mask"][:x.shape[0]], x.dtype))
    monkeypatch.setattr(port_vit_kd, "random_masking", lambda x, ratio, generator=None:
                        torch.from_numpy(batch["mask"][:x.shape[0]]))


def _as_jax_layout(params):
    """The port's leaves with the convolution kernels back in HWIO."""
    return {k: v.detach().permute(2, 3, 1, 0) if k.startswith("loss_aux.")
            and k.endswith(".weight") else v.detach() for k, v in params.items()}


@pytest.mark.parametrize("losses", list(LOSSES))
def test_tapped_32_head_student_step_matches_jax(losses, ckpt_path, batch, same_mask):
    assert fa.tensor_core_head_shape(HEADS, WIDTH // HEADS)     # #17's tensor cores on the card
    common = dict(loss_control_para=LOSSES[losses], teacher_name=ckpt_path, model_type="image",
                  teacher_need_layers=[0, 2], compute_dtype="float32", **TASK_ARGS)
    jtask = JaxDistillTask(student=JaxVision(**STUDENT), **common)
    ptask = DistillTask(student=RepeatVisionTransformer(**STUDENT), **common)
    assert ptask.flags.need_rep and jtask.flags.need_rep
    x = batch["image"]
    jstate, _ = jtask.init_state(jax.random.PRNGKey(3), jnp.asarray(x[:1]), steps_per_epoch=1)
    pstate, ptx = ptask.init_state(0, 1, device="cpu", params=jax_distill_params_to_torch(
        _np_tree(jstate.params), "image"))

    def jvg(params):
        def f(p):
            out = jtask.loss_fn(p, jtask.teacher_vars, jnp.asarray(x), jax.random.PRNGKey(0),
                                True)
            return out[0], out[1][0]
        return jax.jit(jax.value_and_grad(f, has_aux=True))(params)

    (jloss, jparts), jgrads = jvg(jstate.params)
    xp = torch.from_numpy(x)
    leaves = {k: v.clone().requires_grad_() for k, v in pstate.params.items()}
    loss, (parts, _, _) = ptask.loss_fn(leaves, xp)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(parts) == set(jparts)
    for k in parts:
        assert abs(float(parts[k].detach()) - float(jparts[k])) \
            <= 1e-5 * max(abs(float(jparts[k])), 1e-6), k
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref = _flat(jgrads)
    assert {torch_name_to_jax_path(k) for k in leaves} == set(ref)
    for name, g in _as_jax_layout(grads).items():
        r = ref[torch_name_to_jax_path(name)]
        assert g.shape == r.shape and _rel(g.numpy(), r) <= 1e-4, name
    # the head mixes of every repeat get a gradient through the recompute
    assert all(float(grads[k].abs().max()) > 0 for k in grads if "conv_" in k)

    # two train steps (the first lr is 0): the mixes move, the loss stays finite
    before = {k: v.clone() for k, v in pstate.params.items() if "conv_" in k}
    step = ptask.make_train_step(ptx)
    for _ in range(2):
        pstate, metrics = step(pstate, xp)
    assert np.isfinite(float(metrics["loss"])) and pstate.step == 2
    assert all(not torch.equal(pstate.params[k], v) for k, v in before.items())
