"""Parity of the PyTorch port's stage-3 train steps that run a teacher, and of
the students with plain attention, with the JAX package on the CPU.

Both packages load one fabricated CLIP checkpoint as their teacher; the JAX
task initialises the tiny students and its parameter tree crosses to the port
through ``convert.jax_dual_params_to_torch``; both then see the same seeded
batch.  Everything runs in fp32 with the JAX towers on their XLA path
(DISTILLCLIP_FLASH=0): loss and parts within 1e-5 relative, every leaf's
gradient within 1e-4 of its largest entry, three optimizer steps within 1e-5
absolute.  One bf16 case goes through the JAX Pallas kernels in interpret mode.

Adam's first moving update is lr·g / (|g| + 1e-8), which is ill-conditioned
where a gradient is zero up to float32 summation noise (the key bias of a plain
attention layer has an exactly zero gradient in the math, for one).  Elements
whose first gradient is below 1e-6 in magnitude are therefore held to 2e-4, the
key third of a fused qkv bias among them to the size of the two moving updates,
2e-3, and all the others to 1e-5 (``_assert_adam_steps_close``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models.encoders import ImageEncoder as JaxImageEncoder
from distillclip_tpu.models.encoders import TextEncoder as JaxTextEncoder
from distillclip_tpu.training.dual import DualDistillTask as JaxTask
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.convert import jax_dual_params_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.models import (
    ImageEncoder,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
)
from distillclip_tpu_torch.training import DualDistillTask

from test_teacher import CTX, PATCH, RES, VOCAB, _make_state_dict
from test_torch_training import (
    LOSSES,
    TASK_ARGS,
    _assert_adam_steps_close,
    _flat,
    _np_tree,
    _rel,
)

B, OUT = 8, 48
SHARE = dict(
    image=dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=32, depth=2,
               num_heads=4, repeated_times=2, qkv_bias=True, use_transform=True),
    text=dict(vocab_size=VOCAB, context_length=CTX, out_dim=OUT, embed_dim=32, depth=2,
              num_heads=4, repeated_times=2, use_transform=True))
# the same students without head mixes: plain attention forward and backward
PLAIN = dict(image=dict(SHARE["image"], use_transform=False),
             text=dict(SHARE["text"], use_transform=False))
# plain CLIP-architecture students (two heads of 64, as the width // 64 rule)
ENCODER = dict(
    image=dict(is_student=True, input_resolution=RES, patch_size=PATCH, width=128, layers=2,
               heads=2, output_dim=OUT),
    text=dict(is_student=True, vocab_size=VOCAB, context_length=CTX, width=128, layers=1,
              heads=2, output_dim=OUT))
# the teacher's patch geometry and width, for freeze_embed
EMBED = dict(image=dict(SHARE["image"], embed_dim=64), text=SHARE["text"])

STUDENTS = {
    "share": (SHARE, JaxVision, JaxText, RepeatVisionTransformer, RepeatTextTransformer),
    "plain_attention": (PLAIN, JaxVision, JaxText, RepeatVisionTransformer,
                        RepeatTextTransformer),
    "encoder": (ENCODER, JaxImageEncoder, JaxTextEncoder, ImageEncoder, TextEncoder),
    "embed": (EMBED, JaxVision, JaxText, RepeatVisionTransformer, RepeatTextTransformer),
}
# mode -> (the batch's keys after tokens and images, the step's keyword)
MODES = {"live": ((), {}), "cached_text": (("tea_text",), {"cached_text_teacher": True}),
         "cached_all": (("tea_text", "tea_image"), {"cached_teachers": True})}


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return dict(tokens=toks, images=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                tea_text=rng.normal(size=(B, OUT)).astype(np.float32),
                tea_image=rng.normal(size=(B, OUT)).astype(np.float32))


def _tasks(kind, ckpt_path, **over):
    args, jimg, jtxt, pimg, ptxt = STUDENTS[kind]
    common = dict(loss_control_para=LOSSES, teacher_name=ckpt_path, **{**TASK_ARGS, **over})
    return (JaxTask(image_student=jimg(**args["image"]), text_student=jtxt(**args["text"]),
                    **common),
            DualDistillTask(image_student=pimg(**args["image"]),
                            text_student=ptxt(**args["text"]), **common))


def _states(jtask, ptask, batch):
    jstate, jtx = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(batch["tokens"][:1]),
                                   jnp.asarray(batch["images"][:1]), steps_per_epoch=1)
    pstate, ptx = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    return jstate, jtx, pstate, ptx


def _jax_value_and_grad(task, mode, params, batch):
    toks, imgs = jnp.asarray(batch["tokens"]), jnp.asarray(batch["images"])
    extra = [jnp.asarray(batch[k]) for k in MODES[mode][0]]
    rng = jax.random.PRNGKey(0)

    def loss_fn(p):
        if mode == "live":
            out = task.loss_fn(p, task.teacher_vars, toks, imgs, rng, True)
        elif mode == "cached_text":
            out = task.loss_fn_cached_text(p, task.teacher_vars, toks, imgs, *extra, rng, True)
        else:
            out = task.loss_fn_cached_all(p, toks, imgs, *extra, rng, True)
        return out[0], out[1][0]
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _port_batch(mode, batch):
    return [torch.from_numpy(batch[k]) for k in ("tokens", "images") + MODES[mode][0]]


def _port_loss(task, mode, params, batch):
    fn = {"live": task.loss_fn, "cached_text": task.loss_fn_cached_text,
          "cached_all": task.loss_fn_cached_all}[mode]
    return fn(params, *_port_batch(mode, batch))


def _assert_step_parity(kind, mode, ckpt_path, batch, **over):
    jtask, ptask = _tasks(kind, ckpt_path, compute_dtype="float32", **over)
    jstate, jtx, pstate, ptx = _states(jtask, ptask, batch)
    (jloss, jparts), jgrads = _jax_value_and_grad(jtask, mode, jstate.params, batch)
    leaves = {k: v.clone().requires_grad_() for k, v in pstate.params.items()}
    loss, (parts, _, tea_out) = _port_loss(ptask, mode, leaves, batch)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(parts) == set(jparts)
    for k in parts:
        assert abs(float(parts[k].detach()) - float(jparts[k])) <= 1e-5 * abs(float(jparts[k])), k
    assert not tea_out.i2t_logits.requires_grad
    assert not tea_out.visual_output.last_representation.requires_grad
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref = _flat(jgrads)
    assert {torch_name_to_jax_path(k) for k in leaves} == set(ref)
    for name, g in zip(leaves, grads):
        r = ref[torch_name_to_jax_path(name)]
        assert g.shape == r.shape and _rel(g.numpy(), r) <= 1e-4, name

    mask = getattr(jtask, "_mask", None)
    for _ in range(3):
        _, g = _jax_value_and_grad(jtask, mode, jstate.params, batch)
        jstate = jstate.apply_gradients(g, jtx, mask)
    step = ptask.make_train_step(ptx, **MODES[mode][1])
    losses = []
    for _ in range(3):
        pstate, metrics = step(pstate, *_port_batch(mode, batch))
        losses.append(float(metrics["loss"]))
    ref, first = _flat(jstate.params), _flat(jgrads)
    _assert_adam_steps_close(pstate.params, ref, first)
    assert pstate.step == 3 and losses[2] < losses[1] == losses[0]   # the first lr is 0
    assert all(not v.requires_grad for v in pstate.params.values())
    return jtask, ptask, pstate


@pytest.mark.parametrize("kind,mode", [
    ("share", "cached_text"), ("share", "live"), ("plain_attention", "cached_all"),
    ("plain_attention", "cached_text"), ("encoder", "cached_all"), ("encoder", "live")])
def test_step_matches_jax_fp32(kind, mode, ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    _assert_step_parity(kind, mode, ckpt_path, batch)


def test_norm_option_matches_jax_on_the_live_step(ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask, ptask = _tasks("share", ckpt_path, compute_dtype="float32", norm=True)
    jstate, _, pstate, _ = _states(jtask, ptask, batch)
    (jloss, _), _ = _jax_value_and_grad(jtask, "live", jstate.params, batch)
    loss, (_, stu_out, tea_out) = _port_loss(ptask, "live", pstate.params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for out in (stu_out, tea_out):
        np.testing.assert_allclose(
            out.visual_output.last_representation.detach().norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_text_cached_loss_matches_jax_bf16_compute(ckpt_path, batch):
    """bf16 compute on fp32 masters, the JAX students and image teacher through
    their Pallas kernels in interpret mode: the loss within 2e-2 absolute."""
    jtask, ptask = _tasks("share", ckpt_path)
    jstate, _, pstate, _ = _states(jtask, ptask, batch)
    (jloss, jparts), _ = _jax_value_and_grad(jtask, "cached_text", jstate.params, batch)
    ops.reset_launch_counts()
    loss, (parts, stu_out, tea_out) = _port_loss(ptask, "cached_text", pstate.params, batch)
    assert tea_out.visual_output.last_representation.dtype == torch.bfloat16
    assert loss.dtype == torch.float32 and abs(float(loss) - float(jloss)) <= 2e-2
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) <= 2e-2, k
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)   # CPU: plain versions


def test_teacher_encode_functions_match_jax(ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    from distillclip_tpu.parallel.mesh import create_mesh, set_active_mesh
    jtask, ptask = _tasks("share", ckpt_path, compute_dtype="float32")
    mesh = create_mesh(n_data=1, devices=jax.devices()[:1])
    try:
        ref_img = np.asarray(jtask.make_teacher_image_encode(mesh)(jnp.asarray(batch["images"])))
        ref_txt = np.asarray(jtask.make_teacher_text_encode(mesh)(jnp.asarray(batch["tokens"])))
    finally:
        set_active_mesh(None)
    img = ptask.make_teacher_image_encode("cpu")(batch["images"])
    txt = ptask.make_teacher_text_encode("cpu")(batch["tokens"])
    assert img.dtype == txt.dtype == torch.float32 and img.shape == txt.shape == (B, OUT)
    assert _rel(img.numpy(), ref_img) <= 1e-4 and _rel(txt.numpy(), ref_txt) <= 1e-4
    # uint8 images are normalised on the way in, as in the steps
    u8 = np.random.default_rng(1).integers(0, 256, size=(2, RES, RES, 3), dtype=np.uint8)
    assert torch.isfinite(ptask.make_teacher_image_encode("cpu")(u8)).all()


def test_text_cached_step_equals_the_live_step_on_the_teacher_s_own_text(ckpt_path, batch):
    """Feeding the cached-text step the text teacher's own output reproduces
    the live step's loss."""
    _, ptask = _tasks("share", ckpt_path, compute_dtype="float32")
    state, _ = ptask.init_state(0, 1, device="cpu")
    tea_text = ptask.make_teacher_text_encode("cpu")(batch["tokens"])
    toks, imgs = torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["images"])
    live, _ = ptask.loss_fn(state.params, toks, imgs)
    cached, _ = ptask.loss_fn_cached_text(state.params, toks, imgs, tea_text)
    assert abs(float(live) - float(cached)) <= 1e-6


# -- freeze_embed ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["embed", "encoder"])
def test_freeze_embed_copies_the_teachers_embeddings_and_freezes_them(kind, ckpt_path, batch,
                                                                      monkeypatch):
    """The same leaves are frozen as in JAX, they hold the teacher's
    embeddings, three steps leave them bit-identical, and the weight-share
    student's patch bias stays trainable."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    over = {}
    if kind == "encoder":       # an encoder student of the teacher's width and geometry
        STUDENTS["encoder64"] = (dict(image=dict(ENCODER["image"], width=64, heads=1),
                                      text=ENCODER["text"]), *STUDENTS["encoder"][1:])
        kind = "encoder64"
    jtask, ptask, pstate = _assert_step_parity(kind, "cached_text", ckpt_path, batch,
                                               freeze_embed=True, **over)
    frozen = sorted(k for k, m in ptask._mask.items() if not m)
    assert len(frozen) == 3
    assert {torch_name_to_jax_path(k): m for k, m in ptask._mask.items()} == _flat(jtask._mask)
    assert [torch_name_to_jax_path(k) for k in frozen] == sorted(jtask._frozen_paths())
    tea = ptask.teacher.state("image_tower.visual")
    own = ptask.init_params(0, "cpu")           # the port's own copy at init
    for name in frozen:
        leaf = {"cls_token": "class_embedding", "pos_embed": "positional_embedding"}.get(
            name.rsplit(".", 1)[-1], name.rsplit(".", 1)[-1])
        assert torch.equal(pstate.params[name].reshape(tea[leaf].shape), tea[leaf]), name
        assert torch.equal(own[name].reshape(tea[leaf].shape), tea[leaf]), name
        assert own[name].data_ptr() != tea[leaf].data_ptr()
    if kind == "embed":
        assert ptask._mask["student.image_tower.patch_bias"] is True
    # explicitly unfrozen, the embeddings move
    _, ptx = ptask.init_state(0, 1, params=pstate.params, device="cpu")
    step = ptask.make_train_step(ptx, cached_text_teacher=True, trainable_mask=False)
    state2, _ = ptask.init_state(0, 1, params=pstate.params, device="cpu")
    for _ in range(2):
        state2, _ = step(state2, *_port_batch("cached_text", batch))
    assert not torch.equal(state2.params[frozen[0]], pstate.params[frozen[0]])


def test_the_teacher_is_built_at_first_use_only(batch, tmp_path):
    """A task whose checkpoint does not exist constructs, initialises and runs
    the all-cached step; what needs the teacher fails on the missing file."""
    args = STUDENTS["share"][0]
    task = DualDistillTask(image_student=RepeatVisionTransformer(**args["image"]),
                           text_student=RepeatTextTransformer(**args["text"]),
                           loss_control_para=LOSSES, teacher_name=str(tmp_path / "missing.pt"),
                           compute_dtype="float32", **TASK_ARGS)
    state, tx = task.init_state(0, 1, device="cpu")
    step = task.make_train_step(tx, cached_teachers=True)
    state, metrics = step(state, *_port_batch("cached_all", batch))
    assert np.isfinite(float(metrics["loss"]))
    live = task.make_train_step(tx)
    with pytest.raises(RuntimeError, match="not found"):
        live(state, *_port_batch("live", batch))
    with pytest.raises(RuntimeError, match="not found"):
        task.make_teacher_text_encode("cpu")


def test_tap_configurations_cannot_take_a_cached_step(ckpt_path):
    from distillclip_tpu_torch.models import ControlFlags
    _, ptask = _tasks("share", ckpt_path)
    _, tx = ptask.init_state(0, 1, device="cpu")
    ptask.flags = ControlFlags(need_rep=True)
    with pytest.raises(ValueError, match="cached_text_teacher requires"):
        ptask.make_train_step(tx, cached_text_teacher=True)
    with pytest.raises(ValueError, match="cached_teachers requires"):
        ptask.make_train_step(tx, cached_teachers=True)
