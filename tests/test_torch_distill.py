"""Parity of the PyTorch port's one-tower distillation task (stage 1: image,
stage 2: text) with the JAX package, on the CPU.

Both packages load one fabricated CLIP checkpoint as their teacher; the JAX
``DistillTask`` initialises the tiny student and its tree crosses to the port
through ``convert.jax_distill_params_to_torch``.  fp32 with the JAX towers on
their XLA path (DISTILLCLIP_FLASH=0): loss and parts within 1e-5 relative,
gradients within 1e-4 of the leaf's largest entry, three optimizer steps within
1e-5 absolute.  Where the first gradient is below 1e-6 in magnitude (the key
bias of a plain attention layer has a zero gradient in the math) Adam's update
lr·g / (|g| + 1e-8) follows float32 summation noise; those elements are held to
2e-4, and the key third of a fused qkv bias among them to the size of the two
moving updates, 2e-3 (``_assert_adam_steps_close``).
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
from distillclip_tpu.training.distill import DistillTask as JaxTask
from distillclip_tpu_torch.convert import jax_distill_params_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.models import (
    ControlFlags,
    ImageEncoder,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
    TextOutput,
    VisionOutput,
)
from distillclip_tpu_torch.training import DistillTask

from test_teacher import CTX, PATCH, RES, VOCAB, _make_state_dict
from test_torch_training import _assert_adam_steps_close, _flat, _np_tree, _rel

B, OUT = 8, 48
LOSSES = {"loss_name": ["out_l1", "out_cos"]}
TASK_ARGS = dict(lr=1e-3, warm_steps=1, total_steps=10, weight_decay=1e-3)
# (JAX class, port class, arguments) by student kind and modality
STUDENTS = {
    ("share", "image"): (JaxVision, RepeatVisionTransformer, dict(
        img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=64, depth=2, num_heads=4,
        repeated_times=2, qkv_bias=True, use_transform=True)),
    ("share", "text"): (JaxText, RepeatTextTransformer, dict(
        vocab_size=VOCAB, context_length=CTX, out_dim=OUT, embed_dim=32, depth=2, num_heads=4,
        repeated_times=2, use_transform=True)),
    ("encoder", "image"): (JaxImageEncoder, ImageEncoder, dict(
        is_student=True, input_resolution=RES, patch_size=PATCH, width=64, layers=2, heads=1,
        output_dim=OUT)),
    ("encoder", "text"): (JaxTextEncoder, TextEncoder, dict(
        is_student=True, vocab_size=VOCAB, context_length=CTX, width=64, layers=1, heads=1,
        output_dim=OUT)),
}


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
    return dict(text=toks, image=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                tea_rep=rng.normal(size=(B, OUT)).astype(np.float32))


def _tasks(kind, model_type, ckpt_path, **over):
    jcls, pcls, args = STUDENTS[(kind, model_type)]
    if (kind, model_type) == ("encoder", "image"):
        # a 2-layer encoder student against layers 0 and 2 of the 3-layer teacher
        over.setdefault("teacher_need_layers", [0, 2])
    common = dict(loss_control_para=LOSSES, teacher_name=ckpt_path, model_type=model_type,
                  **{**TASK_ARGS, **over})
    return JaxTask(student=jcls(**args), **common), DistillTask(student=pcls(**args), **common)


def _states(jtask, ptask, batch):
    x = batch[jtask.model_type]
    jstate, jtx = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(x[:1]), steps_per_epoch=1)
    pstate, ptx = ptask.init_state(0, 1, params=jax_distill_params_to_torch(
        _np_tree(jstate.params), jtask.model_type), device="cpu")
    return jstate, jtx, pstate, ptx


def _jax_value_and_grad(task, cached, params, batch):
    x, rep = jnp.asarray(batch[task.model_type]), jnp.asarray(batch["tea_rep"])
    rng = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = (task.loss_fn_cached(p, rep, x, rng, True) if cached
               else task.loss_fn(p, task.teacher_vars, x, rng, True))
        return out[0], out[1][0]
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _port_batch(task, cached, batch):
    x = torch.from_numpy(batch[task.model_type])
    return [torch.from_numpy(batch["tea_rep"]), x] if cached else [x]


def _assert_step_parity(kind, model_type, cached, ckpt_path, batch, **over):
    jtask, ptask = _tasks(kind, model_type, ckpt_path, compute_dtype="float32", **over)
    jstate, jtx, pstate, ptx = _states(jtask, ptask, batch)
    (jloss, jparts), jgrads = _jax_value_and_grad(jtask, cached, jstate.params, batch)
    leaves = {k: v.clone().requires_grad_() for k, v in pstate.params.items()}
    fn = ptask.loss_fn_cached if cached else ptask.loss_fn
    loss, (parts, stu_out, tea_out) = fn(leaves, *_port_batch(ptask, cached, batch))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(parts) == set(jparts) == {"out_l1", "out_cos"}
    for k in parts:
        assert abs(float(parts[k].detach()) - float(jparts[k])) <= 1e-5 * abs(float(jparts[k])), k
    cls = VisionOutput if model_type == "image" else TextOutput
    assert isinstance(stu_out, cls) and isinstance(tea_out, cls)
    assert not tea_out.last_representation.requires_grad
    grads = torch.autograd.grad(loss, list(leaves.values()))
    first = _flat(jgrads)
    assert {torch_name_to_jax_path(k) for k in leaves} == set(first)
    for name, g in zip(leaves, grads):
        r = first[torch_name_to_jax_path(name)]
        assert g.shape == r.shape and _rel(g.numpy(), r) <= 1e-4, name

    mask = getattr(jtask, "_mask", None)
    for _ in range(3):
        _, g = _jax_value_and_grad(jtask, cached, jstate.params, batch)
        jstate = jstate.apply_gradients(g, jtx, mask)
    step = ptask.make_train_step(ptx, cached_teacher=cached)
    losses = []
    for _ in range(3):
        pstate, metrics = step(pstate, *_port_batch(ptask, cached, batch))
        losses.append(float(metrics["loss"]))
    _assert_adam_steps_close(pstate.params, _flat(jstate.params), first)
    assert pstate.step == 3 and losses[2] < losses[1] == losses[0]   # the first lr is 0
    assert set(metrics) == {"loss", "out_l1", "out_cos"}
    return jtask, ptask, pstate


@pytest.mark.parametrize("kind,model_type,cached", [
    ("share", "image", False), ("share", "image", True), ("share", "text", False),
    ("share", "text", True), ("encoder", "image", False), ("encoder", "text", True)])
def test_step_matches_jax_fp32(kind, model_type, cached, ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    _assert_step_parity(kind, model_type, cached, ckpt_path, batch)


@pytest.mark.parametrize("model_type", ["image", "text"])
def test_teacher_encode_and_norm_match_jax(model_type, ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    from distillclip_tpu.parallel.mesh import create_mesh, set_active_mesh
    jtask, ptask = _tasks("share", model_type, ckpt_path, compute_dtype="float32", norm=True)
    mesh = create_mesh(n_data=1, devices=jax.devices()[:1])
    try:
        ref = np.asarray(jtask.make_teacher_encode(mesh)(jnp.asarray(batch[model_type])))
    finally:
        set_active_mesh(None)
    rep = ptask.make_teacher_encode("cpu")(batch[model_type])
    assert rep.dtype == torch.float32 and rep.shape == (B, OUT)
    assert _rel(rep.numpy(), ref) <= 1e-4
    # norm=True: both sides' representations are unit rows in the loss
    jstate, _, pstate, _ = _states(jtask, ptask, batch)
    (jloss, _), _ = _jax_value_and_grad(jtask, False, jstate.params, batch)
    loss, (_, stu_out, tea_out) = ptask.loss_fn(pstate.params, *_port_batch(ptask, False, batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for out in (stu_out, tea_out):
        np.testing.assert_allclose(out.last_representation.detach().norm(dim=-1).numpy(), 1.0,
                                   atol=1e-5)
    # the cached step fed the teacher's own encode equals the live step
    plain = _tasks("share", model_type, ckpt_path, compute_dtype="float32")[1]
    x = torch.from_numpy(batch[model_type])
    live, _ = plain.loss_fn(pstate.params, x)
    cached, _ = plain.loss_fn_cached(pstate.params, plain.make_teacher_encode("cpu")(x), x)
    assert abs(float(live) - float(cached)) <= 1e-6


@pytest.mark.parametrize("kind", ["share", "encoder"])
def test_freeze_embed_matches_jax(kind, ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask, ptask, pstate = _assert_step_parity(kind, "image", False, ckpt_path, batch,
                                               freeze_embed=True)
    frozen = sorted(k for k, m in ptask._mask.items() if not m)
    assert [torch_name_to_jax_path(k) for k in frozen] == sorted(jtask._frozen_paths())
    assert {torch_name_to_jax_path(k): m for k, m in ptask._mask.items()} == _flat(jtask._mask)
    tea = ptask.teacher.state("visual")
    own = ptask.init_params(0, "cpu")
    for name in frozen:
        leaf = name.rsplit(".", 1)[-1]
        leaf = {"cls_token": "class_embedding", "pos_embed": "positional_embedding"}.get(leaf, leaf)
        assert torch.equal(pstate.params[name].reshape(tea[leaf].shape), tea[leaf]), name
        assert torch.equal(own[name].reshape(tea[leaf].shape), tea[leaf]), name
    if kind == "share":
        assert ptask._mask["student.patch_bias"] is True
    # a text task freezes nothing, whatever the flag says
    ttask = _tasks("share", "text", ckpt_path, freeze_embed=True)[1]
    tstate, _ = ttask.init_state(0, 1, device="cpu")
    assert ttask._mask is None and ttask._frozen_paths() == []
    # mismatched patch geometry is refused with the reason
    _, pcls, args = STUDENTS[("share", "image")]
    bad = DistillTask(student=pcls(**dict(args, embed_dim=32)), loss_control_para=LOSSES,
                      teacher_name=ckpt_path, freeze_embed=True)
    with pytest.raises(ValueError, match="matching patch geometry"):
        bad.init_params(0, "cpu")


@pytest.mark.parametrize("init_type", ["begin", "end", "mid"])
@pytest.mark.parametrize("model_type", ["image", "text"])
def test_teacher_warm_start_matches_jax(init_type, model_type, ckpt_path, batch):
    """init_params with teacher_init_type: the student's blocks are the
    teacher's by the same mapping as in JAX, and the leaves are fresh."""
    jtask, ptask = _tasks("encoder", model_type, ckpt_path, teacher_init_type=init_type)
    jparams = jtask.init_params(jax.random.PRNGKey(0), jnp.asarray(batch[model_type][:1]))
    params = ptask.init_params(0, "cpu")
    ref = _flat(jparams)
    assert {torch_name_to_jax_path(k) for k in params} == set(ref)
    scope = "visual" if model_type == "image" else "text"
    tea = ptask.teacher.state(scope)
    taken = 0
    for name, v in params.items():
        path = torch_name_to_jax_path(name)
        leaf = name[len(f"student.{scope}."):]
        if "resblocks" in name or (leaf in tea and tea[leaf].shape == v.shape):
            np.testing.assert_array_equal(v.numpy(), ref[path], err_msg=name)   # the teacher's
            taken += 1
        assert v.dtype == torch.float32 and v.shape == ref[path].shape
    assert taken == len(params)      # same width and output: every leaf comes from the teacher
    share = _tasks("share", model_type, ckpt_path, teacher_init_type=init_type)[1]
    with pytest.raises(ValueError, match="plain CLIP-architecture student"):
        share.init_params(0, "cpu")


def test_what_the_task_refuses(ckpt_path, batch, tmp_path):
    _, pcls, args = STUDENTS[("share", "image")]
    with pytest.raises(ValueError, match="model_type"):
        DistillTask(student=pcls(**args), loss_control_para=LOSSES, model_type="all")
    tapped = DistillTask(student=pcls(**args), loss_control_para={"loss_name": ["hidden_rep_mse"]})
    assert tapped.flags == ControlFlags(need_rep=True)        # a per-layer loss builds
    task = DistillTask(student=pcls(**args), loss_control_para=LOSSES,
                       teacher_name=str(tmp_path / "missing.pt"), compute_dtype="float32")
    state, tx = task.init_state(0, 1, device="cpu")         # no teacher needed yet
    step = task.make_train_step(tx, cached_teacher=True)
    state, metrics = step(state, torch.from_numpy(batch["tea_rep"]),
                          torch.from_numpy(batch["image"]))
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(RuntimeError, match="not found"):
        task.make_train_step(tx)(state, torch.from_numpy(batch["image"]))
    # not deterministic with zero rates: the same step
    sto, _ = task.loss_fn_cached(state.params, torch.from_numpy(batch["tea_rep"]),
                                 torch.from_numpy(batch["image"]), deterministic=False,
                                 generator=torch.Generator().manual_seed(0))
    det, _ = task.loss_fn_cached(state.params, torch.from_numpy(batch["tea_rep"]),
                                 torch.from_numpy(batch["image"]))
    assert torch.equal(sto, det)
    task.flags = ControlFlags(need_rep=True)
    with pytest.raises(ValueError, match="cached_teacher requires"):
        task.make_train_step(tx, cached_teacher=True)
    with pytest.raises(ValueError, match="do not match the student"):
        task.init_state(0, 1, params={"student.head.kernel": np.zeros((64, OUT))}, device="cpu")
    # student/teacher selected-layer alignment, checked when the teacher is needed
    enc = DistillTask(student=ImageEncoder(**dict(STUDENTS[("encoder", "image")][2],
                                                  need_layers=[0])),
                      loss_control_para=LOSSES, teacher_name=ckpt_path)
    _, etx = enc.init_state(0, 1, device="cpu")
    with pytest.raises(ValueError, match="need_layers"):
        enc.make_train_step(etx)
