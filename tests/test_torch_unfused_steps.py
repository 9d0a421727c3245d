"""The perf knobs that change the port's function path (``fc1_ln: "0"``,
``fc1_res: u``, ``tf_impl: factored``) against the JAX package under the same
``DISTILLCLIP_*`` variables, on the CPU.

The knobs are set before either package builds anything (the port reads them
when a tower or task is built, the JAX package at trace time).

* towers: the students and the CLIP encoders under ``fc1_ln: "0"`` against
  the JAX towers on their kernel path (``DISTILLCLIP_FLASH=1``, Pallas in
  interpret mode) with ``DISTILLCLIP_FC1_LN=0``, fp32, outputs within 1e-4 of
  the largest entry;
* the stage-3 text-cached step, fp32: loss and parts within 1e-5 relative,
  every leaf's gradient within 1e-4 of its largest entry, and three optimizer
  steps within 1e-5 (with the Adam float-noise allowance of
  ``test_torch_training._assert_adam_steps_close``, ROADMAP queue 3), against
  the JAX XLA math (``DISTILLCLIP_FLASH=0``).  That is the unfused function
  the knobs select (separate LayerNorms, plain qkv, fc1 + GELU, h and e from
  u); the JAX attention kernels round to bf16 inside even for fp32 inputs, so
  they cannot be held to these limits;

The bf16 step against the JAX kernels under the knobs is in
``test_torch_knob_steps_bf16.py``; ``tf_impl: factored`` in
``test_torch_factored.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models.teacher import load_image_teacher, load_text_teacher
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.convert import jax_student_to_torch, jax_teacher_params_to_torch
from distillclip_tpu_torch.models import (
    RepeatTextTransformer,
    RepeatVisionTransformer,
    teacher_load,
)

from test_teacher import CTX, RES, VOCAB, _make_state_dict
from test_torch_teacher_steps import B, SHARE, _assert_step_parity, _tasks
from test_torch_training import _np_tree, _rel


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
                tea_text=rng.normal(size=(B, 48)).astype(np.float32),
                tea_image=rng.normal(size=(B, 48)).astype(np.float32))


def _knobs(monkeypatch, flash="1", **env):
    monkeypatch.setenv("DISTILLCLIP_FLASH", flash)
    for k in ("FC1_LN", "FC1_RES", "TF_IMPL"):
        monkeypatch.delenv(f"DISTILLCLIP_{k}", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(f"DISTILLCLIP_{k.upper()}", v)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_unfused_students_match_jax(monkeypatch, tower, batch):
    """A weight-share student under fc1_ln: "0" (K4 norms, plain qkv, the
    no-LN fc1) against the JAX student under DISTILLCLIP_FC1_LN=0."""
    _knobs(monkeypatch, fc1_ln="0")
    jcls, pcls = {"image": (JaxVision, RepeatVisionTransformer),
                  "text": (JaxText, RepeatTextTransformer)}[tower]
    x = batch["images"] if tower == "image" else batch["tokens"]
    jmod = jcls(**SHARE[tower])
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]), JaxFlags())["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x), JaxFlags()).last_representation
    port = pcls(**SHARE[tower])
    assert not port.blocks[0].mlp.perf.ln_fusion
    port.load_state_dict(jax_student_to_torch(_np_tree(params), tower), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-4


@pytest.mark.parametrize("tower", ["image", "text"])
def test_unfused_clip_towers_match_jax(monkeypatch, tower, ckpt_path, batch):
    """The CLIP teacher towers under fc1_ln: "0" (K4 ln_1/ln_2, plain in_proj,
    plain c_fc and QuickGELU) against the JAX towers."""
    _knobs(monkeypatch, fc1_ln="0")
    load = {"image": load_image_teacher, "text": load_text_teacher}[tower]
    jmod, jvars = load(ckpt_path)
    x = batch["images"] if tower == "image" else batch["tokens"]
    ref = jmod.apply(jvars, jnp.asarray(x), JaxFlags()).last_representation
    port = teacher_load(ckpt_path, model_type=tower, device="cpu")
    assert not any(m.perf.ln_fusion for m in port.modules() if hasattr(m, "perf"))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).last_representation
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-4
    # the same weights through the JAX converter's names
    assert set(jax_teacher_params_to_torch(jvars)) == set(
        k for k in port.state_dict())


@pytest.mark.parametrize("knobs", [{"fc1_ln": "0"}, {"fc1_ln": "0", "fc1_res": "u"},
                                   {"fc1_res": "u"}],
                         ids=["fc1_ln=0", "fc1_ln=0,fc1_res=u", "fc1_res=u"])
def test_text_cached_step_under_knobs_matches_jax(monkeypatch, knobs, ckpt_path, batch):
    """Loss, gradients and three AdamW steps of the stage-3 text-cached step:
    the students train through the no-LN fc1 (#10 / #11) and K4 / #7, or the
    LN-fused fc1 in its u mode, and the image teacher runs unfused."""
    _knobs(monkeypatch, flash="0", **knobs)
    _, ptask, _ = _assert_step_parity("share", "cached_text", ckpt_path, batch)
    ln = knobs.get("fc1_ln", "1") != "0"
    res = knobs.get("fc1_res", "ue")
    blocks = [m for m in ptask.student.modules() if hasattr(m, "perf")]
    assert blocks and all(m.perf.ln_fusion == ln and m.perf.fc1_res == res for m in blocks)
    teacher = [m for m in ptask.teacher.module.modules() if hasattr(m, "perf")]
    assert teacher and all(m.perf.ln_fusion == ln for m in teacher)


def test_knobs_change_no_launch_on_the_cpu(monkeypatch, ckpt_path, batch):
    """On the CPU every wrapper runs its plain version under any knob."""
    _knobs(monkeypatch, fc1_ln="0", fc1_res="u")
    _, ptask = _tasks("share", ckpt_path, compute_dtype="float32")
    state, tx = ptask.init_state(0, 1, device="cpu")
    ops.reset_launch_counts()
    step = ptask.make_train_step(tx, cached_text_teacher=True)
    _, metrics = step(state, *[torch.from_numpy(batch[k])
                               for k in ("tokens", "images", "tea_text")])
    assert np.isfinite(float(metrics["loss"]))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
