"""The port's live train steps with tap losses, and its dropout, on the CPU.

``DistillTask`` and ``DualDistillTask`` with per-layer, contrastive and
``vit_kd`` losses against the JAX package: both load one fabricated two-head
CLIP checkpoint as their teacher, the JAX task initialises the tiny students
(and ``loss_aux``), and its tree crosses through ``convert``.  fp32 with the
JAX towers on their XLA path (DISTILLCLIP_FLASH=0): loss and parts within
1e-5 relative, every leaf's gradient within 1e-4 of its largest entry, three
optimizer steps within 1e-5 (with the stated exception for elements whose
gradient is float noise, ``test_torch_training._assert_adam_steps_close``).
``vit_kd``'s token mask is numpy-seeded and patched into both packages.

Dropout and drop-path have no JAX counterpart bit for bit (other generators),
so they are held to their definitions: rate 0 equals eval, a seeded run
repeats, the keep rate is the configured one, drop-path zeroes whole samples.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.losses import vit_kd as jax_vit_kd
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models.encoders import TextEncoder as JaxTextEncoder
from distillclip_tpu.training.distill import DistillTask as JaxDistillTask
from distillclip_tpu.training.dual import DualDistillTask as JaxDualTask
from distillclip_tpu_torch.convert import (
    jax_distill_params_to_torch,
    jax_dual_params_to_torch,
    torch_name_to_jax_path,
)
from distillclip_tpu_torch.losses import vit_kd as port_vit_kd
from distillclip_tpu_torch.models import (
    ControlFlags,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
)
from distillclip_tpu_torch.models.encoders import projections_for
from distillclip_tpu_torch.models.layers import drop_path, dropout
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
from distillclip_tpu_torch.training import DistillTask, DualDistillTask

from test_torch_training import TASK_ARGS, _assert_adam_steps_close, _flat, _np_tree, _rel

B, RES, PATCH, CTX, VOCAB, OUT, WIDTH = 6, 32, 8, 12, 100, 48, 128
# a two-head teacher (width 128 under the width // 64 rule), 3 and 2 layers
TEACHER = dict(vision_width=WIDTH, vision_layers=3, patch_size=PATCH, image_resolution=RES,
               text_width=WIDTH, text_layers=2, context_length=CTX, vocab_size=VOCAB,
               embed_dim=OUT)
IMAGE = dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=WIDTH, depth=2,
             num_heads=4, repeated_times=2, qkv_bias=True, use_transform=True)
TEXT = dict(vocab_size=VOCAB, context_length=CTX, out_dim=OUT, embed_dim=WIDTH, depth=2,
            num_heads=2, repeated_times=2, use_transform=True)
VIT_KD = dict(student_dims=WIDTH, teacher_dims=WIDTH, low_layers_num=1, high_layers_num=1)
# name -> (model type, JAX student, port student, their arguments, teacher_need_layers,
#          loss_control_para)
ONE_TOWER = {
    "rep_emb_vit_kd": (
        "image", JaxVision, RepeatVisionTransformer, IMAGE, [0, 2],
        {"loss_name": ["out_l1", "out_cos", "hidden_rep_mse", "embedding_mse", "vit_kd"],
         "loss_scale": {"vit_kd": 100.0}, "vit_kd_para": VIT_KD}),
    "plain_attention_rep": (
        "image", JaxVision, RepeatVisionTransformer, dict(IMAGE, use_transform=False), [0, 2],
        {"loss_name": ["out_l1", "hidden_rep_mse"]}),
    "attention_taps": (
        "image", JaxVision, RepeatVisionTransformer, dict(IMAGE, num_heads=2), [1, 2],
        {"loss_name": ["out_cos", "attention_score_mse", "attention_probs_mse",
                       "attention_probs_kl", "last_value_map_kl"],
         "loss_scale": {"last_value_map_kl": 0.01}}),
    "text_share_rep": (
        "text", JaxText, RepeatTextTransformer, TEXT, [0, 1],
        {"loss_name": ["out_l1", "hidden_rep_mse", "embedding_mse", "smd", "out_kl"],
         "temperature": 2.0, "loss_scale": {"smd": 0.01}}),
    "text_encoder_projected": (
        "text", JaxTextEncoder, TextEncoder,
        dict(is_student=True, vocab_size=VOCAB, context_length=CTX, width=64, layers=2,
             heads=1, output_dim=OUT, need_layers=(1,), teacher_width=WIDTH), [1],
        {"loss_name": ["out_l1", "hidden_rep_mse", "embedding_mse", "attention_score_mse",
                       "out_ce"]}),
}
DUAL_LOSSES = {
    "loss_name": ["out_l1", "out_cos", "cos_diff", "hard_label", "soft_label", "logits_mse",
                  "fine_grain", "hidden_rep_mse", "vit_kd"],
    "temperature": 0.5, "loss_scale": {"vit_kd": 100.0, "soft_label": 0.1},
    "vit_kd_para": VIT_KD}


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "wide_clip.pt"
    torch.save(make_clip_state_dict(**TEACHER), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return dict(text=toks, image=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                mask=(rng.random((B, (RES // PATCH) ** 2)) < 0.5).astype(np.float32))


@pytest.fixture
def same_mask(batch, monkeypatch):
    """vit_kd's random token mask, the same numpy-seeded one in both packages."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    monkeypatch.setattr(jax_vit_kd, "random_masking",
                        lambda rng, x, ratio: jnp.asarray(batch["mask"][:x.shape[0]], x.dtype))
    monkeypatch.setattr(port_vit_kd, "random_masking",
                        lambda x, ratio, generator=None: torch.from_numpy(batch["mask"][:x.shape[0]]))


def _as_jax_layout(params):
    """The port's leaves with the convolution kernels back in HWIO."""
    return {k: v.detach().permute(2, 3, 1, 0) if k.startswith("loss_aux.")
            and k.endswith(".weight") else v.detach() for k, v in params.items()}


def _assert_parity(jtask, ptask, jstate, jtx, pstate, ptx, jvg, port_batch, loss_name="loss_fn"):
    (jloss, jparts), jgrads = jvg(jstate.params)
    leaves = {k: v.clone().requires_grad_() for k, v in pstate.params.items()}
    loss, (parts, _, tea_out) = getattr(ptask, loss_name)(leaves, *port_batch)
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

    mask = getattr(jtask, "_mask", None)
    for _ in range(3):
        _, g = jvg(jstate.params)
        jstate = jstate.apply_gradients(g, jtx, mask)
    step = ptask.make_train_step(ptx)
    losses = []
    for _ in range(3):
        pstate, metrics = step(pstate, *port_batch)
        losses.append(float(metrics["loss"]))
    _assert_adam_steps_close(_as_jax_layout(pstate.params), _flat(jstate.params), ref)
    assert pstate.step == 3 and losses[2] < losses[1] == losses[0]   # the first lr is 0
    return pstate


@pytest.mark.parametrize("name", list(ONE_TOWER))
def test_distill_task_tap_step_matches_jax(name, ckpt_path, batch, same_mask):
    model_type, jcls, pcls, args, layers, losses = ONE_TOWER[name]
    common = dict(loss_control_para=losses, teacher_name=ckpt_path, model_type=model_type,
                  teacher_need_layers=layers, compute_dtype="float32", **TASK_ARGS)
    jtask = JaxDistillTask(student=jcls(**args), **common)
    extra = projections_for(jtask.flags) if pcls is TextEncoder else {}
    ptask = DistillTask(student=pcls(**args, **extra), **common)
    x = batch[model_type]
    jstate, jtx = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(x[:1]), steps_per_epoch=1)
    pstate, ptx = ptask.init_state(0, 1, device="cpu", params=jax_distill_params_to_torch(
        _np_tree(jstate.params), model_type))
    assert ("loss_aux" in jstate.params) == ptask.loss_control.has_params
    assert any(k.startswith("loss_aux.") for k in pstate.params) == ptask.loss_control.has_params

    def jvg(params):
        def f(p):
            out = jtask.loss_fn(p, jtask.teacher_vars, jnp.asarray(x), jax.random.PRNGKey(0),
                                True)
            return out[0], out[1][0]
        return jax.jit(jax.value_and_grad(f, has_aux=True))(params)

    xp = torch.from_numpy(x)
    pstate = _assert_parity(jtask, ptask, jstate, jtx, pstate, ptx, jvg, [xp])
    if ptask.loss_control.has_params:
        moved = [k for k in pstate.params if k.startswith("loss_aux.")]
        assert moved and ptask._mask is None     # trained and decayed like any other leaf


def test_dual_task_tap_step_matches_jax(ckpt_path, batch, same_mask):
    common = dict(loss_control_para=DUAL_LOSSES, teacher_name=ckpt_path,
                  teacher_need_layers=[0, 1], compute_dtype="float32", **TASK_ARGS)
    jtask = JaxDualTask(image_student=JaxVision(**IMAGE), text_student=JaxText(**TEXT), **common)
    ptask = DualDistillTask(image_student=RepeatVisionTransformer(**IMAGE),
                            text_student=RepeatTextTransformer(**TEXT), **common)
    assert ptask.flags == ControlFlags(need_rep=True, need_last_layer=True)
    toks, imgs = batch["text"], batch["image"]
    jstate, jtx = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(toks[:1]),
                                   jnp.asarray(imgs[:1]), steps_per_epoch=1)
    pstate, ptx = ptask.init_state(0, 1, device="cpu", params=jax_dual_params_to_torch(
        _np_tree(jstate.params)))

    def jvg(params):
        def f(p):
            out = jtask.loss_fn(p, jtask.teacher_vars, jnp.asarray(toks), jnp.asarray(imgs),
                                jax.random.PRNGKey(0), True)
            return out[0], out[1][0]
        return jax.jit(jax.value_and_grad(f, has_aux=True))(params)

    pstate = _assert_parity(jtask, ptask, jstate, jtx, pstate, ptx, jvg,
                            [torch.from_numpy(toks), torch.from_numpy(imgs)])
    assert float(pstate.params["loss_aux.mask_token"].abs().sum()) > 0.0


def test_tap_losses_cannot_take_the_cached_steps(ckpt_path):
    args = dict(image_student=RepeatVisionTransformer(**IMAGE),
                text_student=RepeatTextTransformer(**TEXT), teacher_name=ckpt_path)
    dual = DualDistillTask(loss_control_para={"loss_name": ["out_l1", "hidden_rep_mse"]}, **args)
    _, tx = dual.init_state(0, 1, device="cpu")
    with pytest.raises(ValueError, match="cached_text_teacher requires"):
        dual.make_train_step(tx, cached_text_teacher=True)
    one = DistillTask(student=RepeatVisionTransformer(**IMAGE), teacher_name=ckpt_path,
                      loss_control_para={"loss_name": ["attention_probs_kl"]})
    _, tx = one.init_state(0, 1, device="cpu")
    with pytest.raises(ValueError, match="cached_teacher requires"):
        one.make_train_step(tx, cached_teacher=True)
    # fine_grain reads no teacher tap, so it may
    fine = DualDistillTask(loss_control_para={"loss_name": ["out_l1", "fine_grain"]}, **args)
    _, tx = fine.init_state(0, 1, device="cpu")
    assert callable(fine.make_train_step(tx, cached_teachers=True))


def test_an_encoder_student_needs_the_projections_its_flags_call_for(ckpt_path):
    args = dict(is_student=True, vocab_size=VOCAB, context_length=CTX, width=64, layers=2,
                heads=1, output_dim=OUT, teacher_width=WIDTH)
    kw = dict(loss_control_para={"loss_name": ["hidden_rep_mse"]}, model_type="text",
              teacher_name=ckpt_path)
    with pytest.raises(ValueError, match="projections_for"):
        DistillTask(student=TextEncoder(**args), **kw)
    with pytest.raises(ValueError, match="projections_for"):
        DistillTask(student=TextEncoder(**args, project_hidden=True, project_embedding=True),
                    **kw)
    task = DistillTask(student=TextEncoder(**args, project_hidden=True), **kw)
    assert "student.hidden_projection.kernel" in task.init_params(0, "cpu")


# -- dropout and drop-path ------------------------------------------------------------

DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)


def _drop_task(ckpt_path, flags_losses=("out_l1", "out_cos"), **rates):
    return DistillTask(student=RepeatVisionTransformer(**dict(IMAGE, **rates)),
                       loss_control_para={"loss_name": list(flags_losses)},
                       teacher_name=ckpt_path, teacher_need_layers=[0, 2],
                       compute_dtype="float32", **TASK_ARGS)


def test_zero_rates_make_the_stochastic_step_equal_the_deterministic_one(ckpt_path, batch):
    task = _drop_task(ckpt_path)
    state, _ = task.init_state(0, 1, device="cpu")
    x = torch.from_numpy(batch["image"])
    det, _ = task.loss_fn(state.params, x, deterministic=True)
    sto, _ = task.loss_fn(state.params, x, deterministic=False,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(det, sto)
    # and non-zero rates do nothing to a deterministic step
    drop = _drop_task(ckpt_path, **DROP)
    det2, _ = drop.loss_fn(state.params, x, deterministic=True)
    assert torch.equal(det, det2)


@pytest.mark.parametrize("losses", [("out_l1", "out_cos"), ("out_l1", "hidden_rep_mse"),
                                    ("out_l1", "attention_probs_mse")],
                         ids=["no_tap", "need_rep", "attention_tap"])
def test_seeded_stochastic_steps_repeat_and_other_seeds_differ(losses, ckpt_path, batch):
    x = torch.from_numpy(batch["image"])

    def run(seed):
        task = _drop_task(ckpt_path, losses, **DROP)
        state, tx = task.init_state(0, 1, device="cpu")
        step = task.make_train_step(tx, deterministic=False, seed=seed)
        out = []
        for _ in range(3):
            state, metrics = step(state, x)
            out.append(float(metrics["loss"]))
        return out, state

    a, sa = run(3)
    b, sb = run(3)
    c, _ = run(4)
    assert a == b and a != c and all(np.isfinite(a))
    assert all(torch.equal(sa.params[k], sb.params[k]) for k in sa.params)
    assert a[0] != a[1]       # the generator is advanced from step to step (the lr is still 0)


def test_every_dropout_site_acts_in_training_mode_only(batch):
    x = torch.from_numpy(batch["image"])
    toks = torch.from_numpy(batch["text"]).long()
    for cls, args, inp in ((RepeatVisionTransformer, IMAGE, x), (RepeatTextTransformer, TEXT,
                                                                 toks)):
        base = seeded_init(cls(**args), np.random.default_rng(0))
        with torch.no_grad():
            ref = base.eval()(inp)
            for rate in ("drop_rate", "attn_drop_rate", "drop_path_rate"):
                tower = cls(**dict(args, **{rate: 0.5}))
                tower.load_state_dict(base.state_dict())
                assert torch.equal(tower.eval()(inp), ref), rate
                gen = torch.Generator().manual_seed(0)
                out = tower.train()(inp, ControlFlags(), gen)
                again = tower(inp, ControlFlags(), torch.Generator().manual_seed(0))
                assert not torch.equal(out, ref) and torch.equal(out, again), rate


def test_attention_dropout_acts_after_the_probability_tap(batch):
    from distillclip_tpu_torch.models.layers import InstrumentedAttention, LayerNorm
    attn = seeded_init(InstrumentedAttention(32, 2, drop_prob=0.5), np.random.default_rng(0))
    ln = LayerNorm(32)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2 * 6, 32)).astype(np.float32))
    flags = ControlFlags(need_attn_prob=True)
    with torch.no_grad():
        ref = attn.eval()(x, flags, ln, 6)
        out = attn.train()(x, flags, ln, 6, generator=torch.Generator().manual_seed(0))
        lean = attn(x, ControlFlags(), ln, 6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out.attention_probs, ref.attention_probs)       # tapped before dropout
    assert not torch.equal(out.hidden, ref.hidden) and torch.equal(out.hidden, lean.hidden)
    np.testing.assert_allclose(out.attention_probs.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_at_the_configured_rate_and_rescales(rate):
    gen = torch.Generator().manual_seed(0)
    out = dropout(torch.ones(400, 500), rate, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5e-3
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))
    assert abs(float(out.mean()) - 1.0) < 1e-2


def test_drop_path_zeroes_whole_samples_and_rescales_the_rest():
    gen = torch.Generator().manual_seed(0)
    rows = torch.ones(2000 * 5, 3)                    # 2000 samples of 5 rows
    out = drop_path(rows, 0.3, 2000, gen).view(2000, 5, 3)
    per_sample = out.flatten(1)
    dropped = (per_sample == 0).all(dim=1)
    kept = (per_sample == 1 / 0.7).all(dim=1)
    assert bool((dropped | kept).all())               # never part of a sample
    assert abs(float(dropped.float().mean()) - 0.3) < 0.03
