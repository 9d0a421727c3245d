"""Parity of the PyTorch port's stage-3 train step (both teachers cached) with
the JAX package, on the CPU at a small size.

The JAX ``DualDistillTask`` initialises the two tiny students; its parameter
tree crosses to the port through ``convert.jax_dual_params_to_torch``; both
sides then see the same seeded tokens, images and teacher representations.
fp32 comparisons run the JAX towers on their XLA path (DISTILLCLIP_FLASH=0);
the bf16 comparison runs them through the Pallas kernels in interpret mode.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.losses import LossCalculator as JaxCalculator
from distillclip_tpu.losses import functional as jax_F
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models.outputs import CLIPOutput as JaxCLIPOutput
from distillclip_tpu.models.outputs import TextOutput as JaxTextOutput
from distillclip_tpu.models.outputs import VisionOutput as JaxVisionOutput
from distillclip_tpu.training import schedules as jax_schedules
from distillclip_tpu.training import train_state as jax_train_state
from distillclip_tpu.training.dual import DualDistillTask as JaxTask
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.convert import (
    _torch_name,
    jax_dual_params_to_torch,
    torch_name_to_jax_path,
)
from distillclip_tpu_torch.losses import LossCalculator, functional as F
from distillclip_tpu_torch.models import (
    CLIPOutput,
    ControlFlags,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextOutput,
    VisionOutput,
)
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.training import DualDistillTask, schedules, train_state

from test_teacher import CTX, PATCH, RES, VOCAB, _make_state_dict

B, OUT = 16, 48
IMAGE_ARGS = dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=32, depth=2,
                  num_heads=4, repeated_times=2, qkv_bias=True, use_transform=True)
TEXT_ARGS = dict(vocab_size=VOCAB, context_length=CTX, out_dim=OUT, embed_dim=32, depth=2,
                 num_heads=4, repeated_times=2, use_transform=True)
LOSSES = {"loss_name": ["out_l1", "out_cos", "cos_diff"], "loss_scale": {"cos_diff": 0.1}}
TASK_ARGS = dict(lr=1e-3, warm_steps=1, total_steps=10, weight_decay=1e-3)


def _assert_adam_steps_close(params, ref, first):
    """``params`` after three optimizer steps against the JAX package's ``ref``
    (flat, by JAX path).  Adam's first moving update is lr·g / (|g| + 1e-8):
    where the first gradient g (``first``) is zero up to float32 summation
    noise, the update follows the noise.  An element with |g| > 1e-6 is held
    to 1e-5.  One below that is held to 2e-4 (the largest seen is 5e-5); only
    the key third of a fused qkv bias, whose gradient is exactly zero in the
    math of plain attention, gets the size of the two moving updates, 2e-3."""
    for name, v in params.items():
        path = torch_name_to_jax_path(name)
        diff, g = np.abs(v.numpy() - ref[path]), np.abs(first[path])
        limit = np.where(g > 1e-6, 1e-5, 2e-4)
        if name.endswith(("attn.qkv.bias", "attn.in_proj.bias")):
            n = g.shape[0] // 3
            limit[n:2 * n] = np.where(g[n:2 * n] > 1e-6, 1e-5, 2e-3)
        assert (diff <= limit).all(), (name, float(diff.max()), float((diff - limit).max()))


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    """A tiny fabricated CLIP checkpoint: the JAX task loads a teacher even
    where the step never runs it."""
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return dict(
        tokens=toks,
        images=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
        tea_text=rng.normal(size=(B, OUT)).astype(np.float32),
        tea_image=rng.normal(size=(B, OUT)).astype(np.float32))


def _jax_task(ckpt_path, **over):
    return JaxTask(image_student=JaxVision(**IMAGE_ARGS), text_student=JaxText(**TEXT_ARGS),
                   loss_control_para=LOSSES, teacher_name=ckpt_path,
                   **{**TASK_ARGS, **over})


def _port_task(**over):
    return DualDistillTask(image_student=RepeatVisionTransformer(**IMAGE_ARGS),
                           text_student=RepeatTextTransformer(**TEXT_ARGS),
                           loss_control_para=LOSSES, **{**TASK_ARGS, **over})


def _jax_state(task, batch, steps_per_epoch=1):
    return task.init_state(jax.random.PRNGKey(1), jnp.asarray(batch["tokens"][:1]),
                           jnp.asarray(batch["images"][:1]), steps_per_epoch=steps_per_epoch)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(params):
    """{JAX path: numpy leaf} of a JAX parameter tree."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}


def _jax_value_and_grad(task, params, batch):
    def loss_fn(p):
        loss, (parts, _, _) = task.loss_fn_cached_all(
            p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["images"]),
            jnp.asarray(batch["tea_text"]), jnp.asarray(batch["tea_image"]),
            jax.random.PRNGKey(0), True)
        return loss, parts
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _port_args(batch):
    return [torch.from_numpy(batch[k]) for k in ("tokens", "images", "tea_text", "tea_image")]


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def fp32_pair(ckpt_path, batch):
    """(JAX task, JAX state, optimizer, port task, port state, optimizer) in
    fp32 on the same parameters."""
    jtask = _jax_task(ckpt_path, compute_dtype="float32")
    jstate, jtx = _jax_state(jtask, batch)
    ptask = _port_task(compute_dtype="float32")
    pstate, ptx = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    return jtask, jstate, jtx, ptask, pstate, ptx


# -- the loss and its gradient ---------------------------------------------------

def test_loss_parts_and_gradients_match_jax_fp32(fp32_pair, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask, jstate, _, ptask, pstate, _ = fp32_pair
    (jloss, jparts), jgrads = _jax_value_and_grad(jtask, jstate.params, batch)
    leaves = {k: v.clone().requires_grad_() for k, v in pstate.params.items()}
    loss, (parts, stu_out, tea_out) = ptask.loss_fn_cached_all(leaves, *_port_args(batch))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(parts) == set(jparts) == {"image_out_l1", "image_out_cos", "text_out_l1",
                                         "text_out_cos", "cos_diff"}
    for k in parts:
        assert abs(float(parts[k].detach()) - float(jparts[k])) <= 1e-5 * abs(float(jparts[k])), k
    assert stu_out.i2t_logits.shape == (B, B) and tea_out.t2i_logits.dtype == torch.float32
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref = _flat(jgrads)
    assert {torch_name_to_jax_path(k) for k in leaves} == set(ref)
    for name, g in zip(leaves, grads):
        r = ref[torch_name_to_jax_path(name)]
        assert g.shape == r.shape and _rel(g.numpy(), r) <= 1e-4, name


def test_loss_matches_jax_bf16_compute(ckpt_path, batch):
    """bf16 compute on fp32 masters, the JAX students through their Pallas
    kernels in interpret mode: the loss within 2e-2 absolute."""
    jtask = _jax_task(ckpt_path)
    jstate, _ = _jax_state(jtask, batch)
    ptask = _port_task()
    pstate, _ = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    (jloss, jparts), _ = _jax_value_and_grad(jtask, jstate.params, batch)
    ops.reset_launch_counts()
    loss, (parts, stu_out, _) = ptask.loss_fn_cached_all(pstate.params, *_port_args(batch))
    assert stu_out.visual_output.last_representation.dtype == torch.bfloat16
    assert loss.dtype == torch.float32 and abs(float(loss) - float(jloss)) <= 2e-2
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) <= 2e-2, k
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)   # CPU: plain versions


def test_norm_option_matches_jax(ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask = _jax_task(ckpt_path, compute_dtype="float32", norm=True)
    jstate, _ = _jax_state(jtask, batch)
    ptask = _port_task(compute_dtype="float32", norm=True)
    pstate, _ = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    (jloss, _), _ = _jax_value_and_grad(jtask, jstate.params, batch)
    loss, (_, stu_out, tea_out) = ptask.loss_fn_cached_all(pstate.params, *_port_args(batch))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for out in (stu_out, tea_out):
        np.testing.assert_allclose(
            out.text_output.last_representation.detach().norm(dim=-1).numpy(), 1.0, atol=1e-5)


# -- optimizer steps ---------------------------------------------------------------

def _run_jax_steps(task, state, tx, batch, n, mask=None):
    lrs = []
    for _ in range(n):
        lrs.append(float(task._lr_schedule(int(state.step))))
        _, grads = _jax_value_and_grad(task, state.params, batch)
        state = state.apply_gradients(grads, tx, mask)
    return state, lrs


def _assert_params_close(pstate, jstate, atol=1e-5):
    ref = _flat(jstate.params)
    for name, v in pstate.params.items():
        np.testing.assert_allclose(v.numpy(), ref[torch_name_to_jax_path(name)], atol=atol,
                                   rtol=0, err_msg=name)


def test_three_optimizer_steps_match_jax(ckpt_path, batch, monkeypatch):
    """Warm-up 1, cosine schedule stepped every step, weight decay 1e-3: every
    parameter leaf within 1e-5 of the JAX state's after 3 steps, and the
    learning rates equal."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask = _jax_task(ckpt_path, compute_dtype="float32")
    jstate, jtx = _jax_state(jtask, batch)
    ptask = _port_task(compute_dtype="float32", log_grad_norm=True)
    pstate, ptx = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    before = {k: v.clone() for k, v in pstate.params.items()}
    jstate, jlrs = _run_jax_steps(jtask, jstate, jtx, batch, 3)
    step = ptask.make_train_step(ptx, cached_teachers=True)
    plrs, losses = [], []
    for _ in range(3):
        plrs.append(ptask._lr_schedule(pstate.opt_state["count"]))
        pstate, metrics = step(pstate, *_port_args(batch))
        losses.append(float(metrics["loss"]))
    assert pstate.step == 3 and int(jstate.step) == 3
    np.testing.assert_allclose(plrs, jlrs, rtol=1e-6, atol=0)
    assert plrs[0] == 0.0 and plrs[1] == pytest.approx(1e-3)
    _assert_params_close(pstate, jstate)
    assert any(not torch.equal(before[k], v) for k, v in pstate.params.items())
    assert losses[2] < losses[1] == losses[0]          # the first update has lr 0
    assert set(metrics) == {"loss", "image_out_l1", "image_out_cos", "text_out_l1",
                            "text_out_cos", "cos_diff", "grad_norm"}
    assert all(not v.requires_grad for v in pstate.params.values())


def test_frozen_prefix_leaves_are_bit_identical(ckpt_path, batch, monkeypatch):
    """freeze_prefix=['text_tower']: the text student's leaves do not move,
    weight decay included, and the image student's follow the JAX state."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    over = dict(compute_dtype="float32", freeze_prefix=["text_tower.blocks_0", "image_tower.norm"])
    jtask = _jax_task(ckpt_path, **over)
    jstate, jtx = _jax_state(jtask, batch)
    ptask = _port_task(**over)
    pstate, ptx = ptask.init_state(0, 1, params=jax_dual_params_to_torch(
        _np_tree(jstate.params)), device="cpu")
    before = {k: v.clone() for k, v in pstate.params.items()}
    frozen = [k for k, m in ptask._mask.items() if not m]
    assert frozen and all(k.startswith(("student.text_tower.blocks.0.",
                                        "student.image_tower.norm.")) for k in frozen)
    jmask = _flat(jtask._mask)
    assert {torch_name_to_jax_path(k): m for k, m in ptask._mask.items()} == jmask
    jstate, _ = _run_jax_steps(jtask, jstate, jtx, batch, 3, jtask._mask)
    step = ptask.make_train_step(ptx, cached_teachers=True)
    for _ in range(3):
        pstate, _ = step(pstate, *_port_args(batch))
    for k in frozen:
        assert torch.equal(pstate.params[k], before[k]), k
    assert not torch.equal(pstate.params["student.image_tower.head.kernel"],
                           before["student.image_tower.head.kernel"])
    _assert_params_close(pstate, jstate)
    # trainable_mask=False unfreezes explicitly
    unfrozen = ptask.make_train_step(ptx, cached_teachers=True, trainable_mask=False)
    pstate, _ = unfrozen(pstate, *_port_args(batch))
    assert not torch.equal(pstate.params[frozen[0]], before[frozen[0]])


def test_accumulate_steps_is_one_step_on_the_mean_gradient(ckpt_path, batch, monkeypatch):
    """accumulate_grad_batches=2: nothing moves on the first micro-batch; the
    second steps on the mean of the two gradients, as optax.MultiSteps does."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    over = dict(compute_dtype="float32", warm_steps=0)
    jtask = _jax_task(ckpt_path, accumulate_grad_batches=2, **over)
    jstate, jtx = _jax_state(jtask, batch, steps_per_epoch=2)
    start = jax_dual_params_to_torch(_np_tree(jstate.params))
    halves = [{k: v[:B // 2] for k, v in batch.items()}, {k: v[B // 2:] for k, v in batch.items()}]

    acc = _port_task(accumulate_grad_batches=2, **over)
    astate, atx = acc.init_state(0, 2, params=start, device="cpu")
    astep = acc.make_train_step(atx, cached_teachers=True)
    astate, _ = astep(astate, *_port_args(halves[0]))
    assert all(torch.equal(astate.params[k], start[k]) for k in start)
    astate, _ = astep(astate, *_port_args(halves[1]))
    assert astate.step == 2 and astate.opt_state["count"] == 1

    one = _port_task(**over)
    ostate, otx = one.init_state(0, 1, params=start, device="cpu")
    grads = []
    for half in halves:
        leaves = {k: v.clone().requires_grad_() for k, v in ostate.params.items()}
        loss, _ = one.loss_fn_cached_all(leaves, *_port_args(half))
        grads.append(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
    mean = {k: grads[0][k] + (grads[1][k] - grads[0][k]) / 2 for k in grads[0]}
    ostate = ostate.apply_gradients(mean, otx)
    for k in start:
        np.testing.assert_allclose(astate.params[k].numpy(), ostate.params[k].numpy(),
                                   atol=1e-7, rtol=0, err_msg=k)
    assert not torch.equal(astate.params["student.text_tower.head.kernel"],
                           start["student.text_tower.head.kernel"])

    for half in halves:
        _, g = _jax_value_and_grad(jtask, jstate.params, half)
        jstate = jstate.apply_gradients(g, jtx, None)
    _assert_params_close(astate, jstate)


# -- optimizer and schedule on their own ----------------------------------------------

@pytest.mark.parametrize("clip", [None, 0.05], ids=["no_clip", "clip"])
@pytest.mark.parametrize("k", [1, 3], ids=["every_step", "accumulate3"])
def test_adamw_matches_optax(clip, k):
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (7,), "c": (2, 3, 4)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    sched = lambda c: 1e-2 / (1 + c)
    jtx = jax_train_state.make_optimizer(lambda c: 1e-2 / (1 + c), weight_decay=1e-2,
                                         grad_clip_norm=clip, accumulate_steps=k)
    ptx = train_state.make_optimizer(sched, weight_decay=1e-2, grad_clip_norm=clip,
                                     accumulate_steps=k)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jopt = jtx.init(jparams)
    pparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    popt = ptx.init(pparams)
    for _ in range(2 * k + 1):
        grads = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
        upd, jopt = jtx.update({n: jnp.asarray(g) for n, g in grads.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pupd, popt = ptx.update({n: torch.from_numpy(g) for n, g in grads.items()}, popt, pparams)
        for n in shapes:
            pparams[n] += pupd[n]
            np.testing.assert_allclose(pparams[n].numpy(), np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0)
    assert popt["count"] == 2 + (k == 1)


def test_schedule_matches_jax():
    args = dict(base_lr=1e-4, warmup_units=15, total_units=300)
    ref = jax_schedules.per_epoch(jax_schedules.hf_cosine_with_warmup(**args), 4)
    port = schedules.per_epoch(schedules.hf_cosine_with_warmup(**args), 4)
    steps = list(range(0, 80, 3)) + [599, 1199, 1200, 1300]
    np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)
    assert port(0) == 0.0 and port(60) == pytest.approx(1e-4) and port(1200) == 0.0


def test_global_norm_and_masks():
    tree = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    assert float(train_state.global_norm(tree)) == pytest.approx(5.0)
    masked = train_state.apply_mask(tree, {"a": False, "b": True})
    assert torch.equal(masked["a"], torch.zeros(2)) and masked["b"] is tree["b"]
    assert train_state.apply_mask(tree, None) is tree
    mask = train_state.freeze_mask({"x.y": 0, "x.z": 0, "w": 0}, frozen_paths=["w"],
                                   frozen_prefixes=["x/y"], path_of=lambda n: n.replace(".", "/"))
    assert mask == {"x.y": False, "x.z": True, "w": False}
    assert train_state.count_params(tree) == 3


def test_cast_to_compute_leaves_the_vocab_table_fp32():
    params = {"table": torch.zeros(train_state.EMBED_CAST_SKIP_ROWS, 4, requires_grad=True),
              "kernel": torch.ones(8, 4, requires_grad=True), "ids": torch.zeros(3, dtype=torch.long)}
    cast = train_state.cast_to_compute(params)
    assert cast["table"] is params["table"] and cast["ids"] is params["ids"]
    assert cast["kernel"].dtype == torch.bfloat16
    cast["kernel"].float().sum().backward()
    assert params["kernel"].grad.dtype == torch.float32     # back on the fp32 master
    ref = jax_train_state.cast_to_compute(
        {"table": jnp.zeros((train_state.EMBED_CAST_SKIP_ROWS, 4)), "kernel": jnp.ones((8, 4))})
    assert str(ref["table"].dtype) == "float32" and str(ref["kernel"].dtype) == "bfloat16"


# -- the losses ---------------------------------------------------------------------

def _reps(seed=5, n=6, d=10):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("name", ["out_l1", "out_cos"])
def test_representation_losses_match_jax(name):
    s, t = _reps()
    ref = float(getattr(jax_F, name)(jnp.asarray(s), jnp.asarray(t)))
    out = getattr(F, name)(torch.from_numpy(s), torch.from_numpy(t))
    assert out.dtype == torch.float32 and float(out) == pytest.approx(ref, rel=1e-6)
    out16 = getattr(F, name)(torch.from_numpy(s).bfloat16(), torch.from_numpy(t).bfloat16())
    ref16 = float(getattr(jax_F, name)(jnp.asarray(s, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16)))
    assert out16.dtype == torch.float32 and float(out16) == pytest.approx(ref16, rel=1e-6)


def test_out_cos_adds_eps_to_the_product_of_norms():
    s = torch.zeros(2, 4)
    assert float(F.out_cos(s, s)) == 1.0                     # 0 / (0 + 1e-8), not nan
    assert float(jax_F.out_cos(jnp.zeros((2, 4)), jnp.zeros((2, 4)))) == 1.0


def test_cos_diff_and_off_diagonal_match_jax():
    rng = np.random.default_rng(6)
    s, t = (rng.uniform(-1, 1, size=(7, 7)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(F._off_diagonal(torch.from_numpy(s)).numpy(),
                                  np.asarray(jax_F._off_diagonal(jnp.asarray(s))))
    assert F._off_diagonal(torch.from_numpy(s)).shape == (42,)
    ref = float(jax_F.cos_diff(jnp.asarray(s), jnp.asarray(t)))
    assert float(F.cos_diff(torch.from_numpy(s), torch.from_numpy(t))) == pytest.approx(ref, rel=1e-6)


def _clip_outputs(seed):
    rng = np.random.default_rng(seed)
    img, txt = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    logits = rng.uniform(-1, 1, size=(5, 5)).astype(np.float32)
    jout = JaxCLIPOutput(
        visual_output=JaxVisionOutput(jnp.asarray(img), jnp.asarray(img)[:, None]),
        text_output=JaxTextOutput(jnp.asarray(txt), jnp.asarray(txt)[:, None]),
        i2t_logits=jnp.asarray(logits), t2i_logits=jnp.asarray(logits).T)
    pout = CLIPOutput(visual_output=VisionOutput(torch.from_numpy(img)),
                      text_output=TextOutput(torch.from_numpy(txt)),
                      i2t_logits=torch.from_numpy(logits), t2i_logits=torch.from_numpy(logits).t())
    return jout, pout


@pytest.mark.parametrize("para", [
    {"loss_name": ["out_l1", "out_cos", "cos_diff"], "loss_scale": {"cos_diff": 0.1}},
    {"loss_name": ["out_l1", "out_cos", "cos_diff"], "percent": {"out_l1": 0.5}},
    {"loss_name": ["out_l1", "cos_diff"], "loss_scale": {"out_l1": 2.0},
     "percent": {"out_l1": 0.25, "cos_diff": 0.75}},
    {"loss_name": ["out_cos"]},
], ids=["final_config", "partial_percent", "scale_and_percent", "one_loss"])
def test_loss_calculator_matches_jax(para):
    ref, port = JaxCalculator(**para), LossCalculator(**para)
    assert port.percent == pytest.approx(ref.percent) and port.loss_scale == ref.loss_scale
    assert port.control_flags() == ControlFlags() and not port.control_flags().any_tap()
    assert not port.has_params
    jstu, pstu = _clip_outputs(7)
    jtea, ptea = _clip_outputs(8)
    jtotal, jres = ref(jstu, jtea, "all")
    total, res = port(pstu, ptea, "all")
    assert float(total) == pytest.approx(float(jtotal), rel=1e-6)
    assert set(res) == set(jres)
    for k in res:
        assert float(res[k]) == pytest.approx(float(jres[k]), rel=1e-6), k
    jtotal, jres = ref(jstu.visual_output, jtea.visual_output, "image")
    total, res = port(pstu.visual_output, ptea.visual_output, "image")
    assert float(total) == pytest.approx(float(jtotal), rel=1e-6) and set(res) == set(jres)


def test_loss_calculator_refuses_bad_percent_like_jax():
    for para in ({"loss_name": ["out_l1", "out_cos"], "percent": {"out_l1": 1.5}},
                 {"loss_name": ["out_l1", "out_cos"], "percent": {"out_l1": 0.3, "out_cos": 0.3}}):
        with pytest.raises(ValueError):
            JaxCalculator(**para)
        with pytest.raises(ValueError):
            LossCalculator(**para)


# -- the converter -------------------------------------------------------------------

def test_dual_converter_names_round_trip(fp32_pair):
    _, jstate, _, ptask, pstate, _ = fp32_pair
    ref = _flat(jstate.params)
    assert {torch_name_to_jax_path(k) for k in pstate.params} == set(ref)
    for name, v in pstate.params.items():
        path = torch_name_to_jax_path(name)
        assert _torch_name(path) == name
        np.testing.assert_array_equal(v.numpy(), ref[path])
        assert v.dtype == torch.float32
    with pytest.raises(ValueError, match="image_tower"):
        jax_dual_params_to_torch({"student": {"image_tower": {}}})
    with pytest.raises(ValueError, match="do not match the students"):
        ptask.init_state(0, 1, params={"student.image_tower.head.kernel": np.zeros((32, OUT))},
                         device="cpu")


def test_seeded_init_state_is_reproducible():
    a, _ = _port_task().init_state(0, 1, device="cpu")
    b, _ = _port_task().init_state(0, 1, device="cpu")
    c, _ = _port_task().init_state(1, 1, device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert any(not torch.equal(a.params[k], c.params[k]) for k in a.params)
    assert all(v.dtype == torch.float32 for v in a.params.values())
    assert a.step == 0 and a.opt_state["count"] == 0 and "acc_grads" not in a.opt_state


# -- what the slice refuses, and what it no longer does -----------------------------------

def test_teacher_paths_are_refused_by_item(ckpt_path, batch):
    """The steps that run a teacher build (tests/test_torch_teacher_steps.py
    holds them to JAX); what stays refused names its ROADMAP item; a step that
    is not deterministic is taken (with zero rates it is the same step)."""
    task = _port_task(teacher_name=ckpt_path, compute_dtype="float32")
    state, tx = task.init_state(0, 1, device="cpu")
    assert callable(task.make_train_step(tx, cached_text_teacher=True))
    assert callable(task.make_train_step(tx))
    assert task.teacher._module is None          # built at first use, not before
    frozen = _port_task(freeze_embed=True, teacher_name=ckpt_path)
    assert len(frozen._frozen_paths()) == 3
    toks, imgs, tea_text, _ = _port_args(batch)
    gen = torch.Generator().manual_seed(0)
    live, _ = task.loss_fn(state.params, toks, imgs, deterministic=False, generator=gen)
    assert torch.equal(live, task.loss_fn(state.params, toks, imgs)[0])
    cached, _ = task.loss_fn_cached_text(state.params, toks, imgs, tea_text,
                                         deterministic=False, generator=gen)
    assert torch.equal(cached, task.loss_fn_cached_text(state.params, toks, imgs, tea_text)[0])


def test_load_path_needs_both_checkpoints():
    """A ``load_path`` without one of its towers raises the JAX package's
    ValueError when the masters are made, as there."""
    for load_path in ({"image": "a"}, {"text": "b"}, {"image": None, "text": "b"}):
        task = _port_task(load_path=load_path)
        with pytest.raises(ValueError, match="the cpk is None"):
            task.init_params(0, "cpu")


def test_tap_and_unported_losses_are_refused_by_item():
    """Every loss name of the JAX package builds a task with the flags its
    losses need; an unknown name is refused as there; a tap configuration
    cannot take a cached step."""
    args = dict(image_student=RepeatVisionTransformer(**IMAGE_ARGS),
                text_student=RepeatTextTransformer(**TEXT_ARGS))
    para = dict(student_dims=32, teacher_dims=64)
    want = {"attention_score_mse": ControlFlags(need_attn_score=True),
            "hidden_rep_mse": ControlFlags(need_rep=True), "hard_label": ControlFlags(),
            "vit_kd": ControlFlags(need_rep=True)}
    for name, flags in want.items():
        task = DualDistillTask(loss_control_para={"loss_name": ["out_l1", name],
                                                  "vit_kd_para": para}, **args)
        assert task.flags == flags
        assert task.loss_control.has_params == (name == "vit_kd")
    with pytest.raises(ValueError, match="Invalid Loss Type"):
        LossCalculator(["out_l2"])
    with pytest.raises(ValueError, match="Invalid Loss Type"):
        JaxCalculator(["out_l2"])
    # a tap configuration, however it arises, cannot take the cached step
    task = _port_task()
    _, tx = task.init_state(0, 1, device="cpu")
    task.flags = ControlFlags(need_attn_score=True)
    with pytest.raises(ValueError, match="cached_teachers requires"):
        task.make_train_step(tx, cached_teachers=True)


def test_dropout_and_taps_in_training_are_refused_by_item(batch):
    """Dropout and taps run in training mode: a stochastic cached step with
    zero rates is the deterministic one, a tower with a drop rate differs from
    its eval output and repeats from its seed, and a tapped tower in training
    mode returns its hidden states."""
    task = _port_task(compute_dtype="float32")
    state, _ = task.init_state(0, 1, device="cpu")
    sto, _ = task.loss_fn_cached_all(state.params, *_port_args(batch), deterministic=False,
                                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(sto, task.loss_fn_cached_all(state.params, *_port_args(batch))[0])
    images = torch.from_numpy(batch["images"])
    tower = seeded_init(RepeatVisionTransformer(**dict(IMAGE_ARGS, drop_rate=0.1)),
                        np.random.default_rng(0))
    with torch.no_grad():
        a = tower.train()(images, ControlFlags(), torch.Generator().manual_seed(1))
        b = tower(images, ControlFlags(), torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, tower.eval()(images))
    out = RepeatVisionTransformer(**IMAGE_ARGS).train()(images, ControlFlags(need_rep=True))
    assert out.representations.shape == (IMAGE_ARGS["depth"], len(images), 17, 32)


def test_training_mode_with_zero_drop_rates_equals_eval(batch):
    tower = seeded_init(RepeatTextTransformer(**TEXT_ARGS), np.random.default_rng(0))
    toks = torch.from_numpy(batch["tokens"]).long()
    out_train = tower.train()(toks)
    with torch.no_grad():
        out_eval = tower.eval()(toks)
    assert out_train.grad_fn is not None
    torch.testing.assert_close(out_train.detach(), out_eval, atol=0, rtol=0)
