"""The PyTorch port's CLIP teacher against the JAX package, on the CPU.

One fabricated CLIP checkpoint file is read by both packages' loaders; the
towers then see the same numpy inputs.  fp32 comparisons run the JAX towers on
their XLA path (DISTILLCLIP_FLASH=0) and hold outputs to 1e-4 of the largest
entry; the bf16 comparison runs them through the Pallas kernels in interpret
mode and holds outputs to 2e-2 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import teacher as jax_teacher
from distillclip_tpu.models.teacher_init import init_layers_with_teacher as jax_warm_start
from distillclip_tpu.tools import fabricate_teacher as jax_fabricate
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.convert import jax_teacher_params_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.models import (
    CLIPModel,
    ControlFlags,
    ImageEncoder,
    TextEncoder,
    TextOutput,
    VisionOutput,
    teacher,
)
from distillclip_tpu_torch.models.layers import InstrumentedAttention, LayerNorm, quick_gelu
from distillclip_tpu_torch.models.teacher_init import init_layers_with_teacher
from distillclip_tpu_torch.models.transformer import causal_mask, clip_init_stds
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

from test_teacher import CTX, RES, VOCAB, _make_state_dict

B = 4
# a two-head teacher (width 128 under the width // 64 rule), 3 and 2 layers
WIDE = dict(vision_width=128, vision_layers=3, patch_size=8, image_resolution=16,
            text_width=128, text_layers=2, context_length=CTX, vocab_size=VOCAB, embed_dim=48)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    """The JAX teacher tests' checkpoint: one head, random LN parameters."""
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def wide_path(tmp_path_factory):
    """A checkpoint written by the port's fabricator."""
    path = tmp_path_factory.mktemp("ckpt") / "wide_clip.pt"
    torch.save(make_clip_state_dict(**WIDE), str(path))
    return str(path)


def _batch(res, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return toks, rng.normal(size=(B, res, res, 3)).astype(np.float32)


def _flat(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# -- the checkpoint and its loaders -------------------------------------------------

def test_fabricated_checkpoint_equals_the_jax_package_s():
    ours, theirs = make_clip_state_dict(seed=3), jax_fabricate.make_clip_state_dict(seed=3)
    assert list(ours) == list(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert any(not torch.equal(ours[k], v) for k, v in make_clip_state_dict(seed=4).items())


@pytest.mark.parametrize("which", ["tiny", "wide"])
def test_both_loaders_read_the_same_hyperparameters_and_tensors(which, ckpt_path, wide_path):
    path = ckpt_path if which == "tiny" else wide_path
    sd, jsd = teacher.load_torch_state_dict(path), jax_teacher.load_torch_state_dict(path)
    assert set(sd) == set(jsd)
    assert all(v.dtype == torch.float32 and np.array_equal(v.numpy(), jsd[k])
               for k, v in sd.items())
    assert teacher.get_transformer_para(sd) == jax_teacher.get_transformer_para(jsd)
    assert teacher.get_visual_para(sd) == jax_teacher.get_visual_para(jsd)

    module = teacher.teacher_load(path, None, "all", device="cpu")
    _, jvars = jax_teacher.teacher_load(path, None, "all")
    state = module.state_dict()
    converted = jax_teacher_params_to_torch(jvars)
    assert set(state) == set(converted)
    assert all(torch.equal(state[k], converted[k]) for k in state)
    assert {torch_name_to_jax_path(k) for k in state} == set(_flat(jvars["params"]))
    assert not module.training and not any(p.requires_grad for p in module.parameters())
    heads = 1 if which == "tiny" else 2
    assert module.image_tower.visual.transformer.heads == heads
    assert module.text_tower.text.transformer.heads == heads


def test_single_tower_loaders_and_need_layers(ckpt_path):
    img = teacher.teacher_load(ckpt_path, None, "image", need_layers=[0, 2], device="cpu")
    txt = teacher.teacher_load(ckpt_path, None, "text", device="cpu")
    assert isinstance(img, ImageEncoder) and isinstance(txt, TextEncoder)
    assert img.selected_layers == (0, 2) and txt.selected_layers == (0, 1)
    jimg, jvars = jax_teacher.teacher_load(ckpt_path, None, "image", need_layers=[0, 2])
    assert tuple(jimg.selected_layers) == img.selected_layers
    one = jax_teacher_params_to_torch(jvars)
    assert set(one) == set(img.state_dict())
    with pytest.raises(ValueError, match="image\\|text\\|all"):
        teacher.teacher_load(ckpt_path, None, "both", device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        teacher.resolve_checkpoint("no-such-model")
    assert teacher.resolve_checkpoint(ckpt_path) == ckpt_path
    assert teacher.available_models() == jax_teacher.available_models()
    assert teacher.MODELS == jax_teacher.MODELS


def test_torchscript_archives_and_wrapped_state_dicts_load(tmp_path):
    """The OpenAI checkpoints are torchscript archives; a ``{"state_dict": ...}``
    wrapper is accepted too.  Values come back as fp32."""
    lin = torch.nn.Linear(3, 2).half()
    torch.jit.save(torch.jit.script(lin), str(tmp_path / "scripted.pt"))
    sd = teacher.load_torch_state_dict(str(tmp_path / "scripted.pt"))
    assert set(sd) == {"weight", "bias"} and sd["weight"].dtype == torch.float32
    assert torch.equal(sd["weight"], lin.weight.detach().float())
    torch.save({"state_dict": {"w": torch.ones(2, dtype=torch.float16)}},
               str(tmp_path / "wrapped.pt"))
    sd = teacher.load_torch_state_dict(str(tmp_path / "wrapped.pt"))
    assert set(sd) == {"w"} and sd["w"].dtype == torch.float32


def test_patch_kernel_is_in_patchify_s_pixel_order(ckpt_path):
    """The patch product equals the checkpoint's convolution."""
    sd = teacher.load_torch_state_dict(ckpt_path)
    module = teacher.load_image_teacher(ckpt_path, device="cpu")
    _, images = _batch(RES)
    x = torch.from_numpy(images)
    conv = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), sd["visual.conv1.weight"],
                                      stride=module.visual.patch_size)
    from distillclip_tpu_torch.models.vit import patchify
    mine = patchify(x, module.visual.patch_size) @ module.visual.patch_kernel
    torch.testing.assert_close(mine, conv.flatten(2).transpose(1, 2), atol=1e-5, rtol=1e-5)


# -- the towers ---------------------------------------------------------------------

def _jax_out(path, model_type, x, dtype=jnp.float32):
    module, variables = jax_teacher.teacher_load(path, None, model_type)
    variables = jax.tree_util.tree_map(lambda v: v.astype(dtype), variables)
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(dtype)
    return module.apply(variables, x, JaxFlags())


@pytest.mark.parametrize("which", ["tiny", "wide"])
@pytest.mark.parametrize("model_type", ["image", "text"])
def test_tower_matches_jax_fp32(which, model_type, ckpt_path, wide_path, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    path, res = (ckpt_path, RES) if which == "tiny" else (wide_path, 16)
    toks, images = _batch(res)
    x = images if model_type == "image" else toks
    ref = _jax_out(path, model_type, x)
    module = teacher.teacher_load(path, None, model_type, device="cpu")
    xt = torch.from_numpy(x) if model_type == "image" else torch.from_numpy(x).long()
    with torch.no_grad():
        out = module(xt, ControlFlags())
    assert isinstance(out, VisionOutput if model_type == "image" else TextOutput)
    assert out.last_representation.shape == (B, 48)
    assert _rel(out.last_representation.numpy(), ref.last_representation) <= 1e-4
    assert _rel(out.last_layer_output.numpy(), ref.last_layer_output) <= 1e-4


@pytest.mark.parametrize("model_type", ["image", "text"])
def test_tower_matches_jax_bf16(model_type, wide_path):
    """bf16 weights and activations, the JAX tower through its Pallas kernels
    in interpret mode (LN-prologue GEMMs, plain attention)."""
    toks, images = _batch(16, seed=1)
    x = images if model_type == "image" else toks
    ref = _jax_out(wide_path, model_type, x, jnp.bfloat16)
    from distillclip_tpu_torch.serving import cast_to_compute
    module = cast_to_compute(teacher.teacher_load(wide_path, None, model_type, device="cpu"))
    xt = (torch.from_numpy(x).to(torch.bfloat16) if model_type == "image"
          else torch.from_numpy(x).long())
    ops.reset_launch_counts()
    with torch.no_grad():
        out = module(xt)
    assert out.last_representation.dtype == torch.bfloat16
    np.testing.assert_allclose(out.last_representation.float().numpy(),
                               np.asarray(ref.last_representation.astype(jnp.float32)),
                               atol=2e-2, rtol=0)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)   # CPU: plain versions


def test_dual_teacher_logits_and_score_match_jax_fp32(wide_path, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    toks, images = _batch(16, seed=2)
    jmod, jvars = jax_teacher.teacher_load(wide_path, None, "all")
    ref = jmod.apply(jvars, jnp.asarray(toks), jnp.asarray(images), JaxFlags())
    jf_img, jf_txt, jlogits = jmod.apply(jvars, jnp.asarray(toks), jnp.asarray(images),
                                         method="score")
    module = teacher.teacher_load(wide_path, None, "all", device="cpu")
    assert isinstance(module, CLIPModel)
    with torch.no_grad():
        out = module(torch.from_numpy(toks).long(), torch.from_numpy(images))
        f_img, f_txt, logits = module.score(torch.from_numpy(toks).long(),
                                            torch.from_numpy(images))
    assert out.i2t_logits.shape == (B, B) and out.i2t_logits.dtype == torch.float32
    np.testing.assert_allclose(out.i2t_logits.numpy(), np.asarray(ref.i2t_logits), atol=1e-5)
    np.testing.assert_allclose(out.t2i_logits.numpy(), np.asarray(ref.t2i_logits), atol=1e-5)
    assert isinstance(out.visual_output, VisionOutput)     # passed through, not wrapped
    assert out.visual_output.last_layer_output is not None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(f_img.numpy(), np.asarray(jf_img), atol=1e-5)
    np.testing.assert_allclose(f_txt.numpy(), np.asarray(jf_txt), atol=1e-5)
    np.testing.assert_allclose(f_img.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_layers_match_their_definitions():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32))
    np.testing.assert_allclose(quick_gelu(x).numpy(),
                               (x * torch.sigmoid(1.702 * x)).numpy(), atol=1e-6)
    ln = LayerNorm(16)
    with torch.no_grad():
        ln.scale.mul_(1.5)
        ln.bias.add_(0.25)
        ref = torch.nn.functional.layer_norm(x, (16,), ln.scale, ln.bias, 1e-5)
        np.testing.assert_allclose(ln(x).numpy(), ref.numpy(), atol=1e-5)
        assert ln(x.to(torch.bfloat16)).dtype == torch.bfloat16
    mask = causal_mask(4)
    assert mask.shape == (4, 4) and mask[0, 1] == -1e9 and mask[1, 0] == 0 and mask[2, 2] == 0
    attn_std, proj_std, fc_std = clip_init_stds(64, 2)
    assert attn_std == 64 ** -0.5 and proj_std == 64 ** -0.5 * 4 ** -0.5
    assert fc_std == 128 ** -0.5


def test_seeded_clip_init_follows_the_init_scheme():
    enc = seeded_init(ImageEncoder(is_student=True, input_resolution=16, patch_size=8,
                                   width=128, layers=2, heads=2, output_dim=24),
                      np.random.default_rng(0))
    sd = enc.state_dict()
    attn_std, proj_std, fc_std = clip_init_stds(128, 2)
    block = "visual.transformer.resblocks.1."
    for name, std in ((block + "attn.in_proj.kernel", attn_std),
                      (block + "attn.in_proj.bias", attn_std),
                      (block + "attn.out_proj.kernel", proj_std),
                      (block + "mlp.c_fc.kernel", fc_std), (block + "mlp.c_proj.kernel", proj_std),
                      ("visual.patch_kernel", 128 ** -0.5), ("visual.proj", 128 ** -0.5)):
        assert abs(float(sd[name].std()) / std - 1) < 0.2, name
    assert torch.equal(sd[block + "ln_1.scale"], torch.ones(128))
    assert not sd[block + "mlp.c_fc.bias"].any() and not sd[block + "ln_2.bias"].any()
    txt = seeded_init(TextEncoder(is_student=True, vocab_size=VOCAB, context_length=CTX,
                                  width=64, layers=1, heads=1, output_dim=24),
                      np.random.default_rng(0))
    assert abs(float(txt.text.token_embedding.embed.embedding.detach().std()) / 0.02 - 1) < 0.1
    assert abs(float(txt.text.positional_embedding.detach().std()) / 0.01 - 1) < 0.2


# -- the teacher warm start -----------------------------------------------------------

@pytest.mark.parametrize("init_type,step", [("begin", None), ("end", None), ("mid", None),
                                            ("mid", 1)])
@pytest.mark.parametrize("scope", ["visual", "text"])
def test_init_layers_with_teacher_matches_jax(init_type, step, scope, ckpt_path):
    """A 1- or 2-layer student of the teacher's width takes the teacher's
    blocks by ``init_type``, and every other leaf of the same shape."""
    model_type = "image" if scope == "visual" else "text"
    _, jvars = jax_teacher.teacher_load(ckpt_path, None, model_type)
    tea_tree = jvars["params"][scope]
    tea = teacher.teacher_load(ckpt_path, None, model_type, device="cpu")
    tea_state = {k[len(scope) + 1:]: v for k, v in tea.state_dict().items()}
    if scope == "visual":
        stu = ImageEncoder(is_student=True, input_resolution=RES, patch_size=8, width=64,
                           layers=2, heads=1, output_dim=32)       # output_dim differs
    else:
        stu = TextEncoder(is_student=True, vocab_size=VOCAB, context_length=CTX, width=64,
                          layers=1, heads=1, output_dim=48)
    seeded_init(stu, np.random.default_rng(1))
    stu_state = {k[len(scope) + 1:]: v for k, v in stu.state_dict().items()}
    # the same student as a JAX tree
    stu_tree = {}
    for name, v in stu_state.items():
        node = stu_tree
        parts = torch_name_to_jax_path(name).split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v.numpy()
    ref = _flat(jax_warm_start(stu_tree, jax.tree_util.tree_map(np.asarray, tea_tree),
                               init_type, step))
    out = init_layers_with_teacher(stu_state, tea_state, init_type, step)
    assert set(out) == set(stu_state)
    for name, v in out.items():
        np.testing.assert_array_equal(v.numpy(), ref[torch_name_to_jax_path(name)], err_msg=name)
        assert v.data_ptr() not in (stu_state[name].data_ptr(),
                                    tea_state.get(name, v).data_ptr()) or name not in tea_state
    n_tea = 3 if scope == "visual" else 2
    n_stu = 2 if scope == "visual" else 1
    first = {"begin": 0, "end": n_tea - n_stu, "mid": 0}[init_type]
    leaf = "transformer.resblocks.{}.mlp.c_fc.kernel"
    assert torch.equal(out[leaf.format(0)], tea_state[leaf.format(first)])
    if scope == "visual":
        assert torch.equal(out["proj"], stu_state["proj"])           # shapes differ: kept
        assert torch.equal(out["patch_kernel"], tea_state["patch_kernel"])
    assert init_layers_with_teacher(stu_state, tea_state, None) is stu_state


def test_init_layers_with_teacher_refuses_bad_arguments(ckpt_path):
    tea = teacher.teacher_load(ckpt_path, None, "text", device="cpu")
    state = {k[5:]: v for k, v in tea.state_dict().items()}
    with pytest.raises(ValueError, match="begin, end, and mid"):
        init_layers_with_teacher(state, state, "middle")
    with pytest.raises(ValueError, match="out of range"):
        init_layers_with_teacher(state, state, "mid", step=5)


# -- the ResNet teacher, taps and dropout -----------------------------------------------

def test_resnet_taps_and_dropout_are_refused_by_item(tmp_path, ckpt_path):
    # an RN-class checkpoint loads as a ModifiedResNet and encodes
    # (tests/test_torch_resnet.py holds it to JAX)
    rn = tmp_path / "rn.pt"
    torch.save(jax_fabricate.make_rn_state_dict(), str(rn))
    rn_tower = teacher.teacher_load(str(rn), None, "image", device="cpu")
    assert type(rn_tower).__name__ == "ModifiedResNet"
    with torch.no_grad():
        rep = rn_tower(torch.zeros(2, 64, 64, 3)).last_representation
    assert rep.shape == (2, 32) and torch.isfinite(rep).all()
    img = teacher.teacher_load(ckpt_path, None, "image", device="cpu")
    _, images = _batch(RES)
    # the taps and attention dropout run (tests/test_torch_taps.py holds them to JAX)
    for flags, field in ((ControlFlags(need_attn_prob=True), "attention_probs"),
                         (ControlFlags(need_value_map=True), "value_map"),
                         (ControlFlags(need_rep=True), "representations"),
                         (ControlFlags(need_emb=True), "embedding")):
        with torch.no_grad():
            out = img(torch.from_numpy(images), flags)
        assert getattr(out, field) is not None and torch.isfinite(getattr(out, field)).all()
    attn = seeded_init(InstrumentedAttention(64, 1, drop_prob=0.1),
                       np.random.default_rng(0)).train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32))
    with torch.no_grad():
        dropped = attn(x, ControlFlags(), LayerNorm(64), 4,
                       generator=torch.Generator().manual_seed(0)).hidden
        assert not torch.equal(dropped, attn.eval()(x, ControlFlags(), LayerNorm(64), 4).hidden)
    with pytest.raises(ValueError, match="not divisible"):
        InstrumentedAttention(64, 3)
    with pytest.raises(ValueError, match="expected NHWC"):
        img(torch.zeros(1, 8, 8, 3))
