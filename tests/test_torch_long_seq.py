"""Attention past 256 tokens in the port's towers, on the CPU.

The JAX towers send attention to their Pallas kernels only up to 256 tokens
(``flash_ok ... and N <= 256`` in ``distillclip_tpu/models/layers.py`` and
``repeat_vit.py``) and take XLA's materialised attention past that: ViT-L/14
has 257 tokens at 224 px, ViT-L/14@336px 577.  The port's towers share that
gate (``models.layers.attention_kernel_ok``).  Here, at 257 tokens (32 px
images, patch 2, width 32, 4 heads):

* with every attention kernel wrapper that the towers import replaced by one
  that raises, the CLIP tower and both weight-share students still run,
  forward and backward, with and without collected hidden states; at 226
  tokens they reach a kernel;
* the CLIP tower and the head-transform student match the JAX package (its
  own dispatch, no knob set: XLA past 256 tokens) in fp32, outputs and taps
  within 1e-4 of each field's largest entry, the student's parameter
  gradients within 1e-4 of each leaf's largest entry (the JAX package's
  fp32 tap tolerance, ``tests/test_torch_taps.py``);
* the published geometries of ``tools/fabricate_teacher.py``'s presets give
  the tensor shapes and hyperparameters of OpenAI's checkpoints (cut depth).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models.encoders import ImageEncoder as JaxImageEncoder
from distillclip_tpu_torch.convert import jax_encoder_to_torch, jax_student_to_torch
from distillclip_tpu_torch.models import ControlFlags, ImageEncoder, RepeatVisionTransformer
from distillclip_tpu_torch.models import layers, repeat_vit
from distillclip_tpu_torch.models.layers import attention_kernel_ok
from distillclip_tpu_torch.models.teacher import get_transformer_para, get_visual_para
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.tools import fabricate_teacher

RES, PATCH = 32, 2          # 16 x 16 patches and the class token: 257 tokens
B, OUT = 2, 24
REL = 1e-4
TEACHER = dict(is_student=False, input_resolution=RES, patch_size=PATCH, width=32, layers=2,
               heads=4, output_dim=OUT)
STUDENT = dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=32, depth=2,
               num_heads=4, repeated_times=2, qkv_bias=True, use_transform=True)
PLAIN_STUDENT = dict(STUDENT, use_transform=False)
TOWERS = {
    "clip tower": (ImageEncoder, TEACHER),
    "head-transform student": (RepeatVisionTransformer, STUDENT),
    "plain student": (RepeatVisionTransformer, PLAIN_STUDENT),
}
FLAGS = {"none": {}, "rep": dict(need_rep=True)}
TAP_FLAGS = dict(need_emb=True, need_attn_score=True, need_attn_prob=True,
                 need_value_map=True, need_rep=True, need_last_layer=True)
FIELDS = ("last_representation", "last_layer_output", "attention_scores", "attention_probs",
          "representations", "value_map", "embedding")
# the attention kernel wrappers each tower module imports
WRAPPERS = {layers: ("plain_attention_rows_qkv", "flash_attention"),
            repeat_vit: ("plain_attention_rows_qkv", "flash_attention",
                         "transform_attention_rows_qkv")}


@pytest.fixture
def no_attention_kernels(monkeypatch):
    """Every attention wrapper the towers import raises when called."""
    def refuse(name):
        def wrapper(*args, **kwargs):
            raise AssertionError(f"attention kernel wrapper {name} called")
        return wrapper
    for module, names in WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))


def _images(res=RES, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, res, res, 3)).astype(np.float32)


def _tower(kind, **over):
    cls, args = TOWERS[kind]
    return seeded_init(cls(**{**args, **over}), np.random.default_rng(1))


def _pooled(out):
    return out if isinstance(out, torch.Tensor) else out.last_representation


def test_the_gate_is_the_jax_towers():
    flags = ControlFlags()
    assert attention_kernel_ok(flags, 256, False)
    assert not attention_kernel_ok(flags, 257, False)
    assert not attention_kernel_ok(ControlFlags(need_attn_prob=True), 50, False)
    assert not attention_kernel_ok(flags, 50, True)
    assert not attention_kernel_ok(flags, 50, False, rpe=True)
    assert attention_kernel_ok(ControlFlags(need_rep=True), 50, False)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("kind", list(TOWERS))
def test_towers_materialise_attention_past_256_tokens(kind, flag, no_attention_kernels):
    """Fails where a tower sends 257 tokens to a kernel wrapper."""
    tower = _tower(kind)
    x = torch.from_numpy(_images())
    out = tower(x, ControlFlags(**FLAGS[flag]))
    pooled = _pooled(out)
    assert pooled.shape == (B, OUT) and torch.isfinite(pooled).all()
    if flag == "rep":
        assert out.representations.shape[-2] == (RES // PATCH) ** 2 + 1
    if kind != "clip tower":        # the students train there too
        pooled.square().sum().backward()
        grads = [p.grad for p in tower.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("kind", list(TOWERS))
def test_towers_reach_a_kernel_up_to_256_tokens(kind, no_attention_kernels):
    """At 226 tokens (30 px, patch 2) the same towers call a kernel wrapper."""
    res = 30
    over = {"input_resolution": res} if kind == "clip tower" else {"img_size": res}
    tower = _tower(kind, **over)
    with pytest.raises(AssertionError, match="attention kernel wrapper"):
        tower(torch.from_numpy(_images(res)))


def _assert_fields_close(out, ref, what):
    if isinstance(out, torch.Tensor):          # a weight-share tower under the default flags
        out = dataclasses.make_dataclass("Pooled", ["last_representation"])(out)
    if not hasattr(ref, "last_representation"):
        ref = dataclasses.make_dataclass("Pooled", ["last_representation"])(ref)
    for field in FIELDS:
        r = getattr(ref, field, None)
        o = getattr(out, field, None)
        if r is None:
            assert o is None, (what, field)
            continue
        if o is None and field == "last_layer_output":
            continue                # the port's pooled tower returns no token map
        r = np.asarray(r.astype(jnp.float32))
        assert o is not None and tuple(o.shape) == r.shape, (what, field)
        err = np.abs(o.detach().float().numpy() - r).max()
        assert err <= REL * max(np.abs(r).max(), 1e-6), (what, field, err)


@pytest.mark.parametrize("flags", ["none", "taps"])
def test_clip_tower_past_256_tokens_matches_jax_fp32(flags, monkeypatch):
    monkeypatch.delenv("DISTILLCLIP_FLASH", raising=False)    # JAX's own dispatch
    kw = TAP_FLAGS if flags == "taps" else {}
    x = _images()
    jmod = JaxImageEncoder(**TEACHER)
    params = jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]),
                       JaxFlags(**kw))["params"]
    pmod = ImageEncoder(**TEACHER)
    pmod.load_state_dict(jax_encoder_to_torch(params, "image"))
    ref = jmod.apply({"params": params}, jnp.asarray(x), JaxFlags(**kw))
    with torch.no_grad():
        out = pmod.eval()(torch.from_numpy(x), ControlFlags(**kw))
    _assert_fields_close(out, ref, ("clip tower", flags))
    if flags == "taps":
        assert out.attention_probs.shape[-1] == (RES // PATCH) ** 2 + 1


def _student_pair(monkeypatch, **over):
    monkeypatch.delenv("DISTILLCLIP_FLASH", raising=False)
    args = {**STUDENT, **over}
    x = _images()
    jmod = JaxVision(**args)
    params = jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]),
                       JaxFlags())["params"]
    pmod = RepeatVisionTransformer(**args)
    pmod.load_state_dict(jax_student_to_torch(params, "image"))
    return jmod, params, pmod, x


@pytest.mark.parametrize("flags", ["none", "taps"])
def test_head_transform_student_past_256_tokens_matches_jax_fp32(flags, monkeypatch):
    jmod, params, pmod, x = _student_pair(monkeypatch)
    kw = TAP_FLAGS if flags == "taps" else {}
    ref = jmod.apply({"params": params}, jnp.asarray(x), JaxFlags(**kw))
    with torch.no_grad():
        out = pmod(torch.from_numpy(x), ControlFlags(**kw))
    _assert_fields_close(out, ref, ("head-transform student", flags))


@pytest.mark.parametrize("use_transform", [True, False], ids=["head_transform", "plain"])
def test_student_gradients_past_256_tokens_match_jax_fp32(use_transform, monkeypatch):
    """d(Σ pooled · c)/dθ for every parameter, c a fixed numpy cotangent."""
    jmod, params, pmod, x = _student_pair(monkeypatch, use_transform=use_transform)
    cot = np.random.default_rng(3).normal(size=(B, OUT)).astype(np.float32)

    def jax_loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), JaxFlags())
        pooled = out if not hasattr(out, "last_representation") else out.last_representation
        return jnp.sum(pooled * cot)

    ref = jax_student_to_torch(jax.grad(jax_loss)(params), "image")
    (_pooled(pmod(torch.from_numpy(x))) * torch.from_numpy(cot)).sum().backward()
    got = {k: p.grad for k, p in pmod.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = r.numpy()
        assert got[k] is not None, k
        err = np.abs(got[k].numpy() - r).max()
        assert err <= REL * max(np.abs(r).max(), 1e-6), (k, err)
    if use_transform:
        assert float(np.abs(ref["blocks.0.attn.conv_l"].numpy()).max()) > 0


# -- the published geometries -----------------------------------------------------

# preset -> (tokens, vision heads, text heads, embedding width)
GEOMETRY = {"ViT-B/16": (197, 12, 8, 512), "ViT-L/14": (257, 16, 12, 768),
            "ViT-L/14@336px": (577, 16, 12, 768)}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_preset_shapes_are_the_published_geometry(name):
    """At a cut depth (one layer a tower): the tensors' shapes and what the
    port's loader infers from them."""
    tokens, v_heads, t_heads, embed = GEOMETRY[name]
    geo = fabricate_teacher.PRESETS[name]
    sd = fabricate_teacher.preset_state_dict(name, vision_layers=1, text_layers=1)
    P, W, T = geo["patch_size"], geo["vision_width"], geo["text_width"]
    assert sd["visual.conv1.weight"].shape == (W, 3, P, P)
    assert sd["visual.positional_embedding"].shape == (tokens, W)
    assert sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape == (3 * W, W)
    assert sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape == (4 * W, W)
    assert sd["visual.proj"].shape == (W, embed)
    assert sd["token_embedding.weight"].shape == (49408, T)
    assert sd["positional_embedding"].shape == (77, T)
    assert sd["text_projection"].shape == (T, embed)
    vis, txt = get_visual_para(sd), get_transformer_para(sd)
    assert (vis["width"], vis["heads"], vis["patch_size"], vis["layers"]) == (W, v_heads, P, 1)
    assert vis["input_resolution"] == geo["image_resolution"]
    assert (txt["width"], txt["heads"], txt["output_dim"]) == (T, t_heads, embed)


def test_preset_cli_writes_the_geometry(tmp_path):
    out = tmp_path / "b16.pt"
    fabricate_teacher.main(["--out", str(out), "--preset", "ViT-B/16", "--vision-layers", "1",
                            "--text-layers", "1", "--seed", "3"])
    sd = torch.load(str(out))
    ref = fabricate_teacher.preset_state_dict("ViT-B/16", seed=3, vision_layers=1, text_layers=1)
    assert set(sd) == set(ref) and all(torch.equal(sd[k], ref[k]) for k in ref)
    assert fabricate_teacher.PRESETS["ViT-L/14"]["vision_layers"] == 24
    with pytest.raises(ValueError, match="unknown preset"):
        fabricate_teacher.preset_state_dict("ViT-H/14")
