"""The taps of the port's towers against the JAX package, on the CPU.

Every ``ControlFlags`` switch on every tower: both families of students (the
weight-share towers with and without head mixes, the plain CLIP encoders with
their width projections and cleaned scores), and the CLIP teacher towers with
``need_layers``.  The JAX tower initialises the parameters, which cross through
``convert``; both see the same numpy-seeded inputs.  fp32 comparisons run the
JAX towers on their XLA path (DISTILLCLIP_FLASH=0) and hold every returned
field to 1e-4 of its largest entry; the bf16 cases run them through the Pallas
kernels in interpret mode (``need_rep`` takes the ``[B, H, N, d]`` attention
kernels there) and hold the fields to 3e-2 of their largest entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models import teacher as jax_teacher
from distillclip_tpu.models.encoders import ImageEncoder as JaxImageEncoder
from distillclip_tpu.models.encoders import TextEncoder as JaxTextEncoder
from distillclip_tpu.training.train_state import cast_to_compute as jax_cast
from distillclip_tpu_torch.convert import jax_encoder_to_torch, jax_student_to_torch
from distillclip_tpu_torch.models import (
    ControlFlags,
    ImageEncoder,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    TextEncoder,
    teacher,
)
from distillclip_tpu_torch.models.encoders import clean_masked_scores, projections_for
from distillclip_tpu_torch.training.train_state import cast_to_compute

from test_teacher import CTX, PATCH, RES, VOCAB, _make_state_dict

B, OUT = 3, 24
FIELDS = ("last_representation", "last_layer_output", "attention_scores", "attention_probs",
          "representations", "value_map", "embedding")
FLAGS = {
    "emb": dict(need_emb=True), "score": dict(need_attn_score=True),
    "prob": dict(need_attn_prob=True), "value_map": dict(need_value_map=True),
    "rep": dict(need_rep=True), "last_layer": dict(need_last_layer=True),
    "rep_emb": dict(need_rep=True, need_emb=True),
    "all": dict(need_emb=True, need_attn_score=True, need_attn_prob=True, need_value_map=True,
                need_rep=True, need_last_layer=True),
}
SHARE_IMAGE = dict(img_size=RES, patch_size=PATCH, out_dim=OUT, embed_dim=32, depth=4,
                   num_heads=4, repeated_times=2, qkv_bias=True, use_transform=True)
SHARE_TEXT = dict(vocab_size=VOCAB, context_length=CTX, out_dim=OUT, embed_dim=32, depth=2,
                  num_heads=2, repeated_times=2, use_transform=True)
ENC_IMAGE = dict(is_student=True, input_resolution=RES, patch_size=PATCH, width=32, layers=3,
                 heads=2, output_dim=OUT, need_layers=(0, 2), teacher_width=48)
ENC_TEXT = dict(is_student=True, vocab_size=VOCAB, context_length=CTX, width=32, layers=2,
                heads=2, output_dim=OUT, need_layers=(1,), teacher_width=48)
# tower -> (JAX class, port class, arguments, converter's tower, image or text input)
TOWERS = {
    "share_image": (JaxVision, RepeatVisionTransformer, SHARE_IMAGE, "image"),
    "plain_share_image": (JaxVision, RepeatVisionTransformer,
                          dict(SHARE_IMAGE, use_transform=False), "image"),
    "share_text": (JaxText, RepeatTextTransformer, SHARE_TEXT, "text"),
    "encoder_image": (JaxImageEncoder, ImageEncoder, ENC_IMAGE, "image"),
    "encoder_text": (JaxTextEncoder, TextEncoder, ENC_TEXT, "text"),
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return {"image": rng.normal(size=(B, RES, RES, 3)).astype(np.float32), "text": toks}


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


def _port_input(x):
    t = torch.from_numpy(x)
    return t if t.is_floating_point() else t.long()


def _assert_fields_close(out, ref, rel, what):
    if isinstance(out, torch.Tensor):          # a weight-share tower under the default flags
        out = dataclasses.make_dataclass("Pooled", ["last_representation"])(out)
    for field in FIELDS:
        r = getattr(ref, field)
        o = getattr(out, field, None)
        if r is None:
            assert o is None, (what, field)
            continue
        if o is None and field == "last_layer_output":
            continue
        r = np.asarray(r.astype(jnp.float32))
        assert o is not None and tuple(o.shape) == r.shape, (what, field)
        err = np.abs(o.detach().float().numpy() - r).max()
        assert err <= rel * max(np.abs(r).max(), 1e-6), (what, field, err)


def _pair(kind, flags_kw, inputs):
    """(JAX tower, its params, port tower loaded with them, the input)."""
    jcls, pcls, args, tower = TOWERS[kind]
    x = inputs[tower]
    jmod = jcls(**args)
    params = jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]),
                       JaxFlags(**flags_kw))["params"]
    if kind.startswith("encoder"):
        state = jax_encoder_to_torch(params, tower)
        pmod = pcls(**args, **projections_for(ControlFlags(**flags_kw)))
    else:
        state = jax_student_to_torch(params, tower)
        pmod = pcls(**args)
    pmod.load_state_dict(state)
    return jmod, params, pmod.eval(), x


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("kind", list(TOWERS))
def test_student_taps_match_jax_fp32(kind, flag, inputs, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jmod, params, pmod, x = _pair(kind, FLAGS[flag], inputs)
    ref = jmod.apply({"params": params}, jnp.asarray(x), JaxFlags(**FLAGS[flag]))
    with torch.no_grad():
        out = pmod(_port_input(x), ControlFlags(**FLAGS[flag]))
    _assert_fields_close(out, ref, 1e-4, (kind, flag))
    if kind.startswith("encoder") and flag in ("rep", "all"):
        assert out.representations.shape[-1] == 48           # projected to the teacher's width
        assert out.representations.shape[0] == len(TOWERS[kind][2]["need_layers"])
    if kind.startswith("share") and flag in ("rep", "all"):
        assert out.representations.shape[0] == TOWERS[kind][2]["depth"]   # every repeat


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("model_type,layers", [("image", (0, 2)), ("text", (1,)),
                                               ("image", None)],
                         ids=["image_0_2", "text_1", "image_all_layers"])
def test_teacher_taps_match_jax_fp32(model_type, layers, flag, ckpt_path, inputs, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jmod, jvars = jax_teacher.teacher_load(ckpt_path, None, model_type, need_layers=layers)
    pmod = teacher.teacher_load(ckpt_path, None, model_type, need_layers=layers, device="cpu")
    x = inputs[model_type]
    ref = jmod.apply(jvars, jnp.asarray(x), JaxFlags(**FLAGS[flag]))
    with torch.no_grad():
        out = pmod(_port_input(x), ControlFlags(**FLAGS[flag]))
    _assert_fields_close(out, ref, 1e-4, (model_type, flag))
    if flag in ("score", "all") and model_type == "text":
        # the causal mask's -1e9 entries reach a loss as zeros
        assert float(out.attention_scores.min()) > -1e8
        assert float(out.attention_scores[0, 0, 0, 0, 1:].abs().sum()) == 0.0


@pytest.mark.parametrize("kind", list(TOWERS))
@pytest.mark.parametrize("flag", ["rep", "all"])
def test_student_taps_match_jax_bf16_compute(kind, flag, inputs):
    """bf16 compute: under ``need_rep`` the JAX towers reach the
    ``[B, H, N, d]`` attention kernels (plain and head-transform) in interpret
    mode, under all flags the materialised fp32 path."""
    jmod, params, pmod, x = _pair(kind, FLAGS[flag], inputs)
    xj = jnp.asarray(x, jnp.bfloat16) if x.dtype == np.float32 else jnp.asarray(x)
    ref = jmod.apply({"params": jax_cast(params, jnp.bfloat16)}, xj, JaxFlags(**FLAGS[flag]))
    state = cast_to_compute({k: v for k, v in pmod.state_dict().items()}, torch.bfloat16)
    xp = _port_input(x)
    xp = xp.to(torch.bfloat16) if xp.is_floating_point() else xp
    with torch.no_grad():
        out = torch.func.functional_call(pmod, state, (xp, ControlFlags(**FLAGS[flag])))
    assert out.last_representation.dtype == torch.bfloat16
    if flag == "all":
        assert out.attention_probs.dtype == out.attention_scores.dtype == torch.float32
        assert out.value_map.dtype == torch.float32
    _assert_fields_close(out, ref, 3e-2, (kind, flag))


def test_clean_masked_scores_zeroes_only_the_mask():
    s = torch.tensor([[0.5, -1e9], [-2e9, -3.0]])
    assert clean_masked_scores(s).tolist() == [[0.5, 0.0], [0.0, -3.0]]
    assert clean_masked_scores(None) is None


def test_kv_len_masks_the_taps_as_in_jax(inputs):
    """``kv_len`` never arises in the port's towers (they run at the true N);
    the attention modules keep it, with the JAX package's additive mask."""
    from distillclip_tpu_torch.models.layers import InstrumentedAttention, LayerNorm, key_mask
    from distillclip_tpu_torch.serving.lclip_score import seeded_init
    attn = seeded_init(InstrumentedAttention(32, 2), np.random.default_rng(0)).eval()
    ln = LayerNorm(32)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2 * 6, 32)).astype(np.float32))
    flags = ControlFlags(need_attn_score=True, need_attn_prob=True)
    with torch.no_grad():
        out = attn(x, flags, ln, 6, causal=True, kv_len=4)
        lean = attn(x, ControlFlags(), ln, 6, causal=True, kv_len=4)
        rep = attn(x, ControlFlags(need_rep=True), ln, 6, causal=True, kv_len=4)
    assert float(out.attention_probs[..., 4:].abs().max()) == 0.0
    assert float(out.attention_scores[0, 0, 0, 5]) == -2e9          # both masks add
    assert key_mask(6, False, None, "cpu") is None
    torch.testing.assert_close(out.hidden, lean.hidden, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.hidden, rep.hidden, atol=1e-5, rtol=1e-5)
