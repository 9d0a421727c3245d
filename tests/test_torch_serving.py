"""Parity of the PyTorch port's serving slice (distillclip_tpu_torch) with the
JAX package on the CPU: tiny weight-share student towers built and
initialised in JAX, converted with ``jax_student_to_torch``, and run through
both packages on the same numpy inputs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.serving import LCLIPScorer as JaxScorer
from distillclip_tpu.training import train_state as jax_train_state
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.convert import _torch_name, jax_student_to_torch
from distillclip_tpu_torch.models import ControlFlags, RepeatTextTransformer, RepeatVisionTransformer
from distillclip_tpu_torch.serving import LCLIPScorer, cast_to_compute, prepare_inputs
from distillclip_tpu_torch.serving.lclip_score import seeded_init

RES, CTX, VOCAB, B = 16, 9, 64, 3
IMAGE_ARGS = dict(img_size=RES, patch_size=8, out_dim=24, embed_dim=32, depth=4, num_heads=4,
                  repeated_times=2, qkv_bias=True, use_transform=True)
TEXT_ARGS = dict(vocab_size=VOCAB, context_length=CTX, out_dim=24, embed_dim=32, depth=2,
                 num_heads=4, repeated_times=2, use_transform=True)
TEXT_COMPRESSED = dict(TEXT_ARGS, compression_embedding=True, embedding_compression_dim=16)


def _images(seed=0, n=B):
    return np.random.default_rng(seed).integers(0, 256, size=(n, RES, RES, 3), dtype=np.uint8)


def _tokens(seed=0, n=B):
    """SOT-like start, random ids, the largest id (EOT) at varied positions,
    then zeros."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, CTX), np.int32)
    for i in range(n):
        length = 3 + i % (CTX - 2)
        toks[i, 0] = VOCAB - 2
        toks[i, 1:length - 1] = rng.integers(1, VOCAB - 2, size=length - 2)
        toks[i, length - 1] = VOCAB - 1
    return toks


def _normalized(u8):
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    return (u8.astype(np.float32) / 255.0 - mean) / std


def _jax_tower(cls, args, x, seed):
    module = cls(**args)
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), JaxFlags())["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def image_tower():
    return _jax_tower(JaxVision, IMAGE_ARGS, _normalized(_images()), 0)


@pytest.fixture(scope="module")
def text_towers():
    """{"plain": ..., "compressed": ...} JAX text students."""
    return {"plain": _jax_tower(JaxText, TEXT_ARGS, _tokens(), 1),
            "compressed": _jax_tower(JaxText, TEXT_COMPRESSED, _tokens(), 2)}


def _port_tower(cls, args, params, tower):
    module = cls(**args)
    module.load_state_dict(jax_student_to_torch(params, tower), strict=True)
    return module.eval()


def _port_scorer(image_tower, text_tower, text_args, dtype):
    return LCLIPScorer(_port_tower(RepeatVisionTransformer, IMAGE_ARGS, image_tower[1], "image"),
                       _port_tower(RepeatTextTransformer, text_args, text_tower[1], "text"),
                       device="cpu", dtype=dtype)


def _jax_scorer(image_tower, text_tower, dtype):
    return JaxScorer(image_module=image_tower[0], image_vars={"params": image_tower[1]},
                     text_module=text_tower[0], text_vars={"params": text_tower[1]},
                     tokenizer=None, image_size=RES, context_length=CTX, compute_dtype=dtype)


# -- towers and scores against the JAX package --------------------------------

def test_image_tower_matches_jax_xla_fp32(image_tower, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    x = _normalized(_images(3))
    ref = image_tower[0].apply({"params": image_tower[1]}, jnp.asarray(x), JaxFlags())
    port = _port_tower(RepeatVisionTransformer, IMAGE_ARGS, image_tower[1], "image")
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref.last_representation), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_text_tower_matches_jax_xla_fp32(text_towers, kind, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    module, params = text_towers[kind]
    toks = _tokens(4, n=5)
    ref = module.apply({"params": params}, jnp.asarray(toks), JaxFlags())
    args = TEXT_ARGS if kind == "plain" else TEXT_COMPRESSED
    port = _port_tower(RepeatTextTransformer, args, params, "text")
    with torch.inference_mode():
        out = port(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(out, np.asarray(ref.last_representation), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_fp32_scorer_matches_jax_xla(image_tower, text_towers, kind, monkeypatch):
    """Unit features and per-pair scores in fp32 against the JAX scorer on its
    XLA path (same parameter tree): 1e-4."""
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    args = TEXT_ARGS if kind == "plain" else TEXT_COMPRESSED
    port = _port_scorer(image_tower, text_towers[kind], args, torch.float32)
    ref = _jax_scorer(image_tower, text_towers[kind], jnp.float32)
    images, tokens = _images(5), _tokens(5)
    np.testing.assert_allclose(port.encode_images(images), ref.encode_images(images),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.encode_tokens(tokens), ref.encode_tokens(tokens),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.score_tokens(images, tokens),
                               ref.score_tokens(images, tokens), atol=1e-4, rtol=0)


def test_bf16_scorer_matches_jax_scorer(image_tower, text_towers):
    """bf16 on both sides (the JAX scorer through its interpret-mode
    kernels): 2e-2, the bf16 precedent of test_serving.py."""
    port = _port_scorer(image_tower, text_towers["plain"], TEXT_ARGS, torch.bfloat16)
    ref = _jax_scorer(image_tower, text_towers["plain"], jnp.bfloat16)
    images, tokens = _images(6), _tokens(6)
    np.testing.assert_allclose(port.encode_images(images), ref.encode_images(images),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(port.encode_tokens(tokens), ref.encode_tokens(tokens),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(port.score_tokens(images, tokens),
                               ref.score_tokens(images, tokens), atol=2e-2, rtol=0)


# -- the port's scorer on its own ---------------------------------------------

@pytest.fixture(scope="module")
def bf16_scorer(image_tower, text_towers):
    return _port_scorer(image_tower, text_towers["compressed"], TEXT_COMPRESSED, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_uint8_matches_normalized_float(image_tower, text_towers, dtype):
    scorer = _port_scorer(image_tower, text_towers["plain"], TEXT_ARGS, dtype)
    u8, tokens = _images(7), _tokens(7)
    s_u8 = scorer.score_tokens(u8, tokens)
    s_f32 = scorer.score_tokens(_normalized(u8), tokens)
    np.testing.assert_allclose(s_u8, s_f32, atol=1e-6, rtol=0)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_matches_serial(bf16_scorer, depth):
    batches = [(_images(10 + i, n=2 + i), _tokens(10 + i, n=2 + i)) for i in range(4)]
    streamed = list(bf16_scorer.score_tokens_stream(iter(batches), depth=depth))
    serial = [bf16_scorer.score_tokens(*b) for b in batches]
    assert len(streamed) == len(serial)
    for s, r in zip(streamed, serial):
        np.testing.assert_array_equal(s, r)


def test_stream_refuses_zero_depth(bf16_scorer):
    with pytest.raises(ValueError, match="depth"):
        next(bf16_scorer.score_tokens_stream([], depth=0))


def test_similarity_matrix_diagonal_is_score_tokens(bf16_scorer):
    images, tokens = _images(8), _tokens(8)
    # the token-level form; the public similarity_matrix takes captions, as
    # the JAX package's does (tests/test_torch_score_cli.py)
    sim = bf16_scorer._similarity_matrix_tokens(images, tokens)
    assert sim.shape == (B, B)
    np.testing.assert_allclose(np.diagonal(sim), bf16_scorer.score_tokens(images, tokens),
                               atol=1e-6, rtol=0)
    feats = bf16_scorer.encode_images(images)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)


def test_score_tokens_refuses_unaligned_pairs(bf16_scorer):
    with pytest.raises(ValueError, match="aligned pairs"):
        bf16_scorer.score_tokens(_images(9, n=2), _tokens(9, n=3))


def test_cpu_scorer_launches_no_kernel(bf16_scorer):
    ops.reset_launch_counts()
    bf16_scorer.score_tokens(_images(), _tokens())
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# -- from_config ----------------------------------------------------------------

def _config(tmp_path, text_args):
    cfg = {"model": {"class_path": "DualDistillModel", "init_args": {
        "image_student": {
            "class_path": "model.component.weight_share_model.RepeatVisionTransformer",
            "init_args": IMAGE_ARGS},
        "text_student": {
            "class_path": "model.component.weight_share_model.RepeatTextTransformer",
            "init_args": text_args}}}}
    path = tmp_path / "lclip.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_from_config_with_converted_params_matches_jax(image_tower, text_towers, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    scorer = LCLIPScorer.from_config(
        _config(tmp_path, TEXT_COMPRESSED),
        image_params=jax_student_to_torch(image_tower[1], "image"),
        text_params=jax_student_to_torch(text_towers["compressed"][1], "text"),
        device="cpu", dtype=torch.float32)
    ref = _jax_scorer(image_tower, text_towers["compressed"], jnp.float32)
    images, tokens = _images(11), _tokens(11)
    np.testing.assert_allclose(scorer.score_tokens(images, tokens),
                               ref.score_tokens(images, tokens), atol=1e-4, rtol=0)


def test_from_config_seeded_init(tmp_path):
    path = _config(tmp_path, TEXT_ARGS)
    a, b, c = (LCLIPScorer.from_config(path, device="cpu", dtype=torch.float32, seed=s)
               for s in (0, 0, 1))
    images, tokens = _images(12), _tokens(12)
    np.testing.assert_array_equal(a.score_tokens(images, tokens), b.score_tokens(images, tokens))
    assert not np.array_equal(a.encode_images(images), c.encode_images(images))
    # the rules of the towers' init: LN scale 1 and biases 0, weights ~0.02
    state = a.image_tower.state_dict()
    assert torch.all(state["norm.scale"] == 1) and torch.all(state["blocks.0.mlp.fc1.bias"] == 0)
    assert 0.015 < float(state["blocks.0.mlp.fc1.kernel"].std()) < 0.02


def test_from_config_reads_the_final_config():
    """configs/final/l_clip.yaml builds at full width; only the shapes are
    checked (no forward at this size on the CPU)."""
    with open(Path(__file__).resolve().parent.parent / "configs/final/l_clip.yaml") as f:
        init_args = yaml.safe_load(f)["model"]["init_args"]
    from distillclip_tpu_torch.serving.lclip_score import build_tower

    image = build_tower(init_args["image_student"])
    text = build_tower(init_args["text_student"])
    assert image.pos_embed.shape == (1, 50, 768) and len(image.blocks) == 3
    assert image.blocks[0].attn.conv_l.shape == (2, 24, 24)
    assert image.blocks[0].attn.qkv.bias is not None
    assert text.pos_embed.shape == (77, 768) and len(text.blocks) == 2
    assert text.blocks[0].attn.qkv.bias is None
    assert text.patch_embed.embed.embedding.shape == (49408, 768)


def test_unknown_tower_class_is_refused():
    from distillclip_tpu_torch.serving.lclip_score import build_tower

    with pytest.raises(NotImplementedError, match="is not a student tower of the configs"):
        build_tower({"class_path": "model.component.clip_model.CLIPModel", "init_args": {}})


# -- inputs, cast, converter ------------------------------------------------------

def test_prepare_inputs_matches_jax():
    u8 = _images(13)
    ref = np.asarray(jax_train_state.prepare_inputs(jnp.asarray(u8), jnp.float32))
    out = prepare_inputs(torch.from_numpy(u8), torch.float32).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    f = _normalized(u8)
    assert prepare_inputs(torch.from_numpy(f), torch.bfloat16).dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens())
    assert prepare_inputs(toks, torch.bfloat16) is toks


def test_cast_to_compute_matches_jax(text_towers):
    """The same leaves stay fp32 on both sides: the vocab table (>= 16384
    rows) only.  A tiny vocab is under the cut, so widen it for this check."""
    module, params = text_towers["plain"]
    params = dict(params, patch_embed={"embed": {"embedding": np.zeros((16384, 32), np.float32)}})
    leaves = jax.tree_util.tree_flatten_with_path(jax_train_state.cast_to_compute(params))[0]
    ref = {_torch_name("/".join(str(k.key) for k in path)): str(v.dtype) for path, v in leaves}
    port = RepeatTextTransformer(**dict(TEXT_ARGS, vocab_size=16384))
    cast_to_compute(port, torch.bfloat16)
    got = {k: str(p.dtype).replace("torch.", "") for k, p in port.named_parameters()}
    assert got == ref
    assert got["patch_embed.embed.embedding"] == "float32" and got["blocks.0.attn.conv_l"] == "bfloat16"


def test_converter_accepts_nested_and_flat_trees(image_tower):
    nested = jax_student_to_torch({"params": image_tower[1]}, "image")
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(image_tower[1])[0]}
    assert set(jax_student_to_torch(flat, "image")) == set(nested)
    assert nested["blocks.1.norm2.1.scale"].shape == (32,)
    assert nested["blocks.0.attn.qkv.kernel"].shape == (32, 96)  # [in, out] kept
    with pytest.raises(ValueError, match="not a JAX text student"):
        jax_student_to_torch(image_tower[1], "text")
    with pytest.raises(ValueError, match="tower must be"):
        jax_student_to_torch(image_tower[1], "audio")


# -- what the slice does not serve yet -------------------------------------------

def test_unported_paths_raise():
    plain = RepeatVisionTransformer(**dict(IMAGE_ARGS, use_transform=False))
    assert not any("conv_" in k for k in plain.state_dict())     # plain attention: no mixes
    # iRPE needs skip + a square grid of tokens: the text tower's 9 are not
    with pytest.raises(ValueError, match="not a square grid"):
        RepeatTextTransformer(**dict(TEXT_ARGS, rpe_config={"method": "product"}))
    # drop-path and the taps are served: in training mode the first changes
    # the output, and a flag turns the pooled tensor into the output container
    tower = seeded_init(RepeatTextTransformer(**dict(TEXT_ARGS, drop_path_rate=0.5)),
                        np.random.default_rng(0))
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        pooled = tower.eval()(toks)
        assert not torch.equal(tower.train()(toks, ControlFlags(),
                                             torch.Generator().manual_seed(0)), pooled)
        out = tower.eval()(toks, ControlFlags(need_emb=True))
    assert torch.equal(out.last_representation, pooled)
    assert out.embedding.shape == (len(toks), TEXT_ARGS["context_length"],
                                   TEXT_ARGS["embed_dim"])
