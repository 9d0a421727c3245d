"""iRPE in the port against the JAX package, on the CPU.

The bucket ids (host math) must equal JAX's exactly; the encodings on keys,
queries and values, applied by gather and scatter in the port and by one-hot
contractions in JAX, must agree to 1e-5 with seeded non-zero tables; a small
weight-share ViT with relative position tables on q, k and v must give JAX's
outputs, taps and gradients (the tables' included) to 1e-5 in fp32, the JAX
tower on its XLA path (DISTILLCLIP_FLASH=0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.models import RepeatTextTransformer as JaxText
from distillclip_tpu.models import RepeatVisionTransformer as JaxVision
from distillclip_tpu.models import irpe as jax_irpe
from distillclip_tpu_torch.convert import jax_student_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.models import (
    ControlFlags,
    RepeatTextTransformer,
    RepeatVisionTransformer,
    irpe,
)

ALL = dict(need_emb=True, need_attn_score=True, need_attn_prob=True, need_value_map=True,
           need_rep=True, need_last_layer=True)
FIELDS = ("last_representation", "last_layer_output", "attention_scores", "attention_probs",
          "representations", "value_map", "embedding")
# 24 px / patch 8: a 3 x 3 grid and the cls token; two blocks run twice each
VIT = dict(img_size=24, patch_size=8, out_dim=8, embed_dim=32, depth=4, num_heads=4,
           repeated_times=2, qkv_bias=True, use_transform=True)


@pytest.mark.parametrize("grid", [3, 7])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("method", ["product", "euc", "quant", "cross_rows", "cross_cols"])
def test_bucket_ids_equal_jax(method, skip, grid):
    cfg = irpe.RpeConfig(skip=skip)
    args = (method, grid, grid, skip, cfg.alpha, cfg.beta, cfg.gamma)
    ids, num = irpe.bucket_ids_2d(*args)
    ref_ids, ref_num = jax_irpe.bucket_ids_2d(*args)
    assert num == ref_num and ids.dtype == ref_ids.dtype
    np.testing.assert_array_equal(ids, ref_ids)
    assert ids.min() >= 0 and ids.max() < num


def _tables(cfg, H, d, rng):
    """Seeded non-zero tables of both packages' shapes for one attention."""
    shapes = irpe.table_shapes(cfg, d, H, repeats=2)
    return {name: rng.normal(size=shape).astype(np.float32) for name, shape in shapes.items()}


@pytest.mark.parametrize("shared_head", [True, False])
@pytest.mark.parametrize("mode,method,rpe_on", [
    ("contextual", "product", "qkv"), ("contextual", "cross", "qkv"),
    ("bias", "product", "qk"), ("bias", "euc", "qk")])
def test_encodings_equal_jax(mode, method, rpe_on, shared_head):
    cfg = irpe.RpeConfig(method=method, mode=mode, shared_head=shared_head, rpe_on=rpe_on)
    jcfg = jax_irpe.RpeConfig(method=method, mode=mode, shared_head=shared_head, rpe_on=rpe_on)
    B, H, d, L = 2, 3, 4, 10
    rng = np.random.default_rng(0)
    tables = _tables(cfg, H, d, rng)
    key = "bias" if mode == "bias" else "weight"
    pick = lambda t, which: t.get(f"rpe_{which}_{key}" if which != "v" else "rpe_v_weight")
    port = irpe.RpeParams(cfg, L, H, d, **{
        f"{w}_table": None if pick(tables, w) is None else torch.from_numpy(pick(tables, w))
        for w in "qkv"})
    ref = jax_irpe.RpeParams(jcfg, L, H, d, **{
        f"{w}_table": None if pick(tables, w) is None else jnp.asarray(pick(tables, w))
        for w in "qkv"})
    q, k = (rng.normal(size=(B, H, L, d)).astype(np.float32) for _ in range(2))
    attn = rng.normal(size=(B, H, L, L)).astype(np.float32)
    for r in (0, 1):
        for fn, x in ((irpe.rpe_on_keys, q), (irpe.rpe_on_queries, k),
                      (irpe.rpe_on_values, attn)):
            got = fn(port, r, torch.from_numpy(x)).numpy()
            want = np.asarray(getattr(jax_irpe, fn.__name__)(ref, r, jnp.asarray(x)))
            assert got.shape == want.shape, fn.__name__
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=fn.__name__)


def _jax_tower(rpe_kw, rng):
    """A JAX ViT with iRPE whose tables are seeded non-zero values."""
    jmod = JaxVision(rpe_config=jax_irpe.RpeConfig(**rpe_kw), **VIT)
    images = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]), JaxFlags())["params"]
    flat = flatten_dict(params)
    for path, v in flat.items():
        if path[-1].startswith("rpe_"):
            flat[path] = jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3)
    return jmod, unflatten_dict(flat), images


def _loss_terms(out):
    """Every returned field; the loss is the sum of their means through a sine."""
    return [getattr(out, f) for f in FIELDS]


@pytest.mark.parametrize("rpe_kw", [
    dict(method="product", mode="contextual", shared_head=False, rpe_on="qkv"),
    dict(method="cross", mode="bias", shared_head=True, rpe_on="qk")],
    ids=["product_contextual_qkv", "cross_bias_qk"])
def test_tower_outputs_taps_and_gradients_equal_jax(rpe_kw, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    rng = np.random.default_rng(1)
    jmod, params, images = _jax_tower(rpe_kw, rng)
    flat = {"/".join(k): v for k, v in flatten_dict(params).items()}
    state = jax_student_to_torch(params, "image")
    assert any(k.endswith(".attn.rpe_k_" + ("weight" if rpe_kw["mode"] == "contextual"
                                            else "bias")) for k in state)
    assert {torch_name_to_jax_path(k) for k in state} == set(flat)
    pmod = RepeatVisionTransformer(rpe_config=rpe_kw, **VIT)
    pmod.load_state_dict(state, strict=True)

    def jax_out(p):
        return jmod.apply({"params": p}, jnp.asarray(images), JaxFlags(**ALL))

    ref = jax.jit(jax_out)(params)
    with torch.no_grad():
        out = pmod.eval()(torch.from_numpy(images), ControlFlags(**ALL))
    for field in FIELDS:
        r = np.asarray(getattr(ref, field))
        o = getattr(out, field).numpy()
        assert o.shape == r.shape, field
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-5, err_msg=field)

    def jax_loss(p):
        return sum(jnp.mean(jnp.sin(t)) for t in _loss_terms(jax_out(p)))

    ref_grads = {"/".join(k): np.asarray(v)
                 for k, v in flatten_dict(jax.jit(jax.grad(jax_loss))(params)).items()}
    leaves = dict(pmod.named_parameters())
    out = pmod(torch.from_numpy(images), ControlFlags(**ALL))
    loss = sum(torch.sin(t).mean() for t in _loss_terms(out))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    rpe_leaves = 0
    for (name, _), g in zip(leaves.items(), grads):
        want = ref_grads[torch_name_to_jax_path(name)]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5, err_msg=name)
        rpe_leaves += "rpe_" in name
        if "rpe_" in name:
            assert np.abs(want).max() > 0, name
    assert rpe_leaves == 2 * len(rpe_kw["rpe_on"])            # two blocks


def test_rpe_is_exact_noop_at_zero_init():
    """Zero tables: the iRPE tower computes what the tower without it computes
    on the same shared weights (JAX's test_rpe_is_exact_noop_at_zero_init)."""
    from distillclip_tpu_torch.serving.lclip_score import seeded_init

    kw = dict(VIT, img_size=16)
    base = seeded_init(RepeatVisionTransformer(**kw), np.random.default_rng(7))
    with_rpe = seeded_init(RepeatVisionTransformer(rpe_config=irpe.RpeConfig(rpe_on="qkv"), **kw),
                           np.random.default_rng(3))
    shared = base.state_dict()
    extra = {k: v for k, v in with_rpe.state_dict().items() if k not in shared}
    assert extra and all(k.rsplit(".", 1)[1].startswith("rpe_") and not v.any()
                         for k, v in extra.items())
    with_rpe.load_state_dict({**shared, **extra}, strict=True)
    images = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 16, 3))
                              .astype(np.float32))
    with torch.no_grad():
        a = with_rpe.eval()(images, ControlFlags(**ALL))
        b = base.eval()(images, ControlFlags(**ALL))
    assert torch.equal(a.last_representation, b.last_representation)
    assert torch.equal(a.attention_scores, b.attention_scores)


def test_text_student_and_bias_values_raise_as_jax():
    """77 tokens after the EOT-free skip token are no square grid: JAX's tower
    raises at its first call, the port's when it is built, with JAX's text;
    values in bias mode are refused by both."""
    cfg = dict(method="product", mode="contextual", rpe_on="qkv")
    jmod = JaxText(vocab_size=64, context_length=77, out_dim=8, embed_dim=32, depth=2,
                   num_heads=4, repeated_times=2, rpe_config=jax_irpe.RpeConfig(**cfg))
    with pytest.raises(ValueError) as jax_err:
        jmod.init(jax.random.PRNGKey(0), jnp.ones((1, 77), jnp.int32), JaxFlags())
    with pytest.raises(ValueError) as port_err:
        RepeatTextTransformer(vocab_size=64, context_length=77, out_dim=8, embed_dim=32,
                              depth=2, num_heads=4, repeated_times=2, rpe_config=cfg)
    assert str(port_err.value) == str(jax_err.value) == \
        "seq_len 77 minus skip 1 is not a square grid"
    with pytest.raises(NotImplementedError, match="bias non-transposed"):
        RepeatVisionTransformer(rpe_config=dict(mode="bias", rpe_on="v"), **VIT)
    with pytest.raises(ValueError, match="mode must be one of"):
        irpe.RpeConfig(mode="ctx")
    assert irpe.rpe_config_from_dict(None) is None
    assert irpe.rpe_config_from_dict({"ratio": 2.0}).num_buckets() == jax_irpe.RpeConfig(
        ratio=2.0).num_buckets()
