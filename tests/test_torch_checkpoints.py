"""The port's checkpoints (``training.checkpoints``): round trip, the JAX
package's key stripping, ``tower=`` selection and structure checks; and a JAX
Orbax stage checkpoint crossing to the port (the JAX ``restore_pytree``, then
``convert``, then the port's ``save_pytree``) to score through
``LCLIPScorer.from_checkpoints`` as the JAX scorer does on the original: bf16
scores within 2e-2 (the bf16 class), fp32 features of the port against the JAX
towers' XLA math within 1e-4.
"""

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
from distillclip_tpu.training.checkpoints import restore_pytree as jax_restore
from distillclip_tpu.training.checkpoints import save_pytree as jax_save
from distillclip_tpu_torch.convert import jax_dual_params_to_torch, jax_student_to_torch
from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
from distillclip_tpu_torch.serving import LCLIPScorer
from distillclip_tpu_torch.training.checkpoints import (
    flatten,
    nest,
    restore_pytree,
    restore_tower_params,
    save_pytree,
)

from test_teacher import CTX, RES, VOCAB
from test_torch_training import _np_tree

IMAGE = dict(img_size=RES, patch_size=8, out_dim=48, embed_dim=32, depth=2, num_heads=4,
             repeated_times=2, qkv_bias=True)
TEXT = dict(vocab_size=VOCAB, context_length=CTX, out_dim=48, embed_dim=32, depth=2,
            num_heads=4, repeated_times=2)
CAPTIONS = ["a cat", "a dog on grass", "sunset over the sea"]


def _seeded(tower, seed=0):
    from distillclip_tpu_torch.serving.lclip_score import seeded_init
    return seeded_init(tower, np.random.default_rng(seed))


def test_round_trip_keeps_tree_values_and_dtypes(tmp_path):
    tree = {"params": {"student": {"a": torch.randn(3, 4), "b": {"c": torch.arange(5)}}},
            "step": np.asarray(7), "lr": np.float32(0.5)}
    save_pytree(str(tmp_path / "sub" / "ck.pt"), tree)
    back = restore_pytree(str(tmp_path / "sub" / "ck.pt"))
    assert torch.equal(back["params"]["student"]["a"], tree["params"]["student"]["a"])
    assert torch.equal(back["params"]["student"]["b"]["c"], torch.arange(5))
    assert int(back["step"]) == 7 and float(back["lr"]) == 0.5
    # with a template: the template's dtypes
    t = restore_pytree(str(tmp_path / "sub" / "ck.pt"),
                       {"params": {"student": {"a": torch.zeros(3, 4, dtype=torch.float64),
                                               "b": {"c": torch.zeros(5)}}},
                        "step": torch.zeros(()), "lr": torch.zeros(())})
    assert t["params"]["student"]["a"].dtype == torch.float64
    assert list(tmp_path.joinpath("sub").iterdir()) == [tmp_path / "sub" / "ck.pt"]


def test_nest_and_flatten_are_inverse():
    flat = {"blocks.0.attn.qkv.kernel": 1, "blocks.0.norm1.1.scale": 2, "head.bias": 3}
    assert flatten(nest(flat)) == flat
    assert nest(flat)["blocks"]["0"]["norm1"]["1"]["scale"] == 2


@pytest.mark.parametrize("wrap", ["trainer", "stage", "student", "bare"])
def test_restore_tower_params_strips_the_jax_keys(tmp_path, wrap):
    tower = _seeded(RepeatVisionTransformer(**IMAGE))
    state = tower.state_dict()
    inner = nest(state)
    tree = {"trainer": {"state": {"params": {"student": inner}, "opt_state": {}}},
            "stage": {"params": {"student": inner}},
            "student": {"student": inner}, "bare": inner}[wrap]
    save_pytree(str(tmp_path / "ck.pt"), tree)
    template = RepeatVisionTransformer(**IMAGE).state_dict()
    got = restore_tower_params(str(tmp_path / "ck.pt"), template, tower="image_tower")
    assert set(got) == set(state)
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_tower_selects_from_a_stage3_checkpoint(tmp_path):
    img, txt = _seeded(RepeatVisionTransformer(**IMAGE)), _seeded(RepeatTextTransformer(**TEXT), 1)
    masters = {**{f"student.image_tower.{k}": v for k, v in img.state_dict().items()},
               **{f"student.text_tower.{k}": v for k, v in txt.state_dict().items()}}
    save_pytree(str(tmp_path / "dual.pt"), {"params": nest(masters)})
    for tower, module in (("image_tower", img), ("text_tower", txt)):
        got = restore_tower_params(str(tmp_path / "dual.pt"), module.state_dict(), tower=tower)
        assert all(torch.equal(got[k], v) for k, v in module.state_dict().items())
    # without the selection the stage-3 tree is not a tower
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_tower_params(str(tmp_path / "dual.pt"), img.state_dict())


@pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
def test_structure_mismatch_raises(tmp_path, damage):
    state = dict(_seeded(RepeatTextTransformer(**TEXT)).state_dict())
    if damage == "missing":
        state.pop("head.bias")
    elif damage == "extra":
        state["head.extra"] = torch.zeros(2)
    else:
        state["head.kernel"] = torch.zeros(3, 3)
    save_pytree(str(tmp_path / "ck.pt"), {"params": {"student": nest(state)}})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_tower_params(str(tmp_path / "ck.pt"),
                             RepeatTextTransformer(**TEXT).state_dict())


@pytest.fixture(scope="module")
def jax_stage3(tmp_path_factory):
    """A JAX Orbax stage-3 checkpoint of tiny students, and the config YAML."""
    root = tmp_path_factory.mktemp("jax_ck")
    key = jax.random.PRNGKey(0)
    img = JaxVision(**IMAGE).init(key, jnp.zeros((1, RES, RES, 3)), JaxFlags())["params"]
    txt = JaxText(**TEXT).init(key, jnp.ones((1, CTX), jnp.int32), JaxFlags())["params"]
    ck = str(root / "dual_last")
    jax_save(ck, {"state": {"params": {"student": {"image_tower": img, "text_tower": txt}}}})
    cfg = {"model": {"init_args": {
        "image_student": {"class_path": "model.component.weight_share_model."
                                        "RepeatVisionTransformer", "init_args": IMAGE},
        "text_student": {"class_path": "model.component.weight_share_model."
                                       "RepeatTextTransformer", "init_args": TEXT}}}}
    config = str(root / "l_clip.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    return ck, config, img, txt


def _cross(jax_ck, out):
    """The two lines that carry a JAX checkpoint to the port's format."""
    tree = jax_restore(jax_ck)
    save_pytree(out, {"params": nest(jax_dual_params_to_torch(_np_tree(tree["state"]["params"])))})
    return out


def test_jax_stage3_checkpoint_scores_as_in_jax(jax_stage3, tmp_path):
    ck, config, img, txt = jax_stage3
    port_ck = _cross(ck, str(tmp_path / "dual.pt"))
    ours = LCLIPScorer.from_checkpoints(port_ck, port_ck, config=config, device="cpu")
    ref = JaxScorer.from_checkpoints(ck, ck, config=config)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(3, RES, RES, 3)).astype(np.float32)
    got, want = ours.score_arrays(images, CAPTIONS), ref.score_arrays(images, CAPTIONS)
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2)
    np.testing.assert_array_equal(ours._tokenize(CAPTIONS),
                                  ref.tokenizer.tokenize(CAPTIONS, context_length=CTX))
    # fp32: the restored towers are the JAX towers' weights exactly
    f32 = LCLIPScorer.from_checkpoints(port_ck, port_ck, config=config, device="cpu",
                                       dtype=torch.float32)
    for name, params, module in (("image", img, f32.image_tower), ("text", txt, f32.text_tower)):
        want_state = jax_student_to_torch(_np_tree(params), name)
        assert all(torch.equal(module.state_dict()[k], v) for k, v in want_state.items())


def test_from_checkpoints_rules(jax_stage3, tmp_path):
    ck, config, _, _ = jax_stage3
    port_ck = _cross(ck, str(tmp_path / "dual.pt"))
    with pytest.raises(ValueError, match="needs --config"):
        LCLIPScorer.from_checkpoints(port_ck, port_ck, device="cpu")
    with pytest.raises(ValueError, match="needs both"):
        LCLIPScorer.from_checkpoints(port_ck, "", config=config, device="cpu")
    # empty-string checkpoints fall back to the teacher (here: a missing one)
    with pytest.raises(RuntimeError, match="not found"):
        LCLIPScorer.from_checkpoints("", "", config=config, teacher_name=str(tmp_path / "x.pt"),
                                     device="cpu")
