"""The port's config loader and perf knobs against the JAX package's.

``apply_perf_config`` writes ``os.environ`` for the whole process, so every
test isolates the ``DISTILLCLIP_*`` variables with ``monkeypatch`` and calls
the two packages on the same input, one after the other from a clean
environment.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from distillclip_tpu.config import apply_perf_config as jax_apply
from distillclip_tpu.config import deep_merge as jax_deep_merge
from distillclip_tpu.config import load_configs as jax_load_configs
from distillclip_tpu.config.perf import PERF_KNOBS as JAX_KNOBS
from distillclip_tpu_torch.config import (
    PERF_KNOBS,
    PerfKnobs,
    apply_perf_config,
    deep_merge,
    load_configs,
    perf_knobs,
    require_kernels,
    save_resolved_config,
)
from distillclip_tpu_torch.config.perf import ENV_PREFIX, require_module_kernels, set_perf
from distillclip_tpu_torch.serving.lclip_score import seeded_init

ENVS = [ENV_PREFIX + k.upper() for k in JAX_KNOBS]


@pytest.fixture
def clean_env(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)
    return monkeypatch


def _env_snapshot():
    return {k: os.environ[k] for k in ENVS if k in os.environ}


def _both(clean_env, cfg, preset=None):
    """(JAX result, its env writes, port result, its env writes) on the same
    section from the same starting environment."""
    out = []
    for fn in (jax_apply, apply_perf_config):
        for env in ENVS:
            clean_env.delenv(env, raising=False)
        for k, v in (preset or {}).items():
            clean_env.setenv(k, v)
        out += [fn(cfg), _env_snapshot()]
    return out


def test_knob_list_is_the_jax_packages():
    assert PERF_KNOBS == JAX_KNOBS


@pytest.mark.parametrize("cfg,preset", [
    ({"fc1_ln": "0", "tf_impl": "factored"}, None),
    ({"flash": True, "fc1_ln": False, "tf_il": 1}, None),
    ({"FC1_RES": "u"}, None),
    ({"fc1_ln": "0"}, {"DISTILLCLIP_FC1_LN": "1", "DISTILLCLIP_TF_HC": "4"}),
    (None, {"DISTILLCLIP_TRUE_N": "1"}),
    ({}, None),
], ids=["strings", "booleans", "upper-case key", "env overrides yaml", "env only", "empty"])
def test_apply_perf_config_matches_jax(clean_env, cfg, preset):
    jax_eff, jax_env, eff, env = _both(clean_env, cfg, preset)
    assert eff == jax_eff and env == jax_env


def test_unknown_knob_raises_like_jax(clean_env):
    for fn in (jax_apply, apply_perf_config):
        with pytest.raises(ValueError, match="unknown perf knob 'fc2'"):
            fn({"fc2": "1"})


def test_deep_merge_and_load_configs_match_jax(tmp_path):
    a = {"model": {"init_args": {"lr": 1e-4, "loss": ["out_l1"], "deep": {"x": 1}}},
         "perf": {"fc1_ln": "1"}}
    b = {"model": {"init_args": {"lr": 5e-3, "loss": ["out_cos"], "deep": {"y": 2}}},
         "perf": {"fc1_ln": "0", "tf_impl": "factored"}, "trainer": {"max_epochs": 3}}
    assert deep_merge(a, b) == jax_deep_merge(a, b)
    assert deep_merge(a, {}) == a and a["perf"] == {"fc1_ln": "1"}     # inputs untouched
    paths = []
    for i, cfg in enumerate((a, b)):
        paths.append(str(tmp_path / f"{i}.yaml"))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(cfg, f)
    merged = load_configs(paths)
    assert merged == jax_load_configs(paths)
    assert merged["model"]["init_args"]["loss"] == ["out_cos"]      # lists replace
    assert merged["model"]["init_args"]["deep"] == {"x": 1, "y": 2}
    out = tmp_path / "resolved.yaml"
    save_resolved_config(merged, str(out))
    assert load_configs([str(out)]) == merged


def test_final_configs_load_the_same():
    root = os.path.join(os.path.dirname(__file__), "..", "configs", "final")
    paths = [os.path.join(root, "l_clip.yaml"), os.path.join(root, "l_clip_allcached.yaml")]
    assert load_configs(paths) == jax_load_configs(paths)


@pytest.mark.parametrize("env,want", [
    ({}, PerfKnobs()),
    ({"DISTILLCLIP_FC1_LN": "0"}, PerfKnobs(ln_fusion=False)),
    ({"DISTILLCLIP_FC1_RES": "u"}, PerfKnobs(fc1_res="u")),
    ({"DISTILLCLIP_FC1_RES": "ue"}, PerfKnobs()),
    ({"DISTILLCLIP_TF_IMPL": "factored"}, PerfKnobs()),
    ({"DISTILLCLIP_TF_IMPL": "colcat", "DISTILLCLIP_TF_HC": "8", "DISTILLCLIP_FC1_BLK": "64"},
     PerfKnobs()),
    ({"DISTILLCLIP_FLASH": "0"}, PerfKnobs(no_kernel="flash='0'")),
    ({"DISTILLCLIP_FC1": "xla"}, PerfKnobs(no_kernel="fc1='xla'")),
], ids=["defaults", "fc1_ln", "fc1_res u", "fc1_res ue", "tf_impl", "tpu-only knobs", "flash 0",
        "fc1 xla"])
def test_perf_knobs_parse_as_the_jax_package(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert perf_knobs() == want


@pytest.mark.parametrize("knob", [{"flash": "0"}, {"fc1": "xla"}])
def test_no_kernel_knobs_raise_for_a_cuda_build_request(clean_env, knob, tmp_path):
    """A knob that asks for no kernel is refused when a scorer, a teacher or a
    tower is built for the card (before anything moves there), and changes
    nothing on the CPU."""
    from distillclip_tpu_torch.models import RepeatVisionTransformer
    from distillclip_tpu_torch.serving import LCLIPScorer
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
    from distillclip_tpu_torch.models import teacher_load

    apply_perf_config(knob)
    with pytest.raises(NotImplementedError, match="queue 1, do not port"):
        require_kernels(perf_knobs(), "cuda")
    require_kernels(perf_knobs(), "cpu")
    cfg = os.path.join(os.path.dirname(__file__), "..", "configs", "final", "l_clip.yaml")
    with pytest.raises(NotImplementedError, match="without kernels"):
        LCLIPScorer.from_config(cfg, device="cuda")
    ckpt = tmp_path / "clip.pt"
    torch.save(make_clip_state_dict(vision_width=64, vision_layers=1, patch_size=8,
                                    image_resolution=16, text_width=64, text_layers=1,
                                    context_length=8, vocab_size=64, embed_dim=16, seed=0),
               str(ckpt))
    with pytest.raises(NotImplementedError, match="without kernels"):
        teacher_load(str(ckpt), model_type="image", device="cuda")
    tower = seeded_init(RepeatVisionTransformer(img_size=16, patch_size=8, out_dim=8,
                                                embed_dim=32, depth=2, num_heads=4,
                                                repeated_times=2), np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="without kernels"):
        require_module_kernels(tower, "cuda")
    out = tower(torch.zeros(1, 16, 16, 3))
    assert out.shape == (1, 8) and torch.isfinite(out).all()


def test_set_perf_reaches_every_block(clean_env):
    from distillclip_tpu_torch.models import RepeatTextTransformer

    tower = seeded_init(RepeatTextTransformer(vocab_size=64, context_length=8, out_dim=8,
                                              embed_dim=32, depth=2, num_heads=4,
                                              repeated_times=2), np.random.default_rng(0))
    assert {m.perf for m in tower.modules() if hasattr(m, "perf")} == {PerfKnobs()}
    knobs = PerfKnobs(ln_fusion=False, fc1_res="u")
    set_perf(tower, knobs)
    assert {m.perf for m in tower.modules() if hasattr(m, "perf")} == {knobs}
    assert np.isfinite(tower(torch.ones(2, 8, dtype=torch.long)).detach().numpy()).all()
