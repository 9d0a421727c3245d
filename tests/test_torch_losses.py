"""The port's 18 loss functions and its LossCalculator against the JAX
package, on the CPU: the same numpy-seeded inputs through both, values and
gradients within 1e-5 (relative to the reference's largest entry).

One stated exception: ``smd`` and ``smd_multi_model`` read the teacher's
distance to itself, sqrt(max(|t|² + |t|² - 2 t·t, 1e-12)), whose argument is
float32 summation noise around 0 (1e-12 in one package, 1e-7 in the other, so
1e-6 against 3e-4 after the root).  With dyadic inputs and no normalisation
that noise is exactly 0 in both and the losses are held to 1e-5; on random
normalised inputs their values are held to 2e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.losses import LossCalculator as JaxCalculator
from distillclip_tpu.losses import functional as JF
from distillclip_tpu.models import outputs as jout
from distillclip_tpu_torch.losses import LOSS_NAMES, LossCalculator
from distillclip_tpu_torch.losses import functional as F
from distillclip_tpu_torch.models import outputs as pout

L, B, H, N, D, OUT = 3, 6, 4, 5, 8, 16


def _rng(seed=0):
    return np.random.default_rng(seed)


def _probs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _unit_logits(rng, n):
    a = rng.standard_normal((n, OUT)).astype(np.float32)
    b = rng.standard_normal((n, OUT)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return (a @ b.T).astype(np.float32)


def _case(name):
    """(JAX function, port function, numpy inputs, index of the student's
    argument, keyword arguments)."""
    r = _rng(len(name))
    n = lambda *s: r.standard_normal(s).astype(np.float32)
    reps = (n(B, OUT), n(B, OUT))
    dyadic = lambda *s: (np.round(n(*s) * 4) / 4).astype(np.float32)
    table = {
        "out_l1": (reps, 0, {}), "out_ce": (reps, 0, {}), "out_cos": (reps, 0, {}),
        "out_kl": (reps, 0, {"temperature": 2.0}),
        "embedding_mse": ((n(B, N, D), n(B, N, D)), 0, {}),
        "attention_score_mse": ((n(L, B, H, N, N), n(L, B, 2 * H, N, N)), 0, {}),
        "attention_probs_mse": ((_probs(r, (L, B, H, N, N)), _probs(r, (L, B, 2 * H, N, N))),
                                0, {}),
        "attention_probs_kl": ((_probs(r, (L, B, H, N, N)), _probs(r, (L, B, 2 * H, N, N))),
                               0, {}),
        "hidden_rep_mse": ((n(L, B, N, D), n(L, B, N, D)), 0, {}),
        "last_value_map_kl": ((_probs(r, (B, H, N, N)), _probs(r, (B, H, N, N))), 0, {}),
        "smd": ((dyadic(B, OUT), dyadic(B, OUT)), 1, {"tau": 0.04, "normalized": False}),
        "hard_label": ((_unit_logits(r, B),), 0, {}),
        "soft_label": ((_unit_logits(r, B), _unit_logits(r, B)), 0, {"temperature": 0.5}),
        "logits_mse": ((_unit_logits(r, B), _unit_logits(r, B)), 0, {}),
        "cos_diff": ((_unit_logits(r, B), _unit_logits(r, B)), 0, {}),
        "fine_grain": ((n(B, N, D), n(B, N + 2, D)), 0, {}),
        "smd_multi_model": ((dyadic(B, OUT), dyadic(B, OUT), dyadic(B, OUT)), 1,
                            {"tau": 0.04, "normalized": False}),
    }
    # vit_kd has its own file (tests/test_torch_vit_kd.py)
    args, stu, kw = table[name]
    return getattr(JF, name), getattr(F, name), args, stu, kw


FUNCTIONAL = [n for n in LOSS_NAMES if n != "vit_kd"]


@pytest.mark.parametrize("name", FUNCTIONAL)
def test_loss_function_matches_jax(name):
    jfn, pfn, args, stu, kw = _case(name)
    jval, jgrad = jax.value_and_grad(lambda *a: jfn(*a, **kw), argnums=stu)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a.copy()) for a in args]
    targs[stu].requires_grad_()
    val = pfn(*targs, **kw)
    assert val.dtype == torch.float32 and val.ndim == 0
    assert abs(float(val.detach()) - float(jval)) <= 1e-5 * max(1.0, abs(float(jval)))
    (grad,) = torch.autograd.grad(val, targs[stu])
    jgrad = np.asarray(jgrad)
    assert np.abs(grad.numpy() - jgrad).max() <= 1e-5 * max(np.abs(jgrad).max(), 1e-6)


@pytest.mark.parametrize("name", ["smd", "smd_multi_model"])
def test_smd_on_normalised_random_inputs_matches_jax_up_to_the_diagonal_noise(name):
    r = _rng(5)
    args = [r.standard_normal((B, OUT)).astype(np.float32) for _ in range(2 + (name != "smd"))]
    jval = getattr(JF, name)(*[jnp.asarray(a) for a in args])
    val = getattr(F, name)(*[torch.from_numpy(a) for a in args])
    assert abs(float(val) - float(jval)) <= 2e-3 * abs(float(jval))


@pytest.mark.parametrize("name", ["out_l1", "attention_probs_kl", "fine_grain", "out_kl"])
def test_loss_function_takes_bf16_inputs_in_fp32(name):
    jfn, pfn, args, stu, kw = _case(name)
    jval = jfn(*[jnp.asarray(a, jnp.bfloat16) for a in args], **kw)
    val = pfn(*[torch.from_numpy(a.copy()).to(torch.bfloat16) for a in args], **kw)
    assert val.dtype == torch.float32
    assert abs(float(val) - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))


def test_kl_div_sum_takes_zero_targets_as_zero_terms():
    t = np.array([[0.0, 0.5, 0.5], [1.0, 0.0, 0.0]], np.float32)
    logq = np.log(np.array([[0.2, 0.3, 0.5], [0.6, 0.2, 0.2]], np.float32))
    val = F.kl_div_sum(torch.from_numpy(logq), torch.from_numpy(t))
    ref = JF.kl_div_sum(jnp.asarray(logq), jnp.asarray(t))
    torch_ref = torch.nn.functional.kl_div(torch.from_numpy(logq), torch.from_numpy(t),
                                           reduction="sum")
    assert np.isfinite(float(val)) and abs(float(val) - float(ref)) <= 1e-6
    assert abs(float(val) - float(torch_ref)) <= 1e-6


def test_probability_logs_are_clamped_at_1e_30():
    s = np.zeros((1, 2, 1, 2, 2), np.float32)
    s[..., 0] = 1.0                                   # a probability of exactly 0
    t = np.full((1, 2, 1, 2, 2), 0.5, np.float32)
    val = F.attention_probs_kl(torch.from_numpy(s), torch.from_numpy(t))
    ref = JF.attention_probs_kl(jnp.asarray(s), jnp.asarray(t))
    assert np.isfinite(float(val)) and abs(float(val) - float(ref)) <= 1e-4 * float(ref)


def test_smd_mining_takes_the_first_index_on_ties():
    """Duplicate teacher rows tie the mined distances; both packages take the
    first index (torch's argmin and argmax promise no order)."""
    r = _rng(3)
    tea = r.standard_normal((B, OUT)).astype(np.float32)
    tea[3] = tea[1]
    stu = r.standard_normal((B, OUT)).astype(np.float32)
    stu[4] = stu[2]
    tea, stu = np.round(tea * 4) / 4, np.round(stu * 4) / 4
    val = F.smd(torch.from_numpy(tea), torch.from_numpy(stu), normalized=False)
    ref = JF.smd(jnp.asarray(tea), jnp.asarray(stu), normalized=False)
    assert abs(float(val) - float(ref)) <= 1e-5 * abs(float(ref))
    x = torch.tensor([[1.0, 0.0, 0.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    assert F._first_arg(x, torch.max)[:, 0].tolist() == [0, 0]
    assert F._first_arg(x, torch.min)[:, 0].tolist() == [1, 0]


# -- the calculator -----------------------------------------------------------------

def _tower_out(rng, cls, heads, n_tokens, **over):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    fields = dict(
        last_representation=n(B, OUT), last_layer_output=n(B, n_tokens, OUT),
        attention_scores=n(L, B, heads, n_tokens, n_tokens),
        attention_probs=_probs(rng, (L, B, heads, n_tokens, n_tokens)),
        representations=n(L, B, n_tokens, D), value_map=_probs(rng, (B, H, n_tokens, n_tokens)),
        embedding=n(B, n_tokens, D))
    fields.update(over)
    return fields


def _outputs(seed=0):
    """The same random tower outputs as JAX and port containers, student and
    teacher, with cosine logits."""
    rng = _rng(seed)
    raw = {("stu", "visual"): _tower_out(rng, None, H, N), ("stu", "text"): _tower_out(
        rng, None, H, N + 2), ("tea", "visual"): _tower_out(rng, None, 2 * H, N),
        ("tea", "text"): _tower_out(rng, None, 2 * H, N + 2)}
    logits = {"stu": _unit_logits(rng, B), "tea": _unit_logits(rng, B)}

    def build(mod, conv):
        out = {}
        for who in ("stu", "tea"):
            vis = mod.VisionOutput(**{k: conv(v) for k, v in raw[(who, "visual")].items()})
            txt = mod.TextOutput(**{k: conv(v) for k, v in raw[(who, "text")].items()})
            out[who] = mod.CLIPOutput(visual_output=vis, text_output=txt,
                                      i2t_logits=conv(logits[who]),
                                      t2i_logits=conv(logits[who].T.copy()))
        return out

    return build(jout, jnp.asarray), build(pout, lambda a: torch.from_numpy(a.copy()))


NO_PARAM_LOSSES = [n for n in LOSS_NAMES if n != "vit_kd"]
ONE_TOWER = [n for n in NO_PARAM_LOSSES if n not in ("hard_label", "soft_label", "logits_mse",
                                                     "fine_grain", "cos_diff",
                                                     "smd_multi_model")]


@pytest.mark.parametrize("model_type", ["image", "text", "all"])
def test_calculator_matches_jax_with_every_loss_at_once(model_type):
    names = NO_PARAM_LOSSES if model_type == "all" else ONE_TOWER
    kw = dict(loss_name=names, loss_scale={"out_l1": 2.0, "smd": 0.5, "hidden_rep_mse": 3.0},
              temperature=0.7, percent={"out_l1": 0.2, "out_cos": 0.1}, smd_tau=0.05)
    jcalc, pcalc = JaxCalculator(**kw), LossCalculator(**kw)
    assert pcalc.percent == pytest.approx(jcalc.percent) and pcalc.loss_scale == jcalc.loss_scale
    assert dataclasses.asdict(pcalc.control_flags()) == dataclasses.asdict(jcalc.control_flags())
    assert not pcalc.has_params
    jouts, pouts = _outputs()
    pick = (lambda o: o) if model_type == "all" else (
        lambda o: o.visual_output if model_type == "image" else o.text_output)
    jtotal, jparts = jcalc(pick(jouts["stu"]), pick(jouts["tea"]), model_type)
    total, parts = pcalc(pick(pouts["stu"]), pick(pouts["tea"]), model_type)
    assert set(parts) == set(jparts)
    for k in parts:
        tol = 2e-3 if "smd" in k else 1e-5          # the diagonal noise, see above
        assert abs(float(parts[k]) - float(jparts[k])) <= tol * max(1.0, abs(float(jparts[k]))), k
    assert abs(float(total) - float(jtotal)) <= 2e-3 * abs(float(jtotal))
    # without the two mining losses the total is held as tightly as the parts
    kw["loss_name"] = [n for n in names if "smd" not in n]
    kw["loss_scale"].pop("smd")
    jtotal, _ = JaxCalculator(**kw)(pick(jouts["stu"]), pick(jouts["tea"]), model_type)
    total, _ = LossCalculator(**kw)(pick(pouts["stu"]), pick(pouts["tea"]), model_type)
    assert abs(float(total) - float(jtotal)) <= 1e-5 * abs(float(jtotal))


@pytest.mark.parametrize("names", [
    ["out_l1"], ["embedding_mse"], ["attention_score_mse"], ["attention_probs_mse"],
    ["attention_probs_kl"], ["hidden_rep_mse"], ["last_value_map_kl"], ["fine_grain"],
    ["hard_label", "smd"], ["out_l1", "attention_probs_kl", "hidden_rep_mse", "fine_grain"]],
    ids=lambda n: "+".join(n))
def test_control_flags_match_jax(names):
    kw = dict(loss_name=names, temperature=1.0)
    flags, jflags = LossCalculator(**kw).control_flags(), JaxCalculator(**kw).control_flags()
    assert dataclasses.asdict(flags) == dataclasses.asdict(jflags)
    assert flags.any_tap() == jflags.any_tap() and flags.attn_tap() == jflags.attn_tap()


def test_calculator_refuses_what_jax_refuses():
    for cls in (LossCalculator, JaxCalculator):
        with pytest.raises(ValueError, match="Invalid Loss Type"):
            cls(["out_l2"])
        with pytest.raises(ValueError, match="temperature required"):
            cls(["out_kl"])
        with pytest.raises(ValueError, match="temperature required"):
            cls(["soft_label"])
        with pytest.raises(ValueError, match="requires vit_kd_para"):
            cls(["vit_kd"])
        with pytest.raises(ValueError, match="percent must sum to 1"):
            cls(["out_l1", "out_cos"], percent={"out_l1": 0.7, "out_cos": 0.7})
        with pytest.raises(ValueError, match="negative"):
            cls(["out_l1", "out_cos"], percent={"out_l1": 1.0})
    assert len(LOSS_NAMES) == 18 and all(
        LossCalculator([n], temperature=1.0, vit_kd_para=dict(student_dims=4, teacher_dims=4))
        for n in LOSS_NAMES)


def test_two_tower_skips_vit_kd_on_the_text_tower():
    para = dict(student_dims=D, teacher_dims=D, low_layers_num=1, high_layers_num=1)
    calc = LossCalculator(["out_l1", "vit_kd"], vit_kd_para=para)
    assert calc.has_params and calc.control_flags().need_rep
    variables = calc.init_vit_kd(np.random.default_rng(0))
    assert set(variables) == {k for k, _ in calc.vit_kd_module.named_parameters()}
    assert float(variables["mask_token"].abs().sum()) == 0.0
    _, pouts = _outputs()
    # vit_kd's generation head needs a square patch grid: N - 1 = 4
    gen = torch.Generator().manual_seed(0)
    total, parts = calc(pouts["stu"], pouts["tea"], "all", vit_kd_variables=variables,
                        generator=gen)
    assert float(parts["text_vit_kd"]) == 0.0 and float(parts["image_vit_kd"]) > 0.0
    assert np.isfinite(float(total))
    with pytest.raises(ValueError, match="requires vit_kd_variables"):
        calc(pouts["stu"], pouts["tea"], "all")
