"""Gradients and residuals of the PyTorch port's ops against torch.autograd
and against the JAX package, on the CPU.

Here each ``torch.autograd.Function`` of ``distillclip_tpu_torch.ops`` runs
its plain forward and its explicit plain backward (``*_bwd_plain``, the
formulas the CUDA kernels implement).  They are held to

(a) ``torch.autograd`` through the plain forward (fp32, 1e-5 of the largest
    entry);
(b) ``jax.vjp`` of the JAX entry point on the same numpy inputs: through the
    Pallas kernels in interpret mode (as the JAX package's own tests run them
    on the CPU) and against the XLA math, fp32 within 1e-4 of the largest
    entry, bf16 within the bf16 class of ROADMAP "Kernel tolerance";
(c) the residuals the JAX forward kernels save (P; u, e, mean, rstd).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.ops import fc1_act as jax_fc1
from distillclip_tpu.ops import layer_norm as jax_ln
from distillclip_tpu.ops import transform_attention as jax_ta
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.ops import fc1_act, layer_norm, transform_attention as ta


def _arrays(seed, *specs):
    """float32 arrays of the given (shape, std, mean) from one numpy seed."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * std + mean).astype(np.float32)
            for shape, std, mean in specs]


def _rel(out, ref):
    """Largest error over the largest reference entry."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _torch_grads(fn, arrays, cot, dtype=torch.float32):
    """(out, grads) of ``fn`` at the arrays (None entries pass through)."""
    leaves = [None if a is None else torch.from_numpy(a).to(dtype).requires_grad_()
              for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, [t for t in leaves if t is not None],
                                torch.from_numpy(cot).to(out.dtype))
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _jax_grads(fn, arrays, cot, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in arrays if a is not None]
    out, vjp = jax.vjp(fn, *args)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(cot, out.dtype))])


# -- inputs -------------------------------------------------------------------

def _ln_case(rows=24, C=32, seed=0):
    x, s, b, cot = _arrays(seed, ((rows, C), 2.0, 0.5), ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                           ((rows, C), 1.0, 0.0))
    return [x, s, b], cot


def _dense_case(bias=True, rows=24, C=32, N=96, seed=1):
    x, ls, lb, w, b, cot = _arrays(seed, ((rows, C), 1.0, 0.3), ((C,), 0.1, 1.0),
                                   ((C,), 0.1, 0.0), ((C, N), 0.2, 0.0), ((N,), 0.1, 0.0),
                                   ((rows, N), 1.0, 0.0))
    return [x, ls, lb, w, b if bias else None], cot


_H, _D = 4, 16


def _attn_case(N, B=2, seed=2):
    """conv_l at std H^-1/2 keeps the mixed logits at std ~1 (a softmax far
    from uniform); conv_w at half that keeps the outputs within ~1."""
    qkv, wl, ww, cot = _arrays(seed + N, ((B * N, 3 * _H * _D), 1.0, 0.0),
                               ((_H, _H), _H ** -0.5, 0.0), ((_H, _H), 0.5 * _H ** -0.5, 0.0),
                               ((B * N, _H * _D), 1.0, 0.0))
    return [qkv, wl, ww], cot


def _xla_ln(x, s, b):
    x = x.astype(jnp.float32)
    mean = x.mean(-1, keepdims=True)
    var = jnp.square(x - mean).mean(-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + 1e-5) * s + b


def _xla_dense(act):
    def fn(x, ls, lb, w, b=None):
        u = _xla_ln(x, ls, lb) @ w
        if b is not None:
            u = u + b
        if act == "gelu_exact":
            return jax.nn.gelu(u, approximate=False)
        if act == "quick_gelu":
            return u * jax.nn.sigmoid(1.702 * u)
        return u
    return fn


def _xla_attn(N):
    HD = _H * _D

    def fn(qkv, wl, ww):
        B = qkv.shape[0] // N
        q, k, v = (qkv[:, i * HD:(i + 1) * HD].reshape(B, N, HD) for i in range(3))
        return jax_ta._xla_transform_rows(q, k, v, wl, ww, _D ** -0.5, N, _H).reshape(B * N, HD)
    return fn


# -- (a) the explicit backward against torch.autograd -------------------------

def _port_cases():
    attn = lambda N: (lambda *a: ta.transform_attention_rows_qkv(*a, heads=_H, seq=N),
                      lambda *a: ta.transform_attention_rows_qkv_plain(
                          *a, heads=_H, seq=N, scale=_D ** -0.5), *_attn_case(N))
    return {
        "layer_norm_rows": (layer_norm.layer_norm_rows, layer_norm.layer_norm_rows_plain,
                            *_ln_case()),
        "dense_ln": (fc1_act.dense_ln, fc1_act.dense_ln_plain, *_dense_case()),
        "dense_ln_no_bias": (fc1_act.dense_ln, fc1_act.dense_ln_plain, *_dense_case(bias=False)),
        "dense_act_ln_gelu_exact": (
            lambda *a: fc1_act.dense_act_ln(*a, act="gelu_exact"),
            lambda *a: fc1_act.dense_ln_plain(*a, act="gelu_exact"), *_dense_case(N=128)),
        "dense_act_ln_quick_gelu": (
            lambda *a: fc1_act.dense_act_ln(*a, act="quick_gelu"),
            lambda *a: fc1_act.dense_ln_plain(*a, act="quick_gelu"), *_dense_case(N=128)),
        "transform_attention_N17": attn(17),
        "transform_attention_N32": attn(32),
    }


@pytest.mark.parametrize("name", sorted(_port_cases()))
def test_function_gradients_match_torch_autograd(name):
    fn, plain, arrays, cot = _port_cases()[name]
    out, grads = _torch_grads(fn, arrays, cot)
    ref, rgrads = _torch_grads(plain, arrays, cot)
    np.testing.assert_array_equal(out, ref)
    assert len(grads) == len(rgrads)
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape and _rel(g, r) <= 1e-5


def test_functions_run_only_when_a_gradient_is_needed():
    """Without a gradient the public functions take the lean path: the
    output carries no graph, with or without grad mode."""
    (x, s, b), _ = _ln_case()
    t = [torch.from_numpy(a) for a in (x, s, b)]
    assert layer_norm.layer_norm_rows(*t).grad_fn is None
    t[1].requires_grad_()
    assert layer_norm.layer_norm_rows(*t).grad_fn is not None
    with torch.no_grad():
        assert layer_norm.layer_norm_rows(*t).grad_fn is None


# -- (b) against jax.vjp of the JAX entry points ------------------------------

def _jax_cases():
    """name -> (port fn, JAX fn, arrays, cotangent, via): the JAX entry points
    run their Pallas kernels in interpret mode; the others are the XLA math."""
    cases = {}
    arrays, cot = _ln_case()
    cases["layer_norm_rows-pallas"] = (
        layer_norm.layer_norm_rows, lambda x, s, b: jax_ln.layer_norm_rows(x, s, b, 1e-5),
        arrays, cot)
    cases["layer_norm_rows-xla"] = (layer_norm.layer_norm_rows, _xla_ln, arrays, cot)
    for bias in (True, False):
        arrays, cot = _dense_case(bias=bias)
        tag = "" if bias else "_no_bias"
        cases[f"dense_ln{tag}-pallas"] = (
            fc1_act.dense_ln,
            (lambda x, ls, lb, w, b: jax_fc1.dense_ln(x, ls, lb, w, b)) if bias
            else (lambda x, ls, lb, w: jax_fc1.dense_ln(x, ls, lb, w)), arrays, cot)
        cases[f"dense_ln{tag}-xla"] = (fc1_act.dense_ln, _xla_dense(None), arrays, cot)
    arrays, cot = _dense_case(N=128)
    for act in ("gelu_exact", "quick_gelu"):
        port = lambda *a, act=act: fc1_act.dense_act_ln(*a, act=act)
        cases[f"dense_act_ln_{act}-pallas"] = (
            port, lambda *a, act=act: jax_fc1.dense_act_ln(*a, act=act), arrays, cot)
        cases[f"dense_act_ln_{act}-xla"] = (port, _xla_dense(act), arrays, cot)
    for N in (17, 32):
        arrays, cot = _attn_case(N)
        cases[f"transform_attention_N{N}-xla"] = (
            lambda *a, N=N: ta.transform_attention_rows_qkv(*a, heads=_H, seq=N),
            _xla_attn(N), arrays, cot)
    return cases


@pytest.mark.parametrize("name", sorted(_jax_cases()))
def test_function_gradients_match_jax_vjp_fp32(name):
    """1e-4 of the largest entry.  The JAX erf inside the Pallas fc1 kernel is
    a rational approximation (abs error 1.5e-7), far inside that."""
    port, jax_fn, arrays, cot = _jax_cases()[name]
    out, grads = _torch_grads(port, arrays, cot)
    ref, rgrads = _jax_grads(jax_fn, arrays, cot)
    assert _rel(out, ref) <= 1e-4
    assert len(grads) == len(rgrads)
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape and _rel(g, r) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [17, 32])
def test_transform_attention_gradients_match_jax_pallas_kernels(N, dtype):
    """Through ``_tf_fwd_call(save_p=True)`` and ``_tf_bwd_call`` in interpret
    mode.  Those kernels round the mixes, P, P∘dP and dS to bf16 whatever the
    input dtype, so both dtypes are held to the bf16 class: forward 0.008,
    dqkv 0.03 absolute, the mix gradients 0.6% of their largest entry."""
    arrays, cot = _attn_case(N)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else \
        (torch.bfloat16, jnp.bfloat16)
    out, (dqkv, dwl, dww) = _torch_grads(
        lambda *a: ta.transform_attention_rows_qkv(*a, heads=_H, seq=N), arrays, cot, tdt)
    ref, (rdqkv, rdwl, rdww) = _jax_grads(
        lambda *a: jax_ta.transform_attention_rows_qkv(*a, heads=_H, seq=N), arrays, cot, jdt)
    assert np.abs(out - ref).max() <= 0.008
    assert np.abs(dqkv - rdqkv).max() <= 0.03
    # bf16 mix parameters also round their own gradient (2^-9 relative)
    lim = 0.006 if dtype == "float32" else 0.006 + 2 ** -8
    assert _rel(dwl, rdwl) <= lim and _rel(dww, rdww) <= lim


@pytest.mark.parametrize("name,lim", [("layer_norm_rows", 2e-2), ("dense_ln", 2e-2),
                                      ("dense_act_ln_gelu_exact", 2e-2)])
def test_row_op_gradients_match_jax_pallas_kernels_bf16(name, lim):
    """bf16 inputs through the Pallas kernels in interpret mode: outputs
    within 1e-2 absolute plus 1e-2 relative (one bf16 rounding of values up to
    ~4), gradients within 2% of their largest entry (the two packages round
    dxn·γ and the weight-gradient operands at different places)."""
    port, _, arrays, cot = _port_cases()[name]
    jax_fn = {"layer_norm_rows": lambda x, s, b: jax_ln.layer_norm_rows(x, s, b, 1e-5),
              "dense_ln": lambda *a: jax_fc1.dense_ln(*a),
              "dense_act_ln_gelu_exact": lambda *a: jax_fc1.dense_act_ln(*a, act="gelu_exact"),
              }[name]
    out, grads = _torch_grads(port, arrays, cot, torch.bfloat16)
    ref, rgrads = _jax_grads(jax_fn, arrays, cot, jnp.bfloat16)
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=1e-2)
    for g, r in zip(grads, rgrads):
        assert _rel(g, r) <= lim


@pytest.mark.parametrize("res", ["ue", "u"])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_ln_gradients_match_jax_dense_act_ln_bwd(act, res):
    """dx, dγ, dβ, dW and db of K2 under a gradient, whose backward hands #9
    dh, u and e (e recomputed from u under ``res="u"``), against the JAX
    package's ``_dense_act_ln_bwd`` on the residuals of its own forward
    kernels (``_fc1_ln_call``; ``_dense_ln_call`` for u alone) in interpret
    mode: fp32, 1e-4 of the largest entry."""
    arrays, cot = _dense_case(N=128)
    j = [jnp.asarray(a) for a in arrays]
    if res == "ue":
        u, e, mean, rstd = jax_fc1._fc1_ln_call(*j, act, 1e-5)
    else:
        (u, mean, rstd), e = jax_fc1._dense_ln_call(*j, 1e-5), None
    rgrads = jax_fc1._dense_act_ln_bwd(act, 1e-5, (*j[:4], u, e, mean, rstd), jnp.asarray(cot))
    _, grads = _torch_grads(lambda *a: fc1_act.dense_act_ln(*a, act=act, res=res), arrays, cot)
    assert len(grads) == len(rgrads) == 5
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape and _rel(g, np.asarray(r)) <= 1e-4


# -- (c) the residuals the forward kernels save ----------------------------------

@pytest.mark.parametrize("N", [17, 32])
def test_saved_probabilities_match_jax_save_p_kernel(N):
    """P head by head on the true-N part of JAX's padded [B·Np, H·Np] layout:
    4e-3 absolute (JAX stores bf16)."""
    (qkv, wl, ww), _ = _attn_case(N)
    B, Np, HD3 = qkv.shape[0] // N, -(-N // 16) * 16, qkv.shape[1]
    padded = np.zeros((B, Np, HD3), np.float32)
    padded[:, :N] = qkv.reshape(B, N, HD3)
    _, pf = jax_ta._tf_fwd_call(jnp.asarray(padded.reshape(B * Np, HD3)), jnp.asarray(wl),
                                jnp.asarray(ww), _D ** -0.5, N, 1, Np, _H, _D, save_p=True)
    ref = np.asarray(pf.astype(jnp.float32)).reshape(B, Np, _H, Np)
    ref = ref.transpose(0, 2, 1, 3)[:, :, :N, :N]                    # [B, H, N, N]
    o, p = ops.transform_attention_save_p(torch.from_numpy(qkv), torch.from_numpy(wl),
                                          torch.from_numpy(ww), heads=_H, seq=N,
                                          scale=_D ** -0.5)
    assert p.shape == (B, _H, N, N) and o.shape == (B * N, _H * _D)
    assert np.abs(p.numpy() - ref).max() <= 4e-3
    np.testing.assert_allclose(p.numpy().sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_fc1_residuals_match_jax_fc1_ln_kernel(act):
    """u, e within 1e-2 in bf16, mean and rstd within 1e-5 relative; h is the
    lean kernel's h."""
    arrays, _ = _dense_case(N=128)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    ru, re, rmean, rrstd = jax_fc1._fc1_ln_call(*j, act, 1e-5)
    h, u, e, mean, rstd = ops.dense_act_ln_res(*t, act=act)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    assert np.abs(u.float().numpy() - f32(ru)).max() <= 1e-2
    assert np.abs(e.float().numpy() - f32(re)).max() <= 1e-2
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5)
    assert torch.equal(h, ops.dense_act_ln(*t, act=act))
    assert mean.dtype == torch.float32 and u.dtype == torch.bfloat16


def test_row_statistics_match_jax_kernels():
    """mean and rstd of K1 and K4 against ``_dense_ln_call`` / ``_ln_fwd_call``."""
    arrays, _ = _dense_case()
    _, rmean, rrstd = jax_fc1._dense_ln_call(*[jnp.asarray(a) for a in arrays], 1e-5)
    _, mean, rstd = fc1_act.dense_ln_fwd(*[torch.from_numpy(a) for a in arrays], stats=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5)
    (x, s, b), _ = _ln_case()
    _, rmean, rrstd = jax_ln._ln_fwd_call(*[jnp.asarray(a) for a in (x, s, b)], 1e-5)
    _, mean, rstd = layer_norm.layer_norm_rows_fwd(*[torch.from_numpy(a) for a in (x, s, b)],
                                                   stats=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5)


def test_backward_kernels_outputs_match_jax_bwd_calls():
    """The backward kernels' own outputs (dx, xn, fp32 dγ/dβ) against
    ``_dln_bwd_call`` and ``_ln_bwd_call`` in interpret mode, fp32."""
    (x, ls, lb, w, _), _ = _dense_case()
    du = _arrays(7, ((x.shape[0], w.shape[1]), 1.0, 0.0))[0]
    t = lambda *a: [torch.from_numpy(v) for v in a]
    j = lambda *a: [jnp.asarray(v) for v in a]
    _, mean, rstd = fc1_act.dense_ln_stats_plain(*t(x, ls, lb, w))
    ref = jax_fc1._dln_bwd_call(*j(x, ls, lb, w, du), jnp.asarray(mean.numpy())[:, None],
                                jnp.asarray(rstd.numpy())[:, None])
    out = ops.dense_ln_bwd(*t(x, ls, lb, w, du), mean, rstd)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), np.asarray(r)) <= 1e-4
    (x, s, b), g = _ln_case()
    _, mean, rstd = layer_norm.layer_norm_rows_stats_plain(*t(x, s, b))
    ref = jax_ln._ln_bwd_call(*j(x, s, g), jnp.asarray(mean.numpy())[:, None],
                              jnp.asarray(rstd.numpy())[:, None])
    out = ops.layer_norm_rows_bwd(*t(x, s, g), mean, rstd)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), np.asarray(r)) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("res", ["ue", "u"])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_ln_bwd_activation_mode_is_act_du_then_the_du_mode(act, res, dtype):
    """#9's plain activation mode (dh, u, e; e None under ``res="u"``) gives
    the bits of ``_act_du`` followed by the du mode, with that du last; in
    fp32 du is dh times autograd's derivative of the activation."""
    (x, ls, lb, w, b), dh = _dense_case(N=128)
    x, ls, lb, w, b, dh = (torch.from_numpy(a).to(dtype) for a in (x, ls, lb, w, b, dh))
    _, u, e, mean, rstd = fc1_act.dense_act_ln_res_plain(x, ls, lb, w, b, act)
    e = e if res == "ue" else None
    out = ops.dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, act, u, e)
    du = fc1_act._act_du(dh, u, e, act)
    ref = (*ops.dense_ln_bwd(x, ls, lb, w, du, mean, rstd), du)
    assert len(out) == 5 and all(torch.equal(o, r) for o, r in zip(out, ref))
    if dtype == torch.float32:
        uf = u.clone().requires_grad_()
        h = (torch.nn.functional.gelu(uf) if act == "gelu_exact"
             else uf * torch.sigmoid(1.702 * uf))
        (want,) = torch.autograd.grad(h, uf, dh)
        assert _rel(out[-1].numpy(), want.numpy()) <= 1e-5


def test_dense_ln_bwd_refuses_a_mode_it_does_not_have():
    """An activation comes with u (e optional), and u and e only with one."""
    (x, ls, lb, w, b), dh = _dense_case(N=128)
    x, ls, lb, w, b, dh = (torch.from_numpy(a) for a in (x, ls, lb, w, b, dh))
    _, u, e, mean, rstd = fc1_act.dense_act_ln_res_plain(x, ls, lb, w, b, "gelu_exact")
    for act, uu, ee in (("gelu_exact", None, None), (None, u, None), (None, None, e),
                        ("gelu_exact", None, e)):
        with pytest.raises(ValueError, match="an activation takes u"):
            ops.dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, act, uu, ee)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, "relu", u, e)
