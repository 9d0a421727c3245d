"""The dense GEMM without the LayerNorm prologue (``ops.dense_act``, kernels
#10-#12) and the ``fc1_res: u`` mode of the LN-fused fc1, against the JAX
package on the CPU.

The JAX side is ``distillclip_tpu.ops.fc1_act`` through its Pallas kernels in
interpret mode (as the JAX package's own tests run them), with
``DISTILLCLIP_FC1_RES`` set per case; the port runs its plain versions.
Tolerances: fp32 within 1e-5 of the largest entry (the JAX kernels take erf by
Abramowitz-Stegun, within 1.5e-7); bf16 within 2e-2 of the largest entry (the
bf16 class: JAX recombines h from the rounded (u, e), the port from the fp32
sum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.ops import fc1_act as jax_fc1
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.ops import fc1_act

ROWS, C, N = 24, 32, 96


def _arrays(seed, *specs):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * std + mean).astype(np.float32)
            for shape, std, mean in specs]


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _case(seed=0):
    """x, w, b and the cotangent of h; x·W has std ~1 so GELU is nonlinear."""
    return _arrays(seed, ((ROWS, C), 1.0, 0.2), ((C, N), C ** -0.5, 0.0), ((N,), 0.1, 0.0),
                   ((ROWS, N), 1.0, 0.0))


_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_vjp(fn, arrays, cot, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot).to(out.dtype))
    return [out.detach().float().numpy()] + [g.float().numpy() for g in grads]


def _jax_vjp(fn, arrays, cot, dtype):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a, dtype) for a in arrays])
    grads = vjp(jnp.asarray(cot, out.dtype))
    return [np.asarray(out.astype(jnp.float32))] + [np.asarray(g.astype(jnp.float32))
                                                    for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
@pytest.mark.parametrize("res", ["ue", "u"])
def test_dense_act_output_and_grads_match_jax(monkeypatch, res, act, dtype):
    """h, dx, dW and db of the port's dense_act (its autograd Function over
    #10 / #11) against jax.vjp of the JAX dense_act under the same
    DISTILLCLIP_FC1_RES."""
    monkeypatch.setenv("DISTILLCLIP_FC1_RES", res)
    x, w, b, cot = _case()
    got = _torch_vjp(lambda x_, w_, b_: ops.dense_act(x_, w_, b_, act, res), [x, w, b], cot,
                     _TDT[dtype])
    ref = _jax_vjp(lambda x_, w_, b_: jax_fc1.dense_act(x_, w_, b_, act), [x, w, b], cot,
                   _JDT[dtype])
    for name, g, r in zip(("h", "dx", "dW", "db"), got, ref):
        assert _rel(g, r) < _TOL[dtype], f"{name}: {_rel(g, r):.3e}"


@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_plain_versions_match_the_jax_kernels(act):
    """#12 (h), #10 (u, e; and h) and #11 (u) against the JAX kernels that
    write them, in interpret mode, fp32."""
    x, w, b, _ = _case(1)
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    h = fc1_act.dense_act_plain(tx, tw, tb, act)
    assert _rel(h, jax_fc1._fc1_h_call(jx, jw, jb, act)) < 1e-5
    h2, u, e = fc1_act.dense_act_res_plain(tx, tw, tb, act)
    ju, je = jax_fc1._fc1_call(jx, jw, jb, act)
    assert _rel(u, ju) < 1e-5 and _rel(e, je) < 1e-5
    assert torch.equal(h2, h)     # the residual mode's h is the lean mode's
    assert _rel(fc1_act.dense_act_u_plain(tx, tw, tb), jax_fc1._fc1_u_call(jx, jw, jb)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_fused_fc1_u_mode_matches_jax(monkeypatch, dtype):
    """dense_act_ln with res="u" (K1 with statistics, h and e from u) against
    the JAX dense_act_ln under DISTILLCLIP_FC1_RES=u: h and every gradient."""
    monkeypatch.setenv("DISTILLCLIP_FC1_RES", "u")
    x, ls, lb, w, b, cot = _arrays(2, ((ROWS, C), 1.0, 0.3), ((C,), 0.1, 1.0),
                                   ((C,), 0.1, 0.0), ((C, N), 0.2, 0.0), ((N,), 0.1, 0.0),
                                   ((ROWS, N), 1.0, 0.0))
    args = [x, ls, lb, w, b]
    got = _torch_vjp(lambda *a: ops.dense_act_ln(*a, "gelu_exact", 1e-5, "u"), args, cot,
                     _TDT[dtype])
    ref = _jax_vjp(lambda *a: jax_fc1.dense_act_ln(*a, "gelu_exact", 1e-5), args, cot,
                   _JDT[dtype])
    for name, g, r in zip(("h", "dx", "dls", "dlb", "dW", "db"), got, ref):
        assert _rel(g, r) < _TOL[dtype], f"{name}: {_rel(g, r):.3e}"


def test_u_mode_saves_u_only_and_recomputes_e():
    """Under a gradient the u mode runs #11 (no e residual) and its backward
    equals the ue mode's to float precision."""
    x, w, b, cot = _case(3)
    ue = _torch_vjp(lambda *a: ops.dense_act(*a, "gelu_exact", "ue"), [x, w, b], cot,
                    torch.float32)
    u = _torch_vjp(lambda *a: ops.dense_act(*a, "gelu_exact", "u"), [x, w, b], cot,
                   torch.float32)
    for g, r in zip(u, ue):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


def test_dense_act_refuses_bad_arguments():
    x, w, b = (torch.zeros(s) for s in ((4, 8), (8, 16), (16,)))
    with pytest.raises(ValueError, match="unknown activation"):
        ops.dense_act(x, w, b, "relu")
    with pytest.raises(ValueError, match="res must be"):
        ops.dense_act(x, w, b, "gelu_exact", "e")
    with pytest.raises(ValueError, match="dense_act"):
        ops.dense_act(x, w[:4], b)
