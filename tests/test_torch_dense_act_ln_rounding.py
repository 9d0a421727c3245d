"""The arithmetic of K2 and #8 on wgmma (``csrc/dense_ln_wgmma.cu`` with an
activation epilogue) written out in PyTorch, against fp32 and against the
JAX package's kernels, on the CPU.

K2 and #8 take K1's operand route (``test_torch_dense_ln_rounding.
kernel_ln_operand``): LN(x)·γ + β made in fp32 and rounded to fp16, W's fp16
copy, fp32 sums.  The epilogue adds the bias to the fp32 sum u and
takes the activation there, e = erf(u/√2) (exact GELU) or σ(1.702 u)
(QuickGELU), h = 0.5 u (1 + e) or u e, then rounds each of h, u and e once
to bf16.  The mean and rstd are the statistics launch's, as for K1.  The
kernels' GELU takes r = erfc(|u|/√2) as 2^P(|u|), P a polynomial whose
constants this test reads from ``csrc/common.cuh`` and evaluates in fp32 as
the card does, then e = sign(u)·(1 - r) and h = max(u, 0) - 0.5 |u| r.

The limit of each bf16 output against the plain version in fp32 is ("abs",
1e-2, 1e-3): the largest error and its mean, at the fc1 widths (C = 768, N =
3072; the text teacher's C = 512, N = 2048), for rows of mean 0.5 and of mean
4.  The kernel's σ uses the fast exponential and reciprocal; the test gives
e a relative error of 2^-17, their bound for |u| < 50, and the limits hold
all the same.

Both outputs are held to JAX's ``_fc1_ln_h_call`` and ``_fc1_ln_call`` (the
Pallas kernels in interpret mode, LN(x) rounded to bf16 there) on the same
bf16 inputs at one small shape.  Run this file as a script to print the
margins.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import fc1_act as jax_fc1
from distillclip_tpu_torch.ops import fc1_act
from test_torch_dense_ln_rounding import kernel_ln_operand

ROWS = 512
LIMIT_MAX, LIMIT_MEAN = 1e-2, 1e-3
FAST_SIGMA_REL = 2.0 ** -17     # the fast σ's relative error for |u| < 50
EX2_REL = 2.0 ** -22            # ex2.approx.f32's relative error
COMMON = Path(fc1_act.__file__).resolve().parent.parent / "csrc" / "common.cuh"


def _fma(a, b, c):
    """fp32 a·b + c rounded once (an fp64 product of fp32 values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _erfc_constants():
    """(the clamp of |u|, Q's coefficients from the highest power down) of
    erfc_abs_div_sqrt2 in common.cuh."""
    body = COMMON.read_text().split("float erfc_abs_div_sqrt2(float u) {")[1].split("}")[0]
    clamp = float(re.search(r"fminf\(fabsf\(u\), ([0-9.e+-]+)f\)", body).group(1))
    first = float(re.search(r"float q = ([0-9.e+-]+)f;", body).group(1))
    rest = [float(c) for c in re.findall(r"q = fmaf\(q, s, ([0-9.e+-]+)f\);", body)]
    return clamp, [first] + rest


def kernel_gelu(u):
    """(h, e) of the exact GELU as the epilogue computes them from fp32 u, in
    fp32 with fused multiply-adds, the exponential exact."""
    clamp, coef = _erfc_constants()
    un = u.numpy().astype(np.float32)
    s = np.minimum(np.abs(un), np.float32(clamp))
    q = np.full_like(s, np.float32(coef[0]))
    for c in coef[1:]:
        q = _fma(q, s, np.float32(c))
    r = np.exp2((q * s).astype(np.float32).astype(np.float64)).astype(np.float32)
    e = np.copysign(np.float32(1) - r, un).astype(np.float32)
    h = _fma((np.float32(-0.5) * np.abs(un)).astype(np.float32), r, np.maximum(un, 0))
    return torch.from_numpy(h), torch.from_numpy(e)


def _inputs(rows, c, n, seed, x_mean=0.5, w_std=0.02):
    """bf16 x [rows, c], γ, β [c], W [c, n] and b [n], drawn as
    ``chip_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    bf = lambda shape, std=1.0, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) * std + mean).astype(np.float32)).to(torch.bfloat16)
    return (bf((rows, c), 1.0, x_mean), bf((c,), 0.1, 1.0), bf((c,), 0.1), bf((c, n), w_std),
            bf((n,), 0.02))


def k2_arithmetic(x, ls, lb, w, b, act, sigma_rel=0.0):
    """(h, u, e) in bf16 and the fp32 mean, rstd as the kernel forms them;
    ``sigma_rel`` is a relative error given to QuickGELU's σ."""
    a, mean, rstd = kernel_ln_operand(x, ls, lb)
    u = a @ w.half().float() + b.float()
    if act == "gelu_exact":
        h, e = kernel_gelu(u)
    else:
        e = torch.sigmoid(1.702 * u) * (1.0 + sigma_rel)
        h = u * e
    bf = lambda t: t.to(torch.bfloat16)
    return bf(h), bf(u), bf(e), mean, rstd


def _errors(c, n, act, x_mean, rows=ROWS, seed=0, sigma_rel=0.0):
    """[(largest, mean) error of h, u, e against fp32], and the mean's and
    rstd's largest relative error against the plain version's."""
    x, ls, lb, w, b = _inputs(rows, c, n, seed, x_mean)
    outs = k2_arithmetic(x, ls, lb, w, b, act, sigma_rel)
    refs = fc1_act.dense_act_ln_res_plain(x.float(), ls.float(), lb.float(), w.float(),
                                          b.float(), act)
    errs = []
    for out, ref in zip(outs[:3], refs[:3]):
        err = (out.float() - ref).abs()
        errs.append((float(err.max()), float(err.mean())))
    stats = [float(((o - r).abs() / r.abs()).max()) for o, r in zip(outs[3:], refs[3:])]
    return errs, stats


@pytest.mark.parametrize("c,n,act", [(768, 3072, "gelu_exact"), (768, 3072, "quick_gelu"),
                                     (512, 2048, "quick_gelu")],
                         ids=["student_fc1", "image_teacher_fc1", "text_teacher_fc1"])
@pytest.mark.parametrize("x_mean", [0.5, 4.0], ids=["mean0.5", "mean4"])
def test_k2_route_holds_the_limits_against_fp32(c, n, act, x_mean):
    """h, u and e within 1e-2 largest and 1e-3 mean of fp32 (u, the largest
    outputs, with the least margin), with the fast σ's error on top under
    QuickGELU; mean and rstd within 1e-5 of the plain version's."""
    errs, stats = _errors(c, n, act, x_mean,
                          sigma_rel=FAST_SIGMA_REL if act == "quick_gelu" else 0.0)
    for emax, emean in errs:
        assert emax <= 0.9 * LIMIT_MAX and emean <= 0.8 * LIMIT_MEAN
    assert max(stats) <= 1e-5


def test_epilogue_gelu_is_within_1e6_of_the_exact_one():
    """The epilogue's erf(u/√2) and GELU against fp64 over |u| <= 12, in
    steps of 2^-12 near 0 and wider out: erf within 1e-6 with ex2.approx's
    error on top, h within 1e-6 of 0.5 u (1 + erf) relative to max(|u|, 1);
    both exact at u = 0 (JAX's erf: 1.5e-7)."""
    u = torch.cat([torch.arange(-4096, 4097) / 4096.0, torch.linspace(-12, 12, 48001)])
    u = u.float()
    ref_e = torch.erf(u.double() * 0.7071067811865476)
    h, e = kernel_gelu(u)
    assert float((e.double() - ref_e).abs().max()) + EX2_REL <= 1e-6
    ref_h = 0.5 * u.double() * (1.0 + ref_e)
    assert float(((h.double() - ref_h).abs() / u.double().abs().clamp(min=1.0)).max()) <= 1e-6
    h0, e0 = kernel_gelu(torch.zeros(1))
    assert float(h0[0]) == 0.0 and float(e0[0]) == 0.0


def test_fast_sigma_moves_the_outputs_by_less_than_a_bf16_step():
    """QuickGELU's outputs with σ off by 2^-17 against σ exact: at most one
    bf16 rounding step apart, and on a small share of the entries."""
    x, ls, lb, w, b = _inputs(ROWS, 768, 3072, 1)
    exact = k2_arithmetic(x, ls, lb, w, b, "quick_gelu")
    fast = k2_arithmetic(x, ls, lb, w, b, "quick_gelu", FAST_SIGMA_REL)
    for p, q in zip(exact[:3], fast[:3]):
        p, q = p.float(), q.float()
        step = torch.maximum(p.abs(), q.abs()) * 2.0 ** -7
        assert bool(((p - q).abs() <= step).all())
        assert float((p != q).float().mean()) < 0.01


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_k2_arithmetic_matches_jax_kernels(act):
    """Against ``_fc1_ln_h_call`` (h) and ``_fc1_ln_call`` (u, e, mean,
    rstd) in interpret mode (bf16 LN(x) there, fp16 here): each bf16 output
    within 1e-2 plus a bf16 step of either store, mean and rstd to 1e-5."""
    x, ls, lb, w, b = _inputs(64, 256, 520, 7, 0.5, w_std=0.05)
    h, u, e, mean, rstd = k2_arithmetic(x, ls, lb, w, b, act)
    args = [_jax_bf16(t) for t in (x, ls, lb, w, b)]
    rh = jax_fc1._fc1_ln_h_call(*args, act, 1e-5)
    ru, re, rmean, rrstd = jax_fc1._fc1_ln_call(*args, act, 1e-5)
    for out, ref in ((h, rh), (u, ru), (e, re)):
        np.testing.assert_allclose(out.float().numpy(), _f32(ref).numpy(), atol=LIMIT_MAX,
                                   rtol=2.0 ** -8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5)


def margins(rows: int) -> None:
    """Print the largest and mean error of h, u and e against fp32 per width,
    activation and input mean: ``python tests/test_torch_dense_act_ln_rounding.py
    12800`` for the image fc1's rows."""
    for c, n, act in ((768, 3072, "gelu_exact"), (768, 3072, "quick_gelu"),
                      (512, 2048, "quick_gelu")):
        for x_mean in (0.5, 4.0):
            errs, _ = _errors(c, n, act, x_mean, rows,
                              sigma_rel=FAST_SIGMA_REL if act == "quick_gelu" else 0.0)
            print(f"K2/#8 rows={rows} C={c} N={n} {act} x mean {x_mean}: " + "; ".join(
                f"{name} max {emax:.3e} mean {emean:.3e}"
                for name, (emax, emean) in zip("hue", errs))
                + f" (limits {LIMIT_MAX:g}, {LIMIT_MEAN:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else ROWS)
