"""The arithmetic of the LN-GEMM kernels on wgmma, K1 (``csrc/dense_ln_wgmma.cu``)
and #9 (``csrc/dense_ln_bwd.cu``), written out in PyTorch, against fp32 and
against the JAX package's kernels, on the CPU.

K1.  wgmma takes A and B of one type, so LN(x) has to reach the tensor cores
in W's type or W in LN(x)'s.  Three operand routes, each with fp32 sums and
one bf16 store of u, at the qkv width (C = 768, N = 2304), for rows of mean
0.5 and of mean 4 (an off-centre row: the LN subtracts the mean in fp32
before any rounding, so it costs nothing here):

* the TPU kernel's: LN(x) rounded to bf16, W bf16;
* (a) LN(x) and W rounded to fp16 (W converts exactly for |w| >= 2^-14),
  LN(x) as the kernel forms it (:func:`kernel_ln_operand`);
* (b) LN(x) as bf16 hi + lo, two products a 16-deep step, W bf16.

The limit of u against fp32 is ("abs", 1e-2, 1e-3): the largest error and its
mean.  Route (b), which leaves little but the store's rounding, reads about
7.8e-3 and 6.3e-4 of them; the TPU route adds about 4e-4 of mean error and
does not hold 1e-3, route (a) about 1e-5 at one product a step.  The kernel
takes route (a).

#9.  dxn = du·Wᵀ from bf16 operands in fp32, never rounded; the row moments
m1, m2 from the partial sums of the 256-column tiles of a cluster, added in
cluster-rank order; dx and xn rounded once to bf16; dγ, dβ from the partial
sums of the 128-row bands, added in band order.  Held within 3e-2 (dx, xn)
and 6e-3 of the largest entry (dγ, dβ) of the plain version in fp32, and the
rank-ordered moments within fp32 noise of a single fp32 sum.

Both emulations are held to JAX's ``_dense_ln_call`` and ``_dln_bwd_call``
(the Pallas kernels in interpret mode) on the same bf16 inputs at one small
shape.  Run this file as a script to print the K1 margins of each route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import fc1_act as jax_fc1
from distillclip_tpu_torch.ops import fc1_act

ROWS, C, N = 2048, 768, 2304
LIMIT_MAX, LIMIT_MEAN = 1e-2, 1e-3
BWD_LIMIT, GRAD_LIMIT = 3e-2, 6e-3
TILE, BAND = 256, 128       # a cluster block's columns, a block's rows


def _inputs(rows, c, n, seed, x_mean=0.5, w_std=0.02):
    """bf16 x [rows, c], γ, β [c], W [c, n], b [n] and du [rows, n], drawn as
    ``chip_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    bf = lambda shape, std=1.0, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) * std + mean).astype(np.float32)).to(torch.bfloat16)
    return (bf((rows, c), 1.0, x_mean), bf((c,), 0.1, 1.0), bf((c,), 0.1), bf((c, n), w_std),
            bf((n,), 0.02), bf((rows, n)))


def _ln(x, ls, lb, eps=1e-5):
    """(LN(x)·γ + β in fp32, mean, rstd) as the kernels compute them."""
    x32 = x.float()
    mean = x32.mean(-1)
    d = x32 - mean[:, None]
    rstd = torch.rsqrt(d.square().mean(-1) + eps)
    return d * rstd[:, None] * ls.float() + lb.float(), mean, rstd


def kernel_ln_operand(x, ls, lb, eps=1e-5):
    """(A, mean, rstd): the kernels' fp16 operand LN(x)·γ + β in fp32 (its
    values are fp16's): t = x·rstd - mean·rstd and t·γ + β in fp32, rounded
    once to fp16."""
    x32 = x.float()
    mean = x32.mean(-1)
    rstd = torch.rsqrt((x32 - mean[:, None]).square().mean(-1) + eps)
    t = torch.addcmul((-mean * rstd)[:, None], x32, rstd[:, None])
    return (t * ls.float() + lb.float()).half().float(), mean, rstd


def k1_arithmetic(x, ls, lb, w, b, route="fp16"):
    """u in bf16 and the fp32 mean, rstd of K1 under an operand route:
    ``"fp16"`` (the kernel's), ``"bf16"`` (the TPU kernel's) or ``"hilo"``."""
    a, mean, rstd = _ln(x, ls, lb)
    w32 = w.float()
    if route == "fp16":
        prod = kernel_ln_operand(x, ls, lb)[0] @ w.half().float()
    elif route == "bf16":
        prod = a.to(torch.bfloat16).float() @ w32
    else:
        hi = a.to(torch.bfloat16).float()
        prod = hi @ w32 + (a - hi).to(torch.bfloat16).float() @ w32
    if b is not None:
        prod = prod + b.float()
    return prod.to(torch.bfloat16), mean, rstd


def _k1_errors(x_mean, route, rows=ROWS, seed=0):
    x, ls, lb, w, b, _ = _inputs(rows, C, N, seed, x_mean)
    ref = fc1_act.dense_ln_stats_plain(x.float(), ls.float(), lb.float(), w.float(),
                                       b.float())[0]
    err = (k1_arithmetic(x, ls, lb, w, b, route)[0].float() - ref).abs()
    return float(err.max()), float(err.mean())


@pytest.mark.parametrize("x_mean", [0.5, 4.0], ids=["mean0.5", "mean4"])
def test_k1_fp16_operands_hold_the_limits_where_bf16_does_not(x_mean):
    fmax, fmean = _k1_errors(x_mean, "fp16")
    assert fmax <= 0.9 * LIMIT_MAX and fmean <= 0.75 * LIMIT_MEAN
    # hi + lo holds them too, at two products a step; it gains little
    hmax, hmean = _k1_errors(x_mean, "hilo")
    assert hmax <= 0.9 * LIMIT_MAX and hmean <= fmean <= 1.05 * hmean
    # one bf16 rounding of LN(x), the TPU kernel's, leaves no margin on the mean
    _, bmean = _k1_errors(x_mean, "bf16")
    assert bmean > 0.9 * LIMIT_MEAN and bmean > 1.4 * fmean


@pytest.mark.parametrize("x_mean", [4.0, 64.0], ids=["mean4", "mean64"])
def test_k1_statistics_hold_off_centre_rows(x_mean):
    """mean and rstd as the statistics launch forms them (the mean, then the
    variance about it, in fp32) within 1e-5 of fp64, for rows whose mean is
    well above their spread; the plain version's agree with them to 1e-5."""
    x, ls, lb, w, b, _ = _inputs(256, C, 8, 3, x_mean)
    _, mean, rstd = _ln(x, ls, lb)
    x64 = x.double()
    rmean = x64.mean(-1)
    rrstd = torch.rsqrt((x64 - rmean[:, None]).square().mean(-1) + 1e-5)
    torch.testing.assert_close(mean.double(), rmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd.double(), rrstd, rtol=1e-5, atol=0)
    _, pmean, prstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w, b)
    torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, prstd, rtol=1e-5, atol=0)


def dln_bwd_arithmetic(x, ls, lb, w, du, mean, rstd, single_sum=False):
    """(dx bf16, xn bf16, dγ, dβ fp32, m1, m2) as #9 computes them: the row
    moments from the 256-column tiles' partials added in cluster-rank order
    (or, with ``single_sum``, one fp32 sum over the row), dγ/dβ from the
    128-row bands' partials added in band order."""
    c = x.shape[1]
    ls32 = ls.float()
    dxn = du.float() @ w.float().t()
    xh = (x.float() - mean[:, None]) * rstd[:, None]
    xn = (xh * ls32 + lb.float()).to(torch.bfloat16)
    dxh = dxn * ls32
    if single_sum:
        s1, s2 = dxh.sum(1), (dxh * xh).sum(1)
    else:
        s1 = s2 = torch.zeros(x.shape[0])
        for k in range(0, c, TILE):
            s1 = s1 + dxh[:, k:k + TILE].sum(1)
            s2 = s2 + (dxh * xh)[:, k:k + TILE].sum(1)
    m1, m2 = s1 / c, s2 / c
    dx = rstd[:, None] * (dxh - m1[:, None] - xh * m2[:, None])
    dg = db = torch.zeros(c)
    for r in range(0, x.shape[0], BAND):
        dg = dg + (dxn * xh)[r:r + BAND].sum(0)
        db = db + dxn[r:r + BAND].sum(0)
    return dx.to(torch.bfloat16), xn, dg, db, m1, m2


def _rel_to_max(out, ref):
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.parametrize("n,x_mean", [(N, 0.0), (4 * C, 0.5)], ids=["qkv", "fc1"])
def test_dln_bwd_arithmetic_matches_fp32_plain_version(n, x_mean):
    x, ls, lb, w, _, du = _inputs(1024, C, n, 5, x_mean)
    _, mean, rstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w)
    dx, xn, dg, db, m1, m2 = dln_bwd_arithmetic(x, ls, lb, w, du, mean, rstd)
    rdx, rxn, rdg, rdb = fc1_act.dense_ln_bwd_plain(x.float(), ls.float(), lb.float(),
                                                    w.float(), du.float(), mean, rstd)
    assert float((dx.float() - rdx).abs().max()) <= BWD_LIMIT
    assert float((xn.float() - rxn).abs().max()) <= BWD_LIMIT
    assert _rel_to_max(dg, rdg) <= GRAD_LIMIT and _rel_to_max(db, rdb) <= GRAD_LIMIT
    # the cluster-rank order against one fp32 sum over the row: fp32 noise
    *_, sm1, sm2 = dln_bwd_arithmetic(x, ls, lb, w, du, mean, rstd, single_sum=True)
    dxh = (du.float() @ w.float().t()) * ls.float()
    scale = float(dxh.abs().mean())
    assert float((m1 - sm1).abs().max()) <= 1e-5 * scale
    assert float((m2 - sm2).abs().max()) <= 1e-5 * scale


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def test_k1_arithmetic_matches_jax_kernel():
    """Against ``_dense_ln_call`` in interpret mode (bf16 LN(x) there, fp16
    here): u within 1e-2 plus a bf16 step of either store, mean and rstd to
    1e-5."""
    x, ls, lb, w, b, _ = _inputs(64, 256, 520, 7, 0.5, w_std=0.05)
    u, mean, rstd = k1_arithmetic(x, ls, lb, w, b)
    ru, rmean, rrstd = jax_fc1._dense_ln_call(*[_jax_bf16(t) for t in (x, ls, lb, w, b)], 1e-5)
    np.testing.assert_allclose(u.float().numpy(), _f32(ru).numpy(), atol=1e-2, rtol=2.0 ** -8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0], rtol=1e-5)


def test_dln_bwd_arithmetic_matches_jax_kernel():
    """Against ``_dln_bwd_call`` in interpret mode on the same bf16 inputs
    and statistics: dx and xn within 3e-2 plus a bf16 step, dγ and dβ within
    6e-3 of their largest entry."""
    x, ls, lb, w, _, du = _inputs(192, 512, 264, 9, 0.5, w_std=0.05)
    _, mean, rstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w)
    dx, xn, dg, db, _, _ = dln_bwd_arithmetic(x, ls, lb, w, du, mean, rstd)
    rdx, rxn, rdg, rdb = jax_fc1._dln_bwd_call(
        *[_jax_bf16(t) for t in (x, ls, lb, w, du)], jnp.asarray(mean.numpy())[:, None],
        jnp.asarray(rstd.numpy())[:, None])
    np.testing.assert_allclose(dx.float().numpy(), _f32(rdx).numpy(), atol=BWD_LIMIT,
                               rtol=2.0 ** -8)
    np.testing.assert_allclose(xn.float().numpy(), _f32(rxn).numpy(), atol=BWD_LIMIT,
                               rtol=2.0 ** -8)
    assert _rel_to_max(dg, torch.from_numpy(np.array(rdg))) <= GRAD_LIMIT
    assert _rel_to_max(db, torch.from_numpy(np.array(rdb))) <= GRAD_LIMIT


def margins(rows: int) -> None:
    """Print K1's largest and mean error against fp32 per operand route and
    input mean: ``python tests/test_torch_dense_ln_rounding.py 12800`` for
    the image qkv's rows."""
    for x_mean in (0.5, 4.0):
        for route in ("bf16", "fp16", "hilo"):
            emax, emean = _k1_errors(x_mean, route, rows)
            print(f"K1 rows={rows} C={C} N={N} x mean {x_mean}, route {route}: max "
                  f"{emax:.3e} (limit {LIMIT_MAX:g}), mean {emean:.3e} (limit {LIMIT_MEAN:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else ROWS)
