"""The port's ``flash_attention`` on ``[B, H, N, d]`` operands against the JAX
package on the CPU.

The same numpy-seeded q, k, v (and head mixes) go through JAX
``flash_attention`` (its Pallas kernels in interpret mode on the CPU) and
``reference_attention``, and through the port's ``flash_attention`` (on a CPU
tensor: the plain versions of its kernels, the explicit backward formulas
included) and ``reference_attention``.  fp32: outputs and gradients within
1e-5 of the largest reference entry; bf16: within 2e-2 absolute.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu_torch import ops

# ``ops.flash_attention`` is the public function in both packages; these are
# the modules
jfa = importlib.import_module("distillclip_tpu.ops.flash_attention")
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

CASES = [  # B, H, N, d, causal, kv_len
    (2, 3, 7, 8, False, None), (2, 3, 7, 8, True, None), (2, 2, 10, 16, False, 6),
    (2, 2, 10, 16, True, 7), (1, 4, 50, 8, False, None), (1, 2, 16, 8, True, 16)]
IDS = ["plain", "causal", "kv_len", "causal_kv_len", "n50", "aligned"]


def _inputs(B, H, N, d, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3, H, d)).astype(np.float32)
    mixes = (rng.standard_normal((2, H, H)) * H ** -0.5).astype(np.float32)
    do = rng.standard_normal((B, H, N, d)).astype(np.float32)
    return qkv, mixes, do


def _views(qkv, layout):
    """q, k, v ``[B, H, N, d]``: contiguous arrays, or strided views of the
    fused projection."""
    views = torch.from_numpy(qkv).permute(2, 0, 3, 1, 4).unbind(0)
    return [v.contiguous() for v in views] if layout == "contiguous" else list(views)


def _rel(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


def _jax_out_and_grads(fn, qkv, mixes, do, transform, **kw):
    def f(q, k, v, wl, ww):
        ht = (wl, ww) if transform else None
        return fn(q, k, v, head_transform=ht, **kw)

    args = [jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]
    args += [jnp.asarray(mixes[0]), jnp.asarray(mixes[1])]
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("transform", [False, True], ids=["plain", "head_transform"])
def test_flash_attention_matches_jax_fp32(case, layout, transform):
    B, H, N, d, causal, kv = case
    qkv, mixes, do = _inputs(B, H, N, d)
    kw = dict(causal=causal, kv_len=kv)
    ref, rgrads = _jax_out_and_grads(jfa.flash_attention, qkv, mixes, do, transform, **kw)
    ref2, _ = _jax_out_and_grads(jfa.reference_attention, qkv, mixes, do, transform, **kw)
    q, k, v = (t.requires_grad_() for t in _views(qkv, layout))
    wl, ww = (torch.from_numpy(m).requires_grad_() for m in mixes)
    out = ops.flash_attention(q, k, v, head_transform=(wl, ww) if transform else None, **kw)
    assert out.shape == (B, H, N, d) and out.dtype == torch.float32
    assert _rel(out.detach(), ref) <= 1e-5 and _rel(out.detach(), ref2) <= 1e-5
    plain = ops.reference_attention(q, k, v, head_transform=(wl, ww) if transform else None,
                                    **kw)
    assert _rel(plain.detach(), ref) <= 1e-5
    leaves = (q, k, v, wl, ww) if transform else (q, k, v)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape and _rel(g, r) <= 1e-5


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_forward_and_backward_plain_versions_match_jax_residuals(case):
    """The forward's logsumexp and the explicit backward formulas (the plain
    versions of the two kernels) against jax.vjp of the reference."""
    B, H, N, d, causal, kv = case
    qkv, mixes, do = _inputs(B, H, N, d, seed=1)
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv)
    ref, rgrads = _jax_out_and_grads(jfa.reference_attention, qkv, mixes, do, False,
                                     causal=causal, kv_len=kv)
    q, k, v = _views(qkv, "strided")
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    assert lse.shape == (B, H, N) and lse.dtype == torch.float32
    s = fa._masked_scores(q, k, kw["scale"], causal, kv)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6)
    assert _rel(o, ref) <= 1e-5
    grads = fa.flash_attention_bwd(q, k, v, o, lse, torch.from_numpy(do), **kw)
    for g, r in zip(grads, rgrads):
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("transform", [False, True], ids=["plain", "head_transform"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_bf16(transform, causal):
    B, H, N, d = 2, 4, 10, 16
    qkv, mixes, do = _inputs(B, H, N, d, seed=2)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    qkv, mixes, do = bf(qkv), bf(mixes), bf(do)

    def f(q, k, v, wl, ww):
        return jfa.flash_attention(q, k, v, causal=causal,
                                   head_transform=(wl, ww) if transform else None)

    args = [jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3), jnp.bfloat16) for i in range(3)]
    args += [jnp.asarray(mixes[0], jnp.bfloat16), jnp.asarray(mixes[1], jnp.bfloat16)]
    ref, vjp = jax.vjp(f, *args)
    rgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    q, k, v = (t.to(torch.bfloat16).requires_grad_() for t in _views(qkv, "strided"))
    wl, ww = (torch.from_numpy(m).to(torch.bfloat16).requires_grad_() for m in mixes)
    out = ops.flash_attention(q, k, v, causal=causal,
                              head_transform=(wl, ww) if transform else None)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)
    leaves = (q, k, v, wl, ww) if transform else (q, k, v)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    for g, r in zip(grads, rgrads):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r, atol=2e-2 * max(1.0, np.abs(r).max()))


def test_strided_views_need_no_copy_and_the_output_keeps_their_layout():
    qkv, _, _ = _inputs(2, 3, 7, 8)
    fused = torch.from_numpy(qkv)
    q, k, v = _views(qkv, "strided")
    assert q.data_ptr() == fused.data_ptr() and not q.is_contiguous()
    o_layout = fa._empty_like_layout(q)[0]
    assert o_layout.shape == q.shape and o_layout.permute(0, 2, 1, 3).is_contiguous()
    dq, dk, dv = fa._empty_like_layout(q, 3)
    assert dk.data_ptr() - dq.data_ptr() == 3 * 8 * 4      # one [B, N, 3, H, d] buffer
    assert fa._empty_like_layout(q.contiguous())[0].is_contiguous()
    strides = fa._strides(q, k)
    assert list(strides) == [7 * 72, 8, 72] * 2
    # a view with d transposed or an odd offset is copied for the kernels
    bad = torch.zeros(2, 3, 8, 7, dtype=torch.bfloat16).transpose(-1, -2)
    assert fa._kernel_view("t", bad).is_contiguous()
    ok = torch.zeros(2, 7, 3, 3, 8, dtype=torch.bfloat16).permute(2, 0, 3, 1, 4)[1]
    assert fa._kernel_view("t", ok) is ok


def test_flash_attention_refuses_bad_arguments():
    qkv, _, _ = _inputs(1, 2, 5, 8)
    q, k, v = _views(qkv, "contiguous")
    with pytest.raises(ValueError, match="N<=256"):
        ops.flash_attention(*(torch.zeros(1, 1, 257, 8),) * 3)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=6)
    with pytest.raises(ValueError, match="share one"):
        ops.flash_attention(q, k[:, :1], v)
    with pytest.raises(ValueError, match="mixes"):
        fa.flash_transform_attention_fwd(q, k, v, torch.zeros(3, 3), torch.zeros(2, 2),
                                         scale=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), scale=1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._kernel_view("flash_attention_fwd", q)


def test_cpu_runs_count_no_launch_and_the_kernels_are_registered():
    qkv, mixes, _ = _inputs(1, 2, 5, 8)
    q, k, v = _views(qkv, "strided")
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, head_transform=tuple(torch.from_numpy(m) for m in mixes))
    counts = ops.launch_counts()
    assert counts == dict.fromkeys(ops.KERNELS, 0)
    assert {"flash_attention_fwd", "flash_attention_bwd", "flash_transform_attention_fwd",
            "flash_transform_attention_fwd_wide"} <= set(counts) and len(counts) == 26
