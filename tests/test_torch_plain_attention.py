"""The PyTorch port's plain attention against the JAX package, on the CPU.

On the CPU ``ops.plain_attention_rows_qkv`` runs its plain PyTorch version and,
with a gradient, the ``autograd.Function`` whose backward is the explicit plain
backward (the formulas the CUDA kernel implements).  Both are held to

(i)   ``blockdiag_attention_rows_qkv`` called directly, its Pallas kernels in
      interpret mode (as the JAX package's own tests run them on the CPU);
(ii)  ``flash_attention_rows_qkv`` at head shapes the block-diagonal kernel
      rejects: on the CPU that entry is the packed rows kernel, the one the
      TPU falls back to for those shapes;
(iii) the XLA math (``reference_attention``, what the towers compute under
      ``DISTILLCLIP_FLASH=0``) in fp32.

Tolerances: forward 2e-2 absolute against the kernels (their operands and
probabilities are bf16), 1e-5 of the largest entry against fp32 XLA; gradients
3e-2 absolute and 1e-4 of the largest entry.  Inputs come from a numpy seed
and go to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.ops.blockdiag_attention import (
    blockdiag_attention_rows_qkv,
    blockdiag_supported,
)
from distillclip_tpu.ops.flash_attention import flash_attention_rows_qkv, reference_attention
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.ops import plain_attention as pa

B = 2


def _inputs(seed, N, H, d):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((B * N, 3 * H * d)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B * N, H * d)).astype(np.float32)
    return qkv, cot


def _port(qkv, cot, **kw):
    """(out, dqkv) of the port's function through its autograd.Function."""
    leaf = torch.from_numpy(qkv).requires_grad_()
    out = pa.plain_attention_rows_qkv(leaf, **kw)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_PlainAttentionBackward"
    (grad,) = torch.autograd.grad(out, leaf, torch.from_numpy(cot))
    return out.detach().numpy(), grad.numpy()


def _jax(fn, qkv, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(qkv))
    return np.asarray(out, np.float32), np.asarray(vjp(jnp.asarray(cot, out.dtype))[0],
                                                   np.float32)


def _xla(qkv, cot, N, H, d, causal, kv_len):
    HD = H * d
    to4 = lambda t: t.reshape(B, N, H, d).transpose(0, 2, 1, 3)
    frm = lambda t: t.transpose(0, 2, 1, 3).reshape(B * N, HD)
    return _jax(lambda a: frm(reference_attention(
        *(to4(a[:, i * HD:(i + 1) * HD]) for i in range(3)), causal=causal, kv_len=kv_len)),
        qkv, cot)


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# -- (i) the block-diagonal kernels, interpret mode ---------------------------------

@pytest.mark.parametrize("H,d,causal,kv_len", [(4, 32, False, None), (4, 64, True, 20),
                                               (8, 64, True, None), (4, 32, False, 20)])
def test_matches_blockdiag_kernels_in_interpret_mode(H, d, causal, kv_len):
    N = 32
    assert blockdiag_supported(H, d, causal)
    qkv, cot = _inputs(H + d, N, H, d)
    kw = dict(heads=H, seq=N, causal=causal, kv_len=kv_len)
    out, grad = _port(qkv, cot, **kw)
    ref, ref_grad = _jax(lambda a: blockdiag_attention_rows_qkv(a, **kw), qkv, cot)
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)
    np.testing.assert_allclose(grad, ref_grad, atol=3e-2, rtol=0)


# -- (ii) the packed rows kernel, at the shapes blockdiag rejects ----------------------

@pytest.mark.parametrize("H,d,N,causal", [(5, 64, 33, False), (5, 64, 33, True),
                                          (4, 48, 33, False), (4, 48, 16, True)])
def test_matches_rows_kernel_at_shapes_blockdiag_rejects(H, d, N, causal):
    assert not blockdiag_supported(H, d, causal)
    qkv, cot = _inputs(H * d + N, N, H, d)
    kw = dict(heads=H, seq=N, causal=causal)
    out, grad = _port(qkv, cot, **kw)
    ref, ref_grad = _jax(lambda a: flash_attention_rows_qkv(a, **kw), qkv, cot)
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)
    np.testing.assert_allclose(grad, ref_grad, atol=3e-2, rtol=0)


# -- (iii) the XLA math in fp32 ------------------------------------------------------------

@pytest.mark.parametrize("H,d,N", [(4, 32, 16), (5, 64, 33), (8, 48, 32)])
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, 11), (True, 11)],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_matches_xla_math_fp32(H, d, N, causal, kv):
    qkv, cot = _inputs(H + d + N, N, H, d)
    out, grad = _port(qkv, cot, heads=H, seq=N, causal=causal, kv_len=kv)
    ref, ref_grad = _xla(qkv, cot, N, H, d, causal, kv)
    assert _rel(out, ref) <= 1e-5
    assert _rel(grad, ref_grad) <= 1e-4


# -- the saved probabilities and the explicit backward --------------------------------------

@pytest.mark.parametrize("causal,kv", [(True, None), (False, 9), (True, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_masked_probabilities_are_exactly_zero(causal, kv, dtype):
    N, H, d = 17, 3, 8
    qkv = torch.from_numpy(_inputs(3, N, H, d)[0]).to(dtype)
    o, p = pa.plain_attention_save_p(qkv, heads=H, seq=N, scale=d ** -0.5, causal=causal,
                                     kv_len=kv)
    assert p.shape == (B, H, N, N) and p.dtype == dtype and o.dtype == dtype
    hidden = ~pa.attention_mask(N, causal, kv, "cpu")
    assert hidden.any() and not p[:, :, hidden].any()
    assert torch.isfinite(p.float()).all()
    np.testing.assert_allclose(p.float().sum(-1).numpy(), 1.0, atol=2e-2 if dtype != torch.float32
                               else 1e-5)
    lean = pa.plain_attention_rows_qkv(qkv, heads=H, seq=N, causal=causal, kv_len=kv)
    assert torch.equal(o, lean)               # the same bits with and without P


@pytest.mark.parametrize("causal", [False, True])
def test_explicit_backward_equals_autograd_through_the_plain_forward(causal):
    N, H, d = 19, 5, 16
    qkv, cot = _inputs(5, N, H, d)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    leaf = torch.from_numpy(qkv).requires_grad_()
    out = pa.plain_attention_rows_qkv_plain(leaf, causal=causal, **kw)
    (auto,) = torch.autograd.grad(out, leaf, torch.from_numpy(cot))
    _, p = pa.plain_attention_save_p_plain(torch.from_numpy(qkv), causal=causal, **kw)
    explicit = pa.plain_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(cot), p, **kw)
    assert _rel(explicit.numpy(), auto.numpy()) <= 1e-5


def test_bf16_inputs_stay_in_the_bf16_class():
    """bf16 qkv through the port's function against the fp32 XLA math on the
    same (rounded) values: the kernels' tolerance class."""
    N, H, d = 33, 4, 32
    qkv, cot = _inputs(9, N, H, d)
    q16 = torch.from_numpy(qkv).to(torch.bfloat16)
    leaf = q16.clone().requires_grad_()
    out = pa.plain_attention_rows_qkv(leaf, heads=H, seq=N, causal=True)
    (grad,) = torch.autograd.grad(out, leaf, torch.from_numpy(cot).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
    ref, ref_grad = _xla(q16.float().numpy(),
                         torch.from_numpy(cot).to(torch.bfloat16).float().numpy(),
                         N, H, d, True, None)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, atol=8e-3, rtol=0)
    np.testing.assert_allclose(grad.float().numpy(), ref_grad, atol=3e-2, rtol=0)


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    qkv = torch.from_numpy(_inputs(1, 8, 2, 8)[0])
    ops.reset_launch_counts()
    pa.plain_attention_rows_qkv(qkv, heads=2, seq=8)
    pa.plain_attention_rows_qkv(qkv.clone().requires_grad_(), heads=2, seq=8).sum().backward()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert {"plain_attention_rows_qkv", "plain_attention_save_p",
            "plain_attention_bwd"} <= set(ops.KERNELS)


def test_shape_and_mask_arguments_are_checked():
    qkv = torch.zeros(16, 3 * 2 * 8)
    with pytest.raises(ValueError, match="kv_len"):
        pa.plain_attention_rows_qkv(qkv, heads=2, seq=8, kv_len=0)
    with pytest.raises(ValueError, match="kv_len"):
        pa.plain_attention_rows_qkv(qkv, heads=2, seq=8, kv_len=9)
    with pytest.raises(ValueError, match="qkv"):
        pa.plain_attention_rows_qkv(qkv, heads=5, seq=8)
    with pytest.raises(ValueError, match="qkv"):
        pa.plain_attention_rows_qkv(qkv, heads=2, seq=7)
    with pytest.raises(ValueError, match="no kernel for device"):
        pa.plain_attention_rows_qkv(qkv.to("meta"), heads=2, seq=8)
