"""The arithmetic of the tensor-core attention forward (#13 and #16 forward,
``csrc/mma_attention.cuh``), written out in PyTorch, against the fp32 plain
versions and the JAX package's kernels, on the CPU.

The kernel computes the scores of bf16 q and k in fp32, skips masked keys,
forms e = exp(S − m) in fp32 and enters it into P·V as two bf16 operands, hi
= bf16(e) and lo = bf16(e − hi), into one fp32 sum, which it divides by Σ e;
O is rounded once to bf16 and the saved P is bf16(e / Σ).  At the four
main-path head shapes (B=2, q and k at unit scale, v at 0.7 as in
``chip_smoke.py``) that arithmetic is held within 8e-3 of the fp32 plain
version (P within 4e-3), and within 1e-2 of the JAX kernels run as their own
tests run them (Pallas in interpret mode), which round P to bf16 once before
P·V.  Also shown: the hi + lo product is the fp32
P·V to fp32 noise, where a single bf16 P moves O by up to 2^-9·|v| per key.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops.blockdiag_attention import blockdiag_attention_rows_qkv
from distillclip_tpu_torch.ops import plain_attention as pa

jfa = importlib.import_module("distillclip_tpu.ops.flash_attention")
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

B = 2
# (H, d, N, causal): image teacher, text teacher, image student, text student
MAIN_PATH = {"image teacher": (12, 64, 50, False), "text teacher": (8, 64, 77, True),
             "image student": (24, 32, 50, False), "text student": (12, 64, 77, False)}


def _fused(H, d, N, seed):
    """A bf16 ``[B, N, 3, H, d]`` projection: q and k at unit scale, v at 0.7."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3, H, d)).astype(np.float32)
    qkv[:, :, 2] *= np.float32(0.7)
    return torch.from_numpy(qkv).to(torch.bfloat16)


def kernel_arithmetic(q, k, v, causal: bool):
    """(O in bf16, saved P, the fp32 O before its rounding) as the kernel
    computes them, for bf16 ``[B, H, N, d]`` operands."""
    N, d = q.shape[2], q.shape[3]
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    s = s.masked_fill(~pa.attention_mask(N, causal, None, "cpu"), float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    total = e.sum(dim=-1, keepdim=True)
    hi = e.to(torch.bfloat16)
    lo = (e - hi.float()).to(torch.bfloat16)
    o32 = (hi.float() @ v.float() + lo.float() @ v.float()) / total
    return o32.to(torch.bfloat16), (e / total).to(torch.bfloat16), o32


@pytest.mark.parametrize("shape", list(MAIN_PATH), ids=list(MAIN_PATH))
def test_kernel_arithmetic_matches_fp32_plain_versions(shape):
    H, d, N, causal = MAIN_PATH[shape]
    fused = _fused(H, d, N, seed=H * d + N)
    q, k, v = fused.permute(2, 0, 3, 1, 4).unbind(0)
    o, p, o32 = kernel_arithmetic(q, k, v, causal)
    ro, rp = pa.plain_attention_save_p_plain(fused.float().view(B * N, 3 * H * d), heads=H,
                                             seq=N, scale=d ** -0.5, causal=causal)
    ro4 = ro.view(B, N, H, d).permute(0, 2, 1, 3)
    assert float((o.float() - ro4).abs().max()) <= 8e-3
    assert float((p.float() - rp).abs().max()) <= 4e-3
    assert not p[:, :, ~pa.attention_mask(N, causal, None, "cpu")].any()
    # the two bf16 operands carry P to fp32 noise; one bf16 P does not
    p32 = torch.softmax((q.float() @ k.float().transpose(-1, -2) * d ** -0.5).masked_fill(
        ~pa.attention_mask(N, causal, None, "cpu"), float("-inf")), dim=-1)
    exact = p32 @ v.float()
    assert float((o32 - exact).abs().max()) <= 1e-5
    single = float((p.float() @ v.float() - exact).abs().max())
    assert single > 10 * float((o32 - exact).abs().max())
    fo, lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), scale=d ** -0.5,
                                           causal=causal)
    assert float((o.float() - fo).abs().max()) <= 8e-3
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("shape,entry", [("image teacher", "flash_attention"),
                                         ("text teacher", "flash_attention"),
                                         ("image student", "blockdiag_attention_rows_qkv")])
def test_kernel_arithmetic_matches_jax_kernels(shape, entry):
    """Against JAX's #16 (``flash_attention``) and #13 (``blockdiag_attention_
    rows_qkv``) on the same bf16 values, Pallas in interpret mode."""
    H, d, N, causal = MAIN_PATH[shape]
    fused = _fused(H, d, N, seed=H * d + N + 1)
    q, k, v = fused.permute(2, 0, 3, 1, 4).unbind(0)
    o = kernel_arithmetic(q, k, v, causal)[0].float().numpy()
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    if entry == "flash_attention":
        ref = jfa.flash_attention(as_jax(q), as_jax(k), as_jax(v), causal=causal)
    else:
        ref = blockdiag_attention_rows_qkv(as_jax(fused.reshape(B * N, 3 * H * d)), heads=H,
                                           seq=N, causal=causal)
        ref = jnp.transpose(ref.reshape(B, N, H, d), (0, 2, 1, 3))
    ref = np.asarray(ref.astype(jnp.float32))
    assert ref.shape == o.shape
    np.testing.assert_allclose(o, ref, atol=1e-2, rtol=0)
