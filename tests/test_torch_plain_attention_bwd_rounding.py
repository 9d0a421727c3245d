"""The arithmetic of the tensor-core fused-qkv attention backward (#14,
``csrc/plain_attention_bwd.cu``), written out in PyTorch, against the fp32
plain version and the JAX package's kernel, on the CPU.

The kernel reads the forward's saved bf16 P and forms dP = dO·Vᵀ, D = Σ_j P∘dP
and dS = scale·P∘(dP − D) in fp32 from bf16 operands; P enters dV = Pᵀ·dO as
one bf16 operand (it is the saved bf16 value, so nothing is lost), and dS
enters dQ = dS·K and dK = dSᵀ·Q as two bf16 operands, hi = bf16(dS) and lo =
bf16(dS − hi), into one fp32 sum; each gradient is rounded once to bf16.  The
TPU kernel rounds P∘dP and dS to bf16 instead.  At the four main-path head
shapes (B=2, q and k at unit scale, v at 0.7, dO at unit scale, as
``chip_smoke.py`` draws them, P from the plain forward in bf16) the kernel's
arithmetic is held within 3e-2 of ``plain_attention_bwd_plain`` in fp32 on the
same bf16 inputs, and equals the fp32 products before the store to fp32
noise, where one bf16 rounding of dS moves dq and dk by ten times more (run
this file as a script with the batch, 256, to print the margins after the
store).  Against JAX's ``_bd_bwd_call`` (the Pallas kernel in interpret mode)
on the same qkv, dO and P, a second bf16 result, the gradients agree within
3e-2 plus one bf16 step of either side's rounding (2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import blockdiag_attention as jbd
from distillclip_tpu_torch.ops import plain_attention as pa

B = 2
LIMIT = 3e-2
# (H, d, N, causal): image teacher, text teacher, image student, text student
MAIN_PATH = {"image teacher": (12, 64, 50, False), "text teacher": (8, 64, 77, True),
             "image student": (24, 32, 50, False), "text student": (12, 64, 77, False)}


def _inputs(H, d, N, causal, seed, batch=B):
    """bf16 qkv ``[batch·N, 3·H·d]``, dO ``[batch·N, H·d]`` and the saved bf16
    P ``[batch, H, N, N]`` of the plain forward."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch * N, 3, H * d)).astype(np.float32)
    qkv[:, 2] *= np.float32(0.7)
    qkv = torch.from_numpy(qkv.reshape(batch * N, 3 * H * d)).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((batch * N, H * d)).astype(np.float32))
    do = do.to(torch.bfloat16)
    p = pa.plain_attention_save_p_plain(qkv, heads=H, seq=N, scale=d ** -0.5,
                                        causal=causal)[1]
    return qkv, do, p


def kernel_arithmetic(qkv, do, p, H: int, N: int, split: bool = True):
    """dqkv before its bf16 store, fp32, as the kernel computes it
    (``split``: dS as bf16 hi + lo; else one bf16 rounding of dS)."""
    rows = qkv.shape[0]
    d = qkv.shape[1] // 3 // H
    batch, scale = rows // N, d ** -0.5
    q, k, v = qkv.float().view(batch, N, 3, H, d).permute(2, 0, 3, 1, 4)
    do4 = do.float().view(batch, N, H, d).permute(0, 2, 1, 3)
    p32 = p.float()
    dp = do4 @ v.transpose(-1, -2)
    delta = (p32 * dp).sum(-1, keepdim=True)
    ds = scale * p32 * (dp - delta)

    def product(x, y):
        hi = x.to(torch.bfloat16).float()
        if not split:
            return hi @ y
        return hi @ y + (x - hi).to(torch.bfloat16).float() @ y

    dq, dk = product(ds, k), product(ds.transpose(-1, -2), q)
    dv = p32.transpose(-1, -2) @ do4
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, 3 * H * d)


def _jax_bd_bwd(qkv, do, p, H: int, N: int):
    """dqkv of JAX's ``_bd_bwd_call`` on the same bf16 qkv, dO and P (its P
    layout: ``[B·N, H·N]``, head-major columns)."""
    rows = qkv.shape[0]
    d = qkv.shape[1] // 3 // H
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    p2 = p.permute(0, 2, 1, 3).reshape(rows, H * N)
    gb = jbd._pick_gb(rows // N, N, H * d)
    out = jbd._bd_bwd_call(as_jax(qkv), as_jax(do), as_jax(p2), d ** -0.5, gb, N, H, d, N)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", list(MAIN_PATH), ids=list(MAIN_PATH))
def test_kernel_arithmetic_matches_fp32_plain_version(shape):
    H, d, N, causal = MAIN_PATH[shape]
    qkv, do, p = _inputs(H, d, N, causal, seed=H * d + N)
    ref = pa.plain_attention_bwd_plain(qkv.float(), do.float(), p.float(), heads=H, seq=N,
                                       scale=d ** -0.5)
    split = kernel_arithmetic(qkv, do, p, H, N)
    single = kernel_arithmetic(qkv, do, p, H, N, split=False)
    assert float((split.to(torch.bfloat16).float() - ref).abs().max()) <= LIMIT
    # the margin: hi + lo is the fp32 product to fp32 noise; one rounding of
    # dS is ten times further off before the store (dv takes P as it is)
    noise = float((split - ref).abs().max())
    assert noise <= 1e-4
    HD = H * d
    assert float((single - ref)[:, :2 * HD].abs().max()) > 10 * noise


@pytest.mark.parametrize("shape", list(MAIN_PATH), ids=list(MAIN_PATH))
def test_kernel_arithmetic_matches_jax_kernel(shape):
    """Against the Pallas backward of JAX's block-diagonal attention in
    interpret mode, on the same qkv, dO and saved P."""
    H, d, N, causal = MAIN_PATH[shape]
    qkv, do, p = _inputs(H, d, N, causal, seed=H * d + N + 1)
    got = kernel_arithmetic(qkv, do, p, H, N).to(torch.bfloat16).float().numpy()
    ref = _jax_bd_bwd(qkv, do, p, H, N)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, atol=LIMIT, rtol=2.0 ** -8)


def margins(batch: int) -> None:
    """Print, per main-path shape, the largest error of dq, dk, dv against the
    fp32 plain version after the bf16 store, with dS as hi + lo and with one
    bf16 rounding: ``python tests/test_torch_plain_attention_bwd_rounding.py
    256`` for the batch ``chip_smoke.py`` runs."""
    for shape, (H, d, N, causal) in MAIN_PATH.items():
        qkv, do, p = _inputs(H, d, N, causal, H * d + N, batch)
        ref = pa.plain_attention_bwd_plain(qkv.float(), do.float(), p.float(), heads=H, seq=N,
                                           scale=d ** -0.5)
        HD = H * d
        for split in (True, False):
            err = (kernel_arithmetic(qkv, do, p, H, N, split).to(torch.bfloat16).float()
                   - ref).abs()
            errs = [float(err[:, i * HD:(i + 1) * HD].max()) for i in range(3)]
            print(f"B={batch} {shape} {'hi + lo' if split else 'one rounding'}: dq, dk, dv "
                  + ", ".join(f"{e:.3e}" for e in errs) + f" (limit {LIMIT:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else B)
