"""The arithmetic of the tensor-core attention backward (#16 backward,
``csrc/mma_attention_bwd.cuh``), written out in PyTorch, against the fp32
plain version and the JAX package's kernel, on the CPU.

The kernel forms P = exp(scale·Q·Kᵀ − lse) and dS = scale·P∘(dO·Vᵀ − δ) in
fp32 from bf16 operands (δ = rowsum(dO∘O) in fp32) and enters P and dS into
their products (dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K) as two bf16 operands, hi =
bf16(x) and lo = bf16(x − hi), into one fp32 sum; each gradient is rounded
once to bf16.  The TPU kernel rounds P and dS to bf16 once instead.  At the
four main-path head shapes (B=2, q and k at unit scale, v at 0.7, dO at unit
scale, as ``chip_smoke.py`` draws them) the hi + lo arithmetic is held within
3e-2 of ``flash_attention_bwd_plain`` in fp32 and equals the fp32 products
before the store to fp32 noise, where one bf16 rounding moves them by ten
times more: at B = 256 that rounding takes the text teacher's dv 2.42e-2 from
fp32 against 1.75e-2 with hi + lo (the bf16 store alone), too close to 3e-2
(run this file as a script with the batch, 256, to print those margins).
Against JAX's ``_plain_bwd`` (Pallas in interpret mode, ``DISTILLCLIP_FLASH``
at its default 1), a second bf16 result, the gradients agree within 3e-2 plus
one bf16 step of either side's rounding (2^-8 relative).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu_torch.ops import plain_attention as pa

jfa = importlib.import_module("distillclip_tpu.ops.flash_attention")
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

B = 2
LIMIT = 3e-2
# (H, d, N, causal): image teacher, text teacher, image student, text student
MAIN_PATH = {"image teacher": (12, 64, 50, False), "text teacher": (8, 64, 77, True),
             "image student": (24, 32, 50, False), "text student": (12, 64, 77, False)}


def _inputs(H, d, N, causal, seed, batch=B):
    """bf16 q, k, v ``[batch, H, N, d]`` (views of a fused projection), dO, and
    the forward's O (bf16) and lse (fp32) from the plain version."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch, N, 3, H, d)).astype(np.float32)
    qkv[:, :, 2] *= np.float32(0.7)
    q, k, v = torch.from_numpy(qkv).to(torch.bfloat16).permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.from_numpy(rng.standard_normal((batch, H, N, d)).astype(np.float32))
    do = do.to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, scale=d ** -0.5, causal=causal)
    return q, k, v, do, o, lse


def kernel_arithmetic(q, k, v, o, lse, do, causal: bool, split: bool = True):
    """(dq, dk, dv) before their bf16 store, fp32, as the kernel computes them
    (``split``: P and dS as bf16 hi + lo; else one bf16 rounding, as the TPU
    kernel does)."""
    N, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    keep = pa.attention_mask(N, causal, None, "cpu")
    p = torch.exp(s - lse[..., None]).masked_fill(~keep, 0.0)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta) * scale

    def product(x, y):
        hi = x.to(torch.bfloat16).float()
        if not split:
            return hi @ y.float()
        return hi @ y.float() + (x - hi).to(torch.bfloat16).float() @ y.float()

    return product(ds, k), product(ds.transpose(-1, -2), q), product(p.transpose(-1, -2), do)


@pytest.mark.parametrize("shape", list(MAIN_PATH), ids=list(MAIN_PATH))
def test_kernel_arithmetic_matches_fp32_plain_version(shape):
    H, d, N, causal = MAIN_PATH[shape]
    q, k, v, do, o, lse = _inputs(H, d, N, causal, seed=H * d + N)
    refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float(), scale=d ** -0.5, causal=causal)
    split = kernel_arithmetic(q, k, v, o, lse, do, causal)
    single = kernel_arithmetic(q, k, v, o, lse, do, causal, split=False)
    for g, one, r in zip(split, single, refs):
        assert float((g.to(torch.bfloat16).float() - r).abs().max()) <= LIMIT
        # the margin: hi + lo is the fp32 product to fp32 noise; one rounding
        # is ten times further off before the store
        noise = float((g - r).abs().max())
        assert noise <= 1e-4
        assert float((one - r).abs().max()) > 10 * noise


@pytest.mark.parametrize("shape", ["image teacher", "text teacher"])
def test_kernel_arithmetic_matches_jax_kernel(shape):
    """Against the gradient of JAX's ``flash_attention`` (``_plain_bwd``, the
    Pallas kernel in interpret mode) on the same bf16 values."""
    H, d, N, causal = MAIN_PATH[shape]
    q, k, v, do, o, lse = _inputs(H, d, N, causal, seed=H * d + N + 1)
    grads = [g.to(torch.bfloat16).float().numpy()
             for g in kernel_arithmetic(q, k, v, o, lse, do, causal)]
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal),
                     as_jax(q), as_jax(k), as_jax(v))
    refs = vjp(as_jax(do))
    for g, r in zip(grads, refs):
        r = np.asarray(r.astype(jnp.float32))
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, atol=LIMIT, rtol=2.0 ** -8)


def margins(batch: int) -> None:
    """Print, per main-path shape, each gradient's largest error against the
    fp32 plain version after the bf16 store, with hi + lo and with one bf16
    rounding of P and dS: ``python tests/test_torch_attention_bwd_rounding.py
    256`` for the batch ``chip_smoke.py`` runs."""
    for shape, (H, d, N, causal) in MAIN_PATH.items():
        q, k, v, do, o, lse = _inputs(H, d, N, causal, H * d + N, batch)
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), scale=d ** -0.5, causal=causal)
        for split in (True, False):
            errs = [float((g.to(torch.bfloat16).float() - r).abs().max()) for g, r in
                    zip(kernel_arithmetic(q, k, v, o, lse, do, causal, split), refs)]
            print(f"B={batch} {shape} {'hi + lo' if split else 'one rounding'}: dq, dk, dv "
                  + ", ".join(f"{e:.3e}" for e in errs) + f" (limit {LIMIT:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else B)
