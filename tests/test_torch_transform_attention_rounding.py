"""The arithmetic of the tensor-core head-transform attention forward (K3 and
#5, ``csrc/transform_attention_mma.cu``), written out in PyTorch, against the
fp32 plain version and the JAX package's kernel, on the CPU.

Per sample, the kernel walks the keys in chunks of 16.  S = q·kᵀ per head
from exact bf16 inputs, summed in fp32.  An fp32 operand enters a product as
two bf16 operands, hi = bf16(x) and lo = bf16(x − hi), into one fp32 sum: S
enters the wl mix, L = scale·log2(e)·Σ_g wl·S (log2 units).  Pass 1 keeps per
(row, head) the running max m of L over the chunks and the sum Σ of 2^(L − m),
rescaled by 2^(m_old − m_new) as m moves.  Pass 2 makes P = 2^(L − m − log2 Σ)
in fp32 (0 past N), the saved P as bf16(P), P' = Σ_g ww·P with P as hi + lo,
and O = P'·v with P' as hi + lo, rounded once to bf16.  q, k, v and the mixes
are exact in bf16 and enter once.

At the image and text student shapes and a ragged N = 17 (B = 2; qkv at unit
scale, the mixes at std H^-1/2, as ``chip_smoke.py`` draws them) this
arithmetic is held within 8e-3 of ``transform_attention_save_p_plain`` in fp32
on the same inputs for O and within 4e-3 for P, and before the store O equals
the fp32 value to fp32 noise, where one bf16 rounding of P' (the TPU kernel's
pb) moves it by ten times more (run this file as a script with the batch,
256, to print the margins after the store).  Against JAX's ``_tf_fwd_call``
(the Pallas kernel in interpret mode, which rounds P and the mixed v to
bf16) on the same qkv and mixes, O agrees within 8e-3 and P within 4e-3;
at 12 heads of 128 those roundings take the Pallas kernel's own O 1.4e-2
from the fp32 function, and there the kernels' arithmetic is held nearer
the fp32 function than the Pallas kernel is.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import transform_attention as jta
from distillclip_tpu_torch.ops import transform_attention as ta

B = 2
O_LIMIT, P_LIMIT = 8e-3, 4e-3
LOG2E = 1.4426950408889634
# (H, d, N): the image and text students, a ragged sequence length, and the
# widest heads the tensor-core pair takes (32 heads, as the stage-1 ViT-L/14
# student's, and d = 128) at small N
SHAPES = {"image student": (24, 32, 50), "text student": (12, 64, 77), "ragged": (4, 16, 17),
          "32 heads": (32, 32, 20), "d = 128": (12, 128, 17)}


def _inputs(H, d, N, seed, batch=B):
    """bf16 qkv ``[batch·N, 3·H·d]`` and the mixes ``[H, H]``."""
    rng = np.random.default_rng(seed)
    bf = lambda shape, std=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * np.float32(std)).to(torch.bfloat16)
    return bf((batch * N, 3 * H * d)), bf((H, H), H ** -0.5), bf((H, H), H ** -0.5)


def _hi(x):
    return x.to(torch.bfloat16).float()


def _lo(x):
    return (x - _hi(x)).to(torch.bfloat16).float()


def kernel_arithmetic(qkv, wl, ww, H: int, N: int, split_pv: bool = True):
    """(O before its bf16 store, P), fp32, as the kernel computes them; with
    ``split_pv`` false P' enters P'·v rounded to bf16 once."""
    rows = qkv.shape[0]
    d = qkv.shape[1] // 3 // H
    batch = rows // N
    q, k, v = qkv.float().view(batch, N, 3, H, d).permute(2, 0, 3, 1, 4)   # [B, H, N, d]
    mix = lambda w, x: (torch.einsum("hg,bgnm->bhnm", w.float(), _hi(x))
                        + torch.einsum("hg,bgnm->bhnm", w.float(), _lo(x)))
    x = mix(wl, q @ k.transpose(-1, -2)) * np.float32(d ** -0.5 * LOG2E)
    m = torch.full(x.shape[:-1], -float("inf"))
    s = torch.zeros(x.shape[:-1])
    for j0 in range(0, N, 16):                   # pass 1, a chunk of 16 keys at a time
        xc = x[..., j0:j0 + 16]
        mn = torch.maximum(m, xc.amax(-1))
        s = s * torch.exp2(m - mn) + torch.exp2(xc - mn[..., None]).sum(-1)
        m = mn
    p = torch.exp2(x - (m + torch.log2(s))[..., None])
    pm = mix(ww, p)
    o = _hi(pm) @ v + (_lo(pm) @ v if split_pv else 0.0)
    return o.permute(0, 2, 1, 3).reshape(rows, H * d), p


def _jax_tf_fwd(qkv, wl, ww, H: int, N: int):
    """(O, P) of JAX's ``_tf_fwd_call`` with save-P on the same bf16 inputs,
    in its padded layout: rows padded to a multiple of 16 per sample, P as
    ``[B·Np, H·Np]`` with head-major columns."""
    rows, hd3 = qkv.shape
    d = hd3 // 3 // H
    batch, Np = rows // N, -(-N // 16) * 16
    padded = torch.zeros((batch, Np, hd3), dtype=torch.float32)
    padded[:, :N] = qkv.float().view(batch, N, hd3)
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    o, p = jta._tf_fwd_call(as_jax(padded.view(batch * Np, hd3)), as_jax(wl), as_jax(ww),
                            d ** -0.5, N, 1, Np, H, d, save_p=True)
    o = np.asarray(o.astype(jnp.float32)).reshape(batch, Np, H * d)[:, :N]
    p = np.asarray(p.astype(jnp.float32)).reshape(batch, Np, H, Np)[:, :N, :, :N]
    return o.reshape(rows, H * d), p.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_arithmetic_matches_fp32_plain_version(shape):
    H, d, N = SHAPES[shape]
    qkv, wl, ww = _inputs(H, d, N, seed=H * d + N)
    ref, rp = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(), heads=H,
                                                  seq=N, scale=d ** -0.5)
    split, p = kernel_arithmetic(qkv, wl, ww, H, N)
    assert float((split.to(torch.bfloat16).float() - ref).abs().max()) <= O_LIMIT
    assert float((p.to(torch.bfloat16).float() - rp).abs().max()) <= P_LIMIT
    # the margins: hi + lo is the fp32 function to fp32 noise; one bf16
    # rounding of P' is ten times further off before the store
    noise = float((split - ref).abs().max())
    assert noise <= 1e-4
    single = kernel_arithmetic(qkv, wl, ww, H, N, split_pv=False)[0]
    assert float((single - ref).abs().max()) > 10 * noise


# the shapes at which JAX's Pallas forward is itself within O_LIMIT of fp32
JAX_SHAPES = [shape for shape in SHAPES if shape != "d = 128"]


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=JAX_SHAPES)
def test_kernel_arithmetic_matches_jax_kernel(shape):
    """Against the Pallas forward of JAX's head-transform attention in
    interpret mode, with its saved probabilities, on the same qkv and mixes."""
    H, d, N = SHAPES[shape]
    qkv, wl, ww = _inputs(H, d, N, seed=H * d + N + 1)
    o, p = kernel_arithmetic(qkv, wl, ww, H, N)
    ref, rp = _jax_tf_fwd(qkv, wl, ww, H, N)
    np.testing.assert_allclose(o.to(torch.bfloat16).float().numpy(), ref, atol=O_LIMIT,
                               rtol=0)
    np.testing.assert_allclose(p.to(torch.bfloat16).float().numpy(), rp, atol=P_LIMIT, rtol=0)


def test_kernel_arithmetic_at_d_128_is_nearer_fp32_than_the_jax_kernel():
    """At 12 heads of 128 (|O| up to 3) JAX's Pallas forward rounds P and
    the mixed v to bf16 and lands 1.4e-2 from the fp32 function, past
    O_LIMIT; on the same inputs the kernels' arithmetic stays within O_LIMIT
    of it, nearer than the Pallas kernel, and so within O_LIMIT plus the
    Pallas kernel's own distance of the Pallas kernel.  P agrees within
    P_LIMIT."""
    H, d, N = SHAPES["d = 128"]
    qkv, wl, ww = _inputs(H, d, N, seed=H * d + N + 1)
    o, p = kernel_arithmetic(qkv, wl, ww, H, N)
    o = o.to(torch.bfloat16).float().numpy()
    ref, rp = _jax_tf_fwd(qkv, wl, ww, H, N)
    f32 = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(), heads=H,
                                              seq=N, scale=d ** -0.5)[0].numpy()
    ours, theirs = np.abs(o - f32).max(), np.abs(ref - f32).max()
    assert ours <= O_LIMIT and ours < theirs
    assert np.abs(o - ref).max() <= O_LIMIT + theirs
    np.testing.assert_allclose(p.to(torch.bfloat16).float().numpy(), rp, atol=P_LIMIT, rtol=0)


def margins(batch: int) -> None:
    """Print, per shape, the largest error of O against the fp32 plain version
    after the bf16 store with P' as hi + lo and with P' rounded once, and of
    the saved P: ``python tests/test_torch_transform_attention_rounding.py
    256`` for the batch ``chip_smoke.py`` runs."""
    for shape, (H, d, N) in SHAPES.items():
        qkv, wl, ww = _inputs(H, d, N, H * d + N, batch)
        ref, rp = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(),
                                                      heads=H, seq=N, scale=d ** -0.5)
        errs = []
        for split in (True, False):
            o, p = kernel_arithmetic(qkv, wl, ww, H, N, split_pv=split)
            errs.append(float((o.to(torch.bfloat16).float() - ref).abs().max()))
        perr = float((p.to(torch.bfloat16).float() - rp).abs().max())
        print(f"B={batch} {shape}: O with P' as hi + lo {errs[0]:.3e}, P' rounded once "
              f"{errs[1]:.3e} (limit {O_LIMIT:g}); P {perr:.3e} (limit {P_LIMIT:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else B)
