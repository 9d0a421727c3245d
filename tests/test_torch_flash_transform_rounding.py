"""The arithmetic of the tensor-core head-transform attention on ``[B, H, N,
d]`` views (#17, ``csrc/flash_transform_attention_mma.cu`` on the tile loop of
``csrc/transform_attention_mma.cuh``), written out in PyTorch, against the
fp32 plain version and the JAX package's kernel, on the CPU.

A block takes tiles of 16 query rows of a sample and walks the keys in chunks
of 16, only those its rows see: ceil(nk / 16) of them, nk = kv_len, under the
causal mask min(kv_len, i0 + 16).  Row i sees the keys below lim(i) = kv_len,
min(kv_len, i + 1) under the causal mask.  S = q·kᵀ per head from exact bf16
inputs, summed in fp32.  An fp32 operand enters a product as two bf16
operands, hi = bf16(x) and lo = bf16(x − hi), into one fp32 sum: S enters the
wl mix, L = scale·log2(e)·Σ_g wl·S (log2 units), −inf past lim(i).  Pass 1
keeps per (row, head) the running max m of L over the chunks and the sum Σ of
2^(L − m), rescaled by 2^(m_old − m_new) as m moves (key 0 of every chunk a
tile walks is below each of its rows' limits, so m stays finite).  Pass 2
makes P = 2^(L − m − log2 Σ) in fp32 (an exact 0 past lim(i)), P' = Σ_g ww·P
with P as hi + lo, and O = P'·v with P' as hi + lo, rounded once to bf16.

At the image and text student shapes (full), the text shape under the causal
mask, a ragged head shape with kv_len < N and the widest head shapes (32 heads
of 32, 16 of 128, 29 of 24 with kv_len < N: the instances that keep P' in
each warp's row of the score plane, whose arithmetic is the same, the mixes
reading the head columns past H as zeros) (B = 2; q, k at unit scale, v at
0.7, the mixes at std H^-1/2, ww at half that under the causal mask, as
``chip_smoke.py`` draws them) this arithmetic is held within 8e-3 of
``flash_transform_attention_fwd_plain`` in fp32 on the same inputs after the
bf16 store, and before the store it equals the fp32 value to fp32 noise (run
this file as a script with a batch, 256, for the margins).  Against JAX's
``flash_attention(..., head_transform=...)`` (``_tf_fwd``: the Pallas kernel
in interpret mode, which rounds the mixed P to bf16) on the same values, O
agrees within 8e-3.  The route test states which head shapes the tensor
cores take.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# ``ops.flash_attention`` is the public function in both packages; these are
# the modules
jfa = importlib.import_module("distillclip_tpu.ops.flash_attention")
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

B = 2
O_LIMIT = 8e-3
LOG2E = 1.4426950408889634
# (H, d, N, causal, kv_len)
SHAPES = {"image student": (24, 32, 50, False, None), "text student": (12, 64, 77, False, None),
          "causal": (12, 64, 77, True, None), "ragged": (5, 48, 33, False, 29),
          "32 heads": (32, 32, 33, False, None), "16 heads of 128": (16, 128, 20, False, None),
          "29 heads ragged": (29, 24, 33, False, 27)}


def _inputs(H, d, N, causal, seed, batch=B):
    """bf16 q, k, v ``[batch, H, N, d]`` (views of one fused projection) and
    the mixes ``[H, H]``."""
    rng = np.random.default_rng(seed)
    bf = lambda shape, std=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * np.float32(std)).to(torch.bfloat16)
    qkv = torch.cat([bf((batch, N, 2, H, d)), bf((batch, N, 1, H, d), 0.7)], dim=2)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v, bf((H, H), H ** -0.5), bf((H, H), H ** -0.5 * (0.5 if causal else 1.0))


def _hi(x):
    return x.to(torch.bfloat16).float()


def _lo(x):
    return (x - _hi(x)).to(torch.bfloat16).float()


def limits(N: int, causal: bool, kv_len):
    """lim(i) per query row: the keys below it are seen."""
    kv = N if kv_len is None else kv_len
    rows = torch.arange(N)
    return torch.minimum(rows + 1, torch.tensor(kv)) if causal else torch.full((N,), kv)


def kernel_arithmetic(q, k, v, wl, ww, causal: bool, kv_len, split_pv: bool = True):
    """O before its bf16 store, fp32 ``[B, H, N, d]``, as the kernel computes
    it; with ``split_pv`` false P' enters P'·v rounded to bf16 once."""
    N, d = q.shape[2], q.shape[3]
    kv = N if kv_len is None else kv_len
    q, k, v = q.float(), k.float(), v.float()
    mix = lambda w, x: (torch.einsum("hg,bgnm->bhnm", w.float(), _hi(x))
                        + torch.einsum("hg,bgnm->bhnm", w.float(), _lo(x)))
    x = mix(wl, q @ k.transpose(-1, -2)) * np.float32(d ** -0.5 * LOG2E)
    seen = torch.arange(N)[None, :] < limits(N, causal, kv_len)[:, None]     # [row, key]
    x = x.masked_fill(~seen, -float("inf"))
    m = torch.full(x.shape[:-1], -float("inf"))
    s = torch.zeros(x.shape[:-1])
    for i0 in range(0, N, 16):                       # a tile of 16 query rows
        rows = slice(i0, i0 + 16)
        nk = min(kv, i0 + 16) if causal else kv
        for j0 in range(0, nk, 16):                  # pass 1 over the chunks it walks
            xc = x[:, :, rows, j0:j0 + 16]
            mn = torch.maximum(m[:, :, rows], xc.amax(-1))
            s[:, :, rows] = (s[:, :, rows] * torch.exp2(m[:, :, rows] - mn)
                             + torch.exp2(xc - mn[..., None]).sum(-1))
            m[:, :, rows] = mn
    p = torch.exp2(x - (m + torch.log2(s))[..., None])
    pm = mix(ww, p)
    return _hi(pm) @ v + (_lo(pm) @ v if split_pv else 0.0)


def _plain(q, k, v, wl, ww, causal, kv_len):
    f32 = [t.float() for t in (q, k, v, wl, ww)]
    return fa.flash_transform_attention_fwd_plain(*f32, scale=q.shape[-1] ** -0.5,
                                                  causal=causal, kv_len=kv_len)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_arithmetic_matches_fp32_plain_version(shape):
    H, d, N, causal, kv_len = SHAPES[shape]
    q, k, v, wl, ww = _inputs(H, d, N, causal, seed=H * d + N)
    ref = _plain(q, k, v, wl, ww, causal, kv_len)
    split = kernel_arithmetic(q, k, v, wl, ww, causal, kv_len)
    assert float((split.to(torch.bfloat16).float() - ref).abs().max()) <= O_LIMIT
    # hi + lo is the fp32 function to fp32 noise before the store
    assert float((split - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_arithmetic_matches_jax_kernel(shape):
    """Against the Pallas forward of JAX's head-transform attention on [B, H,
    N, d] operands (``_tf_fwd`` in interpret mode), on the same values."""
    H, d, N, causal, kv_len = SHAPES[shape]
    q, k, v, wl, ww = _inputs(H, d, N, causal, seed=H * d + N + 1)
    o = kernel_arithmetic(q, k, v, wl, ww, causal, kv_len)
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ref = jfa.flash_attention(as_jax(q), as_jax(k), as_jax(v), scale=d ** -0.5, causal=causal,
                              head_transform=(as_jax(wl), as_jax(ww)), kv_len=kv_len)
    np.testing.assert_allclose(o.to(torch.bfloat16).float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=O_LIMIT, rtol=0)


def test_tensor_core_route_takes_the_students_head_shapes():
    """The head shapes the tensor-core kernel takes (the rest go to the
    CUDA-core route): d a multiple of 8 up to 128, at most 32 heads, 16 past
    d = 32, as K3 takes them; the wrapper asks the library, which the card
    tests hold to this."""
    taken = {(H, d) for H in range(1, 49) for d in range(4, 140, 4)
             if fa.tensor_core_head_shape(H, d)}
    assert {(24, 32), (12, 64), (3, 16), (5, 48), (16, 64), (24, 8), (32, 32), (29, 24),
            (25, 32), (16, 128), (12, 128), (16, 80), (4, 72)} <= taken
    assert not {(33, 32), (17, 40), (17, 128), (32, 64), (2, 136), (12, 12), (8, 4)} & taken
    assert taken == {(H, d) for d in range(8, 136, 8) for H in range(1, 33 if d <= 32 else 17)}


def margins(batch: int) -> None:
    """Print, per shape, the largest error of O against the fp32 plain version
    after the bf16 store with P' as hi + lo and with P' rounded once:
    ``python tests/test_torch_flash_transform_rounding.py 256`` for the batch
    ``chip_smoke.py`` runs."""
    for shape, (H, d, N, causal, kv_len) in SHAPES.items():
        q, k, v, wl, ww = _inputs(H, d, N, causal, H * d + N, batch)
        ref = _plain(q, k, v, wl, ww, causal, kv_len)
        errs = [float((kernel_arithmetic(q, k, v, wl, ww, causal, kv_len, split)
                       .to(torch.bfloat16).float() - ref).abs().max()) for split in (True, False)]
        print(f"B={batch} {shape}: O with P' as hi + lo {errs[0]:.3e}, P' rounded once "
              f"{errs[1]:.3e} (limit {O_LIMIT:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else B)
