"""The arithmetic of the tensor-core head-transform attention backward (#6,
``csrc/transform_attention_bwd.cu``), written out in PyTorch, against the fp32
plain version and the JAX package's kernel, on the CPU.

The kernel reads the forward's saved bf16 P.  Its per-head products take
bf16 operands and sum in fp32: G = dO·vᵀ and S = q·kᵀ from exact bf16 inputs;
an fp32 operand enters a product as two bf16 operands, hi = bf16(x) and lo =
bf16(x − hi), into one fp32 sum.  So G enters the ww mix (dP = Σ_h ww·G) and
dww = Σ G∘P as hi + lo; dS2 = P∘(dP − δ) enters the wl mix (dS = scale·Σ_h
wl·dS2) and dwl = scale·Σ dS2∘S as hi + lo, against S as hi + lo (the hi·hi,
lo·hi and hi·lo terms); dS enters dq = dS·k and dk = dSᵀ·q as hi + lo (the
kernel hands dS to the second kernel as two bf16 planes); Pm = Σ_g ww·P, exact
in fp32, enters dv = Pmᵀ·dO as hi + lo.  P, dO, q, k, v and the mixes are
exact in bf16 and enter once.  The row sums δ = Σ_j P∘dP come from the same
head-pair sums per query row that make dww: δ_g = Σ_h ww[h, g]·Σ_j G_h∘P_g.
Each gradient of qkv is rounded once to bf16.

At the image and text student shapes and a ragged N = 17 (B = 2; qkv, dO at
unit scale, the mixes at std H^-1/2, as ``chip_smoke.py`` draws them; P from
the plain forward in bf16) this arithmetic is held within 3e-2 of
``transform_attention_bwd_plain`` in fp32 on the same inputs (dconv_l,
dconv_w within 6e-3 of their largest entry), and equals the fp32 values
before the store to fp32 noise, where one bf16 rounding of dS or of the
mixes' operands moves dq and dk by ten times more, and one of the head-pair
sums' operands moves dwl and dww by ten times more (run this file as a script
with the batch, 256, to print the margins after the store).  Against JAX's ``_tf_bwd_call`` (the Pallas
kernel in interpret mode, which rounds P∘dP and dS to bf16) on the same qkv,
dO, P and mixes, dqkv agrees within 3e-2 plus one bf16 step of either side's
rounding (2^-8 relative) and the mix gradients within 6e-3 of their largest
entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import transform_attention as jta
from distillclip_tpu_torch.ops import transform_attention as ta

B = 2
LIMIT, MIX_LIMIT = 3e-2, 6e-3
# (H, d, N): the image and text students, a ragged sequence length, and the
# widest heads the tensor-core pair takes (32 heads, as the stage-1 ViT-L/14
# student's, and d = 128) at small N
SHAPES = {"image student": (24, 32, 50), "text student": (12, 64, 77), "ragged": (4, 16, 17),
          "32 heads": (32, 32, 20), "d = 128": (12, 128, 17)}


def _inputs(H, d, N, seed, batch=B):
    """bf16 qkv ``[batch·N, 3·H·d]``, the mixes ``[H, H]``, dO ``[batch·N,
    H·d]`` and the saved bf16 P ``[batch, H, N, N]`` of the plain forward."""
    rng = np.random.default_rng(seed)
    bf = lambda shape, std=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * np.float32(std)).to(torch.bfloat16)
    qkv, do = bf((batch * N, 3 * H * d)), bf((batch * N, H * d))
    wl, ww = bf((H, H), H ** -0.5), bf((H, H), H ** -0.5)
    p = ta.transform_attention_save_p_plain(qkv, wl, ww, heads=H, seq=N, scale=d ** -0.5)[1]
    return qkv, wl, ww, do, p


def _hi(x):
    return x.to(torch.bfloat16).float()


def _lo(x):
    return (x - _hi(x)).to(torch.bfloat16).float()


def kernel_arithmetic(qkv, wl, ww, do, p, H: int, N: int, split_ds: bool = True,
                      split_pairs: bool = True, split_mix: bool = True):
    """(dqkv before its bf16 store, dwl, dww), fp32, as the kernel computes
    them.  Each flag set: that fp32 operand as bf16 hi + lo, else rounded to
    bf16 once: ``split_ds`` dS into dq and dk, ``split_pairs`` G, dS2 and S
    into the head-pair sums (dww, the row sums δ, dwl), ``split_mix`` G and
    dS2 into the two head mixes."""
    rows = qkv.shape[0]
    d = qkv.shape[1] // 3 // H
    batch, scale = rows // N, d ** -0.5
    q, k, v = qkv.float().view(batch, N, 3, H, d).permute(2, 0, 3, 1, 4)
    do4 = do.float().view(batch, N, H, d).permute(0, 2, 1, 3)
    wl32, ww32, p32 = wl.float(), ww.float(), p.float()
    parts = lambda x, split: (_hi(x), _lo(x)) if split else (_hi(x),)
    mix = lambda w, x: sum(torch.einsum("hg,bhnm->bgnm", w, y)      # out_g = Σ_h w[h, g] x_h
                           for y in parts(x, split_mix))
    g = do4 @ v.transpose(-1, -2)
    # per query row i the head-pair sums M[h, g](i) = Σ_j G_h ∘ P_g, whose sum
    # over the rows is dww, and δ_g(i) = Σ_h ww[h, g] · M[h, g](i) = Σ_j P_g ∘ dP_g
    rowpairs = sum(torch.einsum("bhij,bgij->bihg", x, p32) for x in parts(g, split_pairs))
    dww = rowpairs.sum((0, 1))
    delta = torch.einsum("hg,bihg->bgi", ww32, rowpairs)
    ds2 = p32 * (mix(ww32, g) - delta[..., None])
    s = q @ k.transpose(-1, -2)
    pairs = lambda x, y: torch.einsum("bhnm,bgnm->hg", x, y)
    if split_pairs:
        dwl = pairs(_hi(ds2), _hi(s)) + pairs(_lo(ds2), _hi(s)) + pairs(_hi(ds2), _lo(s))
    else:
        dwl = pairs(_hi(ds2), _hi(s))
    dwl = scale * dwl
    ds = scale * mix(wl32, ds2)
    dq = sum(x @ k for x in parts(ds, split_ds))
    dk = sum(x.transpose(-1, -2) @ q for x in parts(ds, split_ds))
    pm = torch.einsum("hg,bgnm->bhnm", ww32, p32)
    dv = (_hi(pm).transpose(-1, -2) @ do4) + (_lo(pm).transpose(-1, -2) @ do4)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, 3 * H * d)
    return dqkv, dwl, dww


def _rel_to_max(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _jax_tf_bwd(qkv, wl, ww, do, p, H: int, N: int):
    """(dqkv, dwl, dww) of JAX's ``_tf_bwd_call`` on the same bf16 inputs, in
    its padded layout: rows padded to a multiple of 16 per sample, P as
    ``[B·Np, H·Np]`` with head-major columns."""
    rows, hd3 = qkv.shape
    d = hd3 // 3 // H
    batch, Np = rows // N, -(-N // 16) * 16

    def pad_rows(x):
        out = torch.zeros((batch, Np, x.shape[1]), dtype=torch.float32)
        out[:, :N] = x.float().view(batch, N, -1)
        return out.view(batch * Np, -1)

    pp = torch.zeros((batch, H, Np, Np), dtype=torch.float32)
    pp[:, :, :N, :N] = p.float()
    p2 = pp.permute(0, 2, 1, 3).reshape(batch * Np, H * Np)
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    dqkv, dwl, dww = jta._tf_bwd_call(as_jax(pad_rows(qkv)), as_jax(wl), as_jax(ww),
                                      as_jax(pad_rows(do)), as_jax(p2), d ** -0.5, N, 1, Np,
                                      H, d)
    dqkv = np.asarray(dqkv.astype(jnp.float32)).reshape(batch, Np, hd3)[:, :N]
    return (dqkv.reshape(rows, hd3), np.array(dwl, dtype=np.float32),
            np.array(dww, dtype=np.float32))


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_arithmetic_matches_fp32_plain_version(shape):
    H, d, N = SHAPES[shape]
    qkv, wl, ww, do, p = _inputs(H, d, N, seed=H * d + N)
    ref, rdwl, rdww = ta.transform_attention_bwd_plain(
        qkv.float(), wl.float(), ww.float(), do.float(), p.float(), heads=H, seq=N,
        scale=d ** -0.5)
    split, dwl, dww = kernel_arithmetic(qkv, wl, ww, do, p, H, N)
    assert float((split.to(torch.bfloat16).float() - ref).abs().max()) <= LIMIT
    assert _rel_to_max(dwl, rdwl) <= MIX_LIMIT and _rel_to_max(dww, rdww) <= MIX_LIMIT
    # the margins: hi + lo is the fp32 function to fp32 noise; one rounding of
    # dS, of the head mixes' operands or of the head-pair sums' operands is ten
    # times further off before the store (dq and dk; dwl and dww)
    noise = float((split - ref).abs().max())
    assert noise <= 1e-4
    pair_noise = max(_rel_to_max(dwl, rdwl), _rel_to_max(dww, rdww))
    assert pair_noise <= 1e-4
    HD = H * d
    for flag in ("split_ds", "split_mix"):
        single = kernel_arithmetic(qkv, wl, ww, do, p, H, N, **{flag: False})[0]
        assert float((single - ref)[:, :2 * HD].abs().max()) > 10 * noise, flag
    _, sdwl, sdww = kernel_arithmetic(qkv, wl, ww, do, p, H, N, split_pairs=False)
    assert min(_rel_to_max(sdwl, rdwl), _rel_to_max(sdww, rdww)) > 10 * pair_noise


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_arithmetic_matches_jax_kernel(shape):
    """Against the Pallas backward of JAX's head-transform attention in
    interpret mode, on the same qkv, dO, P and mixes."""
    H, d, N = SHAPES[shape]
    qkv, wl, ww, do, p = _inputs(H, d, N, seed=H * d + N + 1)
    got, dwl, dww = kernel_arithmetic(qkv, wl, ww, do, p, H, N)
    ref, rdwl, rdww = _jax_tf_bwd(qkv, wl, ww, do, p, H, N)
    got = got.to(torch.bfloat16).float().numpy()
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, atol=LIMIT, rtol=2.0 ** -8)
    assert _rel_to_max(dwl, torch.from_numpy(rdwl)) <= MIX_LIMIT
    assert _rel_to_max(dww, torch.from_numpy(rdww)) <= MIX_LIMIT


def margins(batch: int) -> None:
    """Print, per shape, the largest error of dq, dk, dv against the fp32
    plain version after the bf16 store, and of the mix gradients, with every
    fp32 operand as hi + lo and with each kind rounded once: ``python
    tests/test_torch_transform_attention_bwd_rounding.py 256`` for the batch
    ``chip_smoke.py`` runs."""
    for shape, (H, d, N) in SHAPES.items():
        qkv, wl, ww, do, p = _inputs(H, d, N, H * d + N, batch)
        ref, rdwl, rdww = ta.transform_attention_bwd_plain(
            qkv.float(), wl.float(), ww.float(), do.float(), p.float(), heads=H, seq=N,
            scale=d ** -0.5)
        HD = H * d
        variants = {"hi + lo everywhere": {}, "dS rounded once": {"split_ds": False},
                    "mix operands rounded once": {"split_mix": False},
                    "pair-sum operands rounded once": {"split_pairs": False}}
        for name, flags in variants.items():
            out, dwl, dww = kernel_arithmetic(qkv, wl, ww, do, p, H, N, **flags)
            err = (out.to(torch.bfloat16).float() - ref).abs()
            errs = [float(err[:, i * HD:(i + 1) * HD].max()) for i in range(3)]
            print(f"B={batch} {shape}, {name}: dq, dk, dv "
                  + ", ".join(f"{e:.3e}" for e in errs) + f" (limit {LIMIT:g}); dwl, dww "
                  f"{_rel_to_max(dwl, rdwl):.2e}, {_rel_to_max(dww, rdww):.2e} of the "
                  f"largest entry (limit {MIX_LIMIT:g})")


if __name__ == "__main__":
    import sys

    margins(int(sys.argv[1]) if len(sys.argv) > 1 else B)
