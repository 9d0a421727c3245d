"""Head-transform attention past the tensor-core kernels' head shapes, on the CPU.

The JAX package's head-transform kernels take every head count from 12 up
(``distillclip_tpu/ops/transform_attention.py``; fewer go to XLA), limited
only by their VMEM scratch.  The port's tensor-core #5 / #6 hold every head of
a 16 x 16 tile in one block and so take at most 32 heads with d up to 32 and
16 with d up to 128 (``tensor_core_takes``); the training pair's second route,
the CUDA-core save-P forward and backward (``transform_attention_save_p_wide``,
``transform_attention_bwd_wide``), takes the other head shapes, which the
autograd function picks by shape before anything runs (``grad_route``) and
remembers for its backward.  Here:

* the routes' limits as stated in Python: the tensor-core pair's at every
  head shape within them and up to 256 tokens, its blocks within 227 KB; the
  wide route's (``wide_route_takes``): at 256 tokens it takes 48 heads of 8
  and 32 of 64, and refuses 257 tokens and head counts whose one query row of
  score planes would not fit; which pair trains each shape;
* the autograd function runs the backward of the route whose forward wrote P;
* the plain versions at wide head shapes against ``torch.autograd`` (fp32,
  1e-5 of the largest entry) and against the JAX package's kernels in
  interpret mode (``_tf_fwd_call(save_p=True)`` and ``_tf_bwd_call`` through
  ``jax.vjp``) at 32 heads of 8 and 12 heads of 96, N = 16, B = 2, held to
  the bf16 class of ROADMAP's kernel tolerance (those kernels round P, P∘dP
  and dS to bf16 whatever the input dtype): forward 0.008 and dqkv 0.03
  absolute, the mix gradients 0.6% of their largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.ops import transform_attention as jax_ta
from distillclip_tpu_torch.ops import _build
from distillclip_tpu_torch.ops import transform_attention as ta

B = 2


def _case(H, d, N, seed=0):
    """fp32 qkv ``[B·N, 3·H·d]``, the mixes (conv_l at std H^-1/2: logits of
    std ~1; conv_w at half that) and an output cotangent."""
    rng = np.random.default_rng(seed + H * d + N)
    f = lambda shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return ([f((B * N, 3 * H * d)), f((H, H), H ** -0.5), f((H, H), 0.5 * H ** -0.5)],
            f((B * N, H * d)))


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("seq,heads,d,takes", [
    (256, 32, 32, True), (256, 12, 128, True), (197, 32, 32, True), (256, 48, 8, True),
    (257, 32, 32, False), (256, 64, 8, False), (256, 32, 36, False), (16, 64, 8, True)])
def test_wide_route_limits(seq, heads, d, takes):
    """One query row's three fp32 backward planes of every head, the dO tile
    and three [H, H] mixes within a block's 232448 bytes, up to 256 tokens."""
    assert ta.wide_route_takes(seq, heads, d) is takes
    if d % 8 == 0 and seq <= ta.MAX_SEQ:
        fits = ta._wide_smem(seq, heads, d, 1, 3) <= _build.MAX_SMEM_BYTES
        assert fits is takes
        # the forward's two planes always fit where the backward's three do
        assert not takes or ta._wide_smem(seq, heads, d, 1, 2) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("seq", [1, 17, 197, 256])
def test_tensor_core_limits(seq):
    """The tensor-core pair takes every head shape up to 32 heads of 32 and
    16 heads of 128 (d a multiple of 8), and no other: its blocks' shared
    memory, as the library counts it, stays within 232448 bytes there."""
    for heads in range(1, 35):
        for d in range(8, 145, 8):
            within = heads <= 32 and d <= 32 or heads <= 16 and d <= 128
            assert ta.tensor_core_takes(seq, heads, d) is within, (seq, heads, d)
            if within:
                assert max(ta._tc_fwd_smem(heads, d),
                           ta._tc_bwd_smem(seq, heads, d)) <= _build.MAX_SMEM_BYTES
    assert not ta.tensor_core_takes(seq, 8, 36) and not ta.tensor_core_takes(257, 8, 32)


@pytest.mark.parametrize("seq,heads,d,route", [
    (197, 32, 32, "tensor_core"), (256, 32, 32, "tensor_core"), (256, 12, 128, "tensor_core"),
    (256, 16, 128, "tensor_core"), (50, 24, 32, "tensor_core"), (77, 12, 64, "tensor_core"),
    (17, 25, 8, "tensor_core"), (9, 2, 72, "tensor_core"), (256, 48, 8, "wide"),
    (256, 32, 64, "wide"), (16, 33, 8, "wide"), (33, 17, 48, "wide"), (17, 4, 136, "wide"),
    (257, 32, 32, None), (256, 64, 8, None)])
def test_route_by_head_shape(seq, heads, d, route):
    """The pair that trains each shape on the card: the tensor cores where
    they take it (32 heads of 32, the stage-1 ViT-L/14 student's, and 12 of
    128 among them), else the CUDA cores, else neither (``grad_route`` asks
    the library; ``tests/test_torch_cuda.py`` holds the two statements to
    it)."""
    tc, wide = ta.tensor_core_takes(seq, heads, d), ta.wide_route_takes(seq, heads, d)
    got = "tensor_core" if tc else "wide" if wide else None
    assert got == route
    # the CUDA-core pair takes every shape the tensor-core pair does
    assert wide or not tc


def test_cpu_tensors_train_on_the_plain_versions():
    qkv = torch.zeros(4, 3 * 32 * 8)
    assert ta.grad_route(qkv, heads=32, seq=2) == "plain"
    assert ta._GRAD_ROUTES["plain"] == (ta.transform_attention_save_p_plain,
                                        ta.transform_attention_bwd_plain)


def test_the_backward_is_the_route_that_wrote_p(monkeypatch):
    """The route is chosen once, in the forward: a backward that ran
    ``grad_route`` again would take the other pair here."""
    calls = []

    def recording(route, fn):
        def wrapper(*args, **kwargs):
            calls.append((route, fn.__name__))
            return fn(*args, **kwargs)
        return wrapper

    for route, (fwd, bwd) in (("wide", ta._GRAD_ROUTES["plain"]),
                              ("tensor_core", ta._GRAD_ROUTES["plain"])):
        monkeypatch.setitem(ta._GRAD_ROUTES, route, (recording(route, fwd),
                                                     recording(route, bwd)))
    (qkv, wl, ww), cot = _case(32, 8, 5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, wl, ww)]
    monkeypatch.setattr(ta, "grad_route", lambda *a, **k: "wide")
    out = ta.transform_attention_rows_qkv(*leaves, heads=32, seq=5)
    monkeypatch.setattr(ta, "grad_route", lambda *a, **k: "tensor_core")
    out.backward(torch.from_numpy(cot))
    assert calls == [("wide", "transform_attention_save_p_plain"),
                     ("wide", "transform_attention_bwd_plain")]
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.parametrize("H,d,N", [(32, 8, 17), (12, 96, 9), (32, 32, 5)])
def test_wide_head_gradients_match_torch_autograd(H, d, N):
    """The explicit backward formulas of #6 (both routes compute them) against
    autograd through the plain forward, fp32, 1e-5 of the largest entry."""
    arrays, cot = _case(H, d, N)
    kw = dict(heads=H, seq=N)
    grads = []
    for fn in (lambda *a: ta.transform_attention_rows_qkv(*a, **kw),
               lambda *a: ta.transform_attention_rows_qkv_plain(*a, **kw, scale=d ** -0.5)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        fn(*leaves).backward(torch.from_numpy(cot))
        grads.append([t.grad.numpy() for t in leaves])
    for g, r in zip(*grads):
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("H,d", [(32, 8), (12, 96)], ids=["32 heads of 8", "12 heads of 96"])
def test_wide_heads_match_jax_kernels(H, d):
    """The port's training pair on the CPU (the plain #5 and #6) against
    ``jax.vjp`` of the JAX entry point, which runs ``_tf_fwd_call(save_p=True)``
    and ``_tf_bwd_call`` in interpret mode at these head counts."""
    N = 16
    (qkv, wl, ww), cot = _case(H, d, N)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, wl, ww)]
    out = ta.transform_attention_rows_qkv(*leaves, heads=H, seq=N)
    out.backward(torch.from_numpy(cot))
    ref, vjp = jax.vjp(lambda *a: jax_ta.transform_attention_rows_qkv(*a, heads=H, seq=N),
                       *[jnp.asarray(a) for a in (qkv, wl, ww)])
    rdqkv, rdwl, rdww = (np.asarray(g, np.float32) for g in vjp(jnp.asarray(cot)))
    assert np.abs(out.detach().numpy() - np.asarray(ref, np.float32)).max() <= 0.008
    assert np.abs(leaves[0].grad.numpy() - rdqkv).max() <= 0.03
    assert _rel(leaves[1].grad.numpy(), rdwl) <= 0.006
    assert _rel(leaves[2].grad.numpy(), rdww) <= 0.006
