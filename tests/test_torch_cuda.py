"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one.  The GPU machine has no JAX, so run this file without the suite's
conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels store bf16, which rounds an output y by up to
2^-9·|y|, so each check allows 1e-2 absolute plus 1e-2 relative against the
plain version in fp32 on the same bf16 inputs.
"""

import numpy as np
import pytest
import torch

from distillclip_tpu_torch import ops
from distillclip_tpu_torch.ops import fc1_act, layer_norm, plain_attention as pa
from distillclip_tpu_torch.ops import transform_attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16(rng, shape, std=1.0, mean=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
    return torch.from_numpy(a).cuda().to(torch.bfloat16)


def _close(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


# -- K1 / K2 at ragged row counts, widths and column counts ---------------------

@pytest.mark.parametrize("rows,C,N", [(1, 32, 8), (63, 96, 136), (65, 768, 2304),
                                      (130, 256, 520)])
@pytest.mark.parametrize("act,bias", [(None, True), (None, False), ("gelu_exact", True),
                                      ("quick_gelu", True)],
                         ids=["dense_ln", "dense_ln_no_bias", "gelu_exact", "quick_gelu"])
def test_dense_ln_kernels_match_plain(rows, C, N, act, bias):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1) if bias else None
    with torch.inference_mode():
        if act is None:
            out = fc1_act.dense_ln(x, ls, lb, w, b)
        else:
            out = fc1_act.dense_act_ln(x, ls, lb, w, b, act)
        ref = fc1_act.dense_ln_plain(x.float(), ls.float(), lb.float(), w.float(),
                                     None if b is None else b.float(), act=act)
    assert out.shape == (rows, N)
    _close(out, ref)


# -- K3 over head counts and sequence lengths -------------------------------------

# (B, H, d, N) at the tensor-core kernel's tile edges: one head and the most
# it takes, d padded to 16 (8) or not (16), N at one, a whole 16-key chunk,
# one past it, two past it and the backward's largest
_TF_EDGES = [(2, H, d, N) for H in (1, 24) for d in (8, 16) for N in (1, 16, 17, 33, 256)]
# head shapes with P' in the score plane X (past 24 heads, or d > 64): 32 heads
# of 32 (the stage-1 ViT-L/14 student) and of 8, 25 heads (the mixes' masked
# head columns), 12 and 16 heads of 128 (one k and one v buffer), d = 72, 80
# and 120 (d not a multiple of 16), at ragged lengths down to 1 token
_TF_PIX = [(2, 32, 32, 197), (2, 32, 8, 256), (2, 25, 8, 17), (2, 29, 24, 1),
           (2, 16, 128, 256), (2, 12, 128, 77), (3, 2, 72, 9), (2, 16, 80, 50),
           (2, 9, 120, 17), (2, 1, 128, 33)]
# head shapes past the tensor-core kernel (H > 32; H > 16 with d > 32; d > 128):
# the lean forward's second route, the CUDA-core kernel
_TF_WIDE = [(2, 33, 8, 16), (2, 48, 8, 50), (2, 17, 48, 33), (2, 32, 40, 1), (2, 4, 136, 17)]


def _tensor_core_heads(H, d):
    return ta._tc_heads_per_warp(H, d) > 0


@pytest.mark.parametrize("B,H,d,N", [(3, 1, 8, 1), (5, 4, 16, 17), (4, 24, 32, 50),
                                     (4, 12, 64, 77), (2, 2, 8, 256), (2, 16, 64, 256)]
                         + _TF_EDGES + _TF_PIX + _TF_WIDE)
def test_transform_attention_kernel_matches_plain(B, H, d, N):
    rng = np.random.default_rng(B * H * N)
    qkv = _bf16(rng, (B * N, 3 * H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), 0.5 * H ** -0.5)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = ta.transform_attention_rows_qkv(qkv, wl, ww, heads=H, seq=N)
        ref = ta.transform_attention_rows_qkv_plain(qkv.float(), wl.float(), ww.float(),
                                                    heads=H, seq=N, scale=d ** -0.5)
    assert out.shape == (B * N, H * d)
    _close(out, ref)
    route = ("transform_attention_rows_qkv" if _tensor_core_heads(H, d)
             else "transform_attention_rows_qkv_wide")
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), route: 1}


# -- K4 -------------------------------------------------------------------------------

@pytest.mark.parametrize("rows,C", [(1, 8), (9, 768), (1000, 1024), (77, 40)])
def test_layer_norm_kernel_matches_plain(rows, C):
    rng = np.random.default_rng(rows + C)
    x, s, b = _bf16(rng, (rows, C), 3.0, 1.0), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    with torch.inference_mode():
        out = layer_norm.layer_norm_rows(x, s, b)
        ref = layer_norm.layer_norm_rows_plain(x.float(), s.float(), b.float())
    _close(out, ref)


# -- the training kernels: statistics, residuals, backward ---------------------------
#
# Limits: a bf16 output against fp32 as above; the fp32 reductions (dγ, dβ,
# dconv_l, dconv_w) within 6e-3 of their largest entry; the saved P within
# 4e-3 (bf16 of a probability); mean and rstd within 1e-5 relative.

def _rel_to_max(out, ref):
    """Largest error over the largest reference entry (0 when both are zero)."""
    err = float((out.float() - ref.float()).abs().max())
    return err / max(float(ref.float().abs().max()), 1e-30) if err else 0.0


@pytest.mark.parametrize("rows,C,N", [(63, 96, 136), (65, 768, 2304), (130, 256, 520)])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_dense_ln_stats_mode_matches_lean_and_plain(rows, C, N, bias):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1) if bias else None
    lean, none1, none2 = fc1_act.dense_ln_fwd(x, ls, lb, w, b)
    u, mean, rstd = fc1_act.dense_ln_fwd(x, ls, lb, w, b, stats=True)
    torch.cuda.synchronize()
    assert none1 is None and none2 is None and torch.equal(u, lean)
    _, rmean, rrstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w, b)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)


@pytest.mark.parametrize("rows,C,N", [(63, 96, 136), (65, 768, 3072)])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_ln_residual_mode_matches_lean_and_plain(rows, C, N, act):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1)
    with torch.inference_mode():
        lean = fc1_act.dense_act_ln(x, ls, lb, w, b, act)
    h, u, e, mean, rstd = fc1_act.dense_act_ln_res(x, ls, lb, w, b, act)
    torch.cuda.synchronize()
    assert torch.equal(h, lean)
    _, ru, re, rmean, rrstd = fc1_act.dense_act_ln_res_plain(
        x.float(), ls.float(), lb.float(), w.float(), b.float(), act)
    _close(u, ru)
    _close(e, re)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)


@pytest.mark.parametrize("rows,C,N", [(1, 32, 8), (63, 96, 136), (65, 768, 2304),
                                      (130, 256, 520), (97, 768, 3072)])
def test_dense_ln_bwd_kernel_matches_plain(rows, C, N):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, du = _bf16(rng, (C, N), N ** -0.5), _bf16(rng, (rows, N))
    _, mean, rstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w)
    dx, xn, dls, dlb = fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
    rdx, rxn, rdls, rdlb = fc1_act.dense_ln_bwd_plain(
        x.float(), ls.float(), lb.float(), w.float(), du.float(), mean, rstd)
    _close(dx, rdx)
    _close(xn, rxn)
    assert dls.dtype == torch.float32 and dlb.dtype == torch.float32
    assert _rel_to_max(dls, rdls) < 6e-3 and _rel_to_max(dlb, rdlb) < 6e-3


@pytest.mark.parametrize("rows,C,N", [(63, 96, 136), (200, 768, 3072), (256, 768, 3072),
                                      (333, 1024, 4096), (384, 1024, 4096)])
@pytest.mark.parametrize("res", ["ue", "u"])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_ln_bwd_activation_mode_matches_plain(rows, C, N, act, res):
    """#9 given dh, u and e (K2's backward; e recomputed under ``res="u"``),
    at the cells' fc1 widths and a ragged one: du against the plain
    ``_act_du`` on the same bf16 values, dx, xn, dγ, dβ against the plain
    version, dW from the stored du against the plain dW; the du mode on the
    stored du gives the same bits (the product read the stored du), and two
    calls give the same bits."""
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b, dh = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1), _bf16(rng, (rows, N))
    _, u, e, mean, rstd = fc1_act.dense_act_ln_res(x, ls, lb, w, b, act)
    e = e if res == "ue" else None
    ops.reset_launch_counts()
    out = fc1_act.dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, act, u, e)
    again = fc1_act.dense_ln_bwd(x, ls, lb, w, dh, mean, rstd, act, u, e)
    torch.cuda.synchronize()
    assert fc1_act.dense_ln_bwd.launches == fc1_act.dense_ln_bwd.act_launches == 2
    assert all(torch.equal(o, a) for o, a in zip(out, again))
    dx, xn, dls, dlb, du = out
    rdx, rxn, rdls, rdlb, rdu = fc1_act.dense_ln_bwd_plain(
        x.float(), ls.float(), lb.float(), w.float(), dh, mean, rstd, act, u, e)
    _close(du, rdu)
    _close(dx, rdx)
    _close(xn, rxn)
    assert dls.dtype == torch.float32 and dlb.dtype == torch.float32
    assert _rel_to_max(dls, rdls) < 6e-3 and _rel_to_max(dlb, rdlb) < 6e-3
    dw, db = fc1_act._weight_grads(xn, du, w, True)
    assert _rel_to_max(dw, rxn.t() @ rdu.float()) < 1e-2
    assert _rel_to_max(db, rdu.float().sum(0)) < 1e-2
    same = fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
    assert all(torch.equal(o, s) for o, s in zip(out, same))


@pytest.mark.parametrize("rows,C", [(1, 8), (9, 768), (256, 768), (77, 40)])
def test_layer_norm_stats_and_bwd_kernels_match_plain(rows, C):
    rng = np.random.default_rng(rows + C)
    x, s, b = _bf16(rng, (rows, C), 3.0, 1.0), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    g = _bf16(rng, (rows, C))
    lean = layer_norm.layer_norm_rows_fwd(x, s, b)[0]
    y, mean, rstd = layer_norm.layer_norm_rows_fwd(x, s, b, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(y, lean)
    _, rmean, rrstd = layer_norm.layer_norm_rows_stats_plain(x, s, b)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)
    dx, ds, db = layer_norm.layer_norm_rows_bwd(x, s, g, mean, rstd)
    rdx, rds, rdb = layer_norm.layer_norm_rows_bwd_plain(x.float(), s.float(), g.float(),
                                                         mean, rstd)
    _close(dx, rdx)
    assert _rel_to_max(ds, rds) < 6e-3 and _rel_to_max(db, rdb) < 6e-3


@pytest.mark.parametrize("B,H,d,N", [(3, 1, 8, 1), (5, 4, 16, 17), (4, 24, 32, 50),
                                     (4, 12, 64, 77), (2, 3, 8, 40), (2, 2, 8, 256),
                                     (2, 16, 64, 256)] + _TF_EDGES + _TF_PIX)
def test_transform_attention_save_p_and_bwd_match_plain(B, H, d, N):
    rng = np.random.default_rng(B * H * N)
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), 0.5 * H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    with torch.inference_mode():
        lean = ta.transform_attention_rows_qkv(qkv, wl, ww, **kw)
    o, p = ta.transform_attention_save_p(qkv, wl, ww, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, lean) and p.shape == (B, H, N, N) and p.dtype == torch.bfloat16
    _, rp = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(), **kw)
    assert float((p.float() - rp).abs().max()) < 4e-3
    dqkv, dwl, dww = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    rdqkv, rdwl, rdww = ta.transform_attention_bwd_plain(
        qkv.float(), wl.float(), ww.float(), do.float(), p.float(), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(dqkv.float(), rdqkv, atol=3e-2, rtol=1e-2)
    assert dwl.dtype == torch.float32 and dww.dtype == torch.float32
    if N == 1 and H > 1:
        # one key: P = 1, so dS2 and dconv_l are exactly 0; with more than one
        # head the kernel's are fp32 noise of dP − δ, which it sums over the
        # heads in another order (with one head they are exactly 0)
        assert float(rdwl.abs().max()) == 0 and float(dwl.abs().max()) < 1e-5
        assert _rel_to_max(dww, rdww) < 6e-3
    else:
        assert _rel_to_max(dwl, rdwl) < 6e-3 and _rel_to_max(dww, rdww) < 6e-3


@pytest.mark.parametrize("B,H,d,N", [(64, 24, 32, 50), (64, 24, 32, 33), (67, 12, 64, 77),
                                     (300, 4, 16, 17), (24, 32, 32, 197), (41, 12, 128, 77),
                                     (35, 16, 128, 50)])
def test_transform_attention_forward_takes_many_tiles_a_block(B, H, d, N):
    """More tiles of 16 query rows than the card has SMs, so each of the
    tensor-core kernel's persistent blocks takes several in turn (the next
    tile's q, k and v copied during the last one, or once the last one has
    read its k and v where a block holds one buffer of each: 12 and 16 heads
    of 128), at even and odd tile counts per sample, and P stored as 4-byte
    pairs (even N) or 2-byte values (odd N)."""
    rng = np.random.default_rng(B + H + N)
    qkv = _bf16(rng, (B * N, 3 * H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    with torch.inference_mode():
        lean = ta.transform_attention_rows_qkv(qkv, wl, ww, **kw)
    o, p = ta.transform_attention_save_p(qkv, wl, ww, **kw)
    ro, rp = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, lean)
    torch.testing.assert_close(o.float(), ro, atol=8e-3, rtol=0)
    assert float((p.float() - rp).abs().max()) < 4e-3


def test_backward_is_deterministic():
    """The reductions across blocks run in a fixed order: two runs give the
    same bits."""
    rng = np.random.default_rng(5)
    B, H, d, N = 8, 12, 64, 77
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = ta.transform_attention_save_p(qkv, wl, ww, **kw)
    a = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    b = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("N", [50, 77, 17])
@pytest.mark.parametrize("H,d", [(24, 32), (12, 64), (20, 32)],
                         ids=["image heads", "text heads", "two heads a warp"])
def test_transform_attention_bwd_at_tile_edges(H, d, N):
    """#6 on the tensor cores at the students' head shapes, at 20 heads (two
    a warp, the last pair half empty), and at sequence lengths that leave a
    ragged last tile of 16 rows (and keys): one launch, dqkv within 3e-2 of
    the fp32 plain version, the mix gradients within 6e-3 of their largest
    entry."""
    rng = np.random.default_rng(H * d + N)
    B = 3
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = ta.transform_attention_save_p_plain(qkv, wl, ww, **kw)
    ops.reset_launch_counts()
    dqkv, dwl, dww = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    rdqkv, rdwl, rdww = ta.transform_attention_bwd_plain(
        qkv.float(), wl.float(), ww.float(), do.float(), p.float(), **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["transform_attention_bwd"] == 1
    assert dqkv.dtype == torch.bfloat16 and torch.isfinite(dqkv.float()).all()
    assert float((dqkv.float() - rdqkv).abs().max()) <= 3e-2
    assert _rel_to_max(dwl, rdwl) < 6e-3 and _rel_to_max(dww, rdww) < 6e-3


def test_transform_attention_bwd_is_deterministic_at_the_image_heads():
    """24 heads (two a warp in the mixes' M and K): two runs, the same bits."""
    rng = np.random.default_rng(6)
    B, H, d, N = 8, 24, 32, 50
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = ta.transform_attention_save_p(qkv, wl, ww, **kw)
    a = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    b = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("H,d,N", [(32, 32, 197), (16, 128, 77)],
                         ids=["32 heads of 32", "16 heads of 128"])
def test_transform_attention_bwd_is_deterministic_past_24_heads_and_d_64(H, d, N):
    """The row kernel's register tiles and the dq / dk kernel's column
    halves: two runs, the same bits."""
    rng = np.random.default_rng(H + d)
    B = 6
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = ta.transform_attention_save_p(qkv, wl, ww, **kw)
    a = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    b = ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_transform_attention_bwd_refuses_heads_it_does_not_take():
    rng = np.random.default_rng(7)
    for H, d in ((33, 8), (17, 48), (2, 136)):
        qkv, do = _bf16(rng, (8, 3 * H * d)), _bf16(rng, (8, H * d))
        w = _bf16(rng, (H, H))
        p = torch.zeros((1, H, 8, 8), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="do not fit"):
            ta.transform_attention_bwd(qkv, w, w, do, p, heads=H, seq=8, scale=1.0)


def test_training_forward_refuses_what_the_backward_does_not_take():
    """The tensor-core save-P forward refuses a head shape that #6 would
    refuse, before it launches; under autograd such a shape trains on the
    second route (the CUDA-core save-P forward), and the lean forward takes it
    on K3's second route."""
    rng = np.random.default_rng(8)
    for H, d in ((33, 8), (17, 48), (2, 136)):
        qkv, w = _bf16(rng, (8, 3 * H * d)), _bf16(rng, (H, H))
        kw = dict(heads=H, seq=8, scale=1.0)
        ref = ta.transform_attention_rows_qkv_plain(qkv.float(), w.float(), w.float(), **kw)
        ops.reset_launch_counts()
        with pytest.raises(ValueError, match="do not fit"):
            ta.transform_attention_save_p(qkv, w, w, **kw)
        assert ops.launch_counts()["transform_attention_save_p"] == 0
        o = ta.transform_attention_rows_qkv(qkv.clone().requires_grad_(), w, w, **kw)
        _close(o.detach(), ref)
        assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                       "transform_attention_save_p_wide": 1}
        with torch.inference_mode():
            o = ta.transform_attention_rows_qkv(qkv, w, w, **kw)
        _close(o, ref)


# -- #5 / #6's second route: the training pair at wide head shapes -----------------

# (B, H, d, N): the CUDA-core pair called directly, off any route, held against plain
# at shapes inside the tensor-core limits (32 heads of 32 at 197 and 256 tokens, 12 of 128,
# (25, 8) and (2, 72) at ragged lengths down to 1 token) and past them (48 heads of 8 at
# 256 tokens, near the CUDA-core route's own limit; 17 of 48)
_TF_WIDE_GRAD = [(4, 32, 32, 197), (2, 32, 32, 256), (2, 12, 128, 256), (3, 12, 128, 197),
                 (2, 48, 8, 256), (2, 25, 8, 17), (2, 17, 48, 33), (3, 2, 72, 1)]


@pytest.mark.parametrize("B,H,d,N", _TF_WIDE_GRAD)
def test_wide_save_p_and_bwd_match_plain(B, H, d, N):
    """ROADMAP's kernel tolerance: o within 8e-3 and P within 4e-3 absolute
    (o the lean second route's bits), dqkv within 3e-2 absolute, the mix
    gradients within 6e-3 of their largest entry."""
    rng = np.random.default_rng(B * H * N + d)
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), 0.5 * H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    with torch.inference_mode():
        lean = ta.transform_attention_rows_qkv_wide(qkv, wl, ww, **kw)
    ops.reset_launch_counts()
    o, p = ta.transform_attention_save_p_wide(qkv, wl, ww, **kw)
    ro, rp = ta.transform_attention_save_p_plain(qkv.float(), wl.float(), ww.float(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, lean) and p.shape == (B, H, N, N) and p.dtype == torch.bfloat16
    assert float((o.float() - ro).abs().max()) <= 8e-3
    assert float((p.float() - rp).abs().max()) <= 4e-3
    dqkv, dwl, dww = ta.transform_attention_bwd_wide(qkv, wl, ww, do, p, **kw)
    rdqkv, rdwl, rdww = ta.transform_attention_bwd_plain(
        qkv.float(), wl.float(), ww.float(), do.float(), p.float(), **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "transform_attention_save_p_wide": 1,
                                   "transform_attention_bwd_wide": 1}
    assert dqkv.dtype == torch.bfloat16 and torch.isfinite(dqkv.float()).all()
    assert float((dqkv.float() - rdqkv).abs().max()) <= 3e-2
    assert dwl.dtype == torch.float32 and dww.dtype == torch.float32
    if N == 1:      # one key: dconv_l is 0 up to fp32 noise of dP − δ
        assert float(rdwl.abs().max()) == 0 and float(dwl.abs().max()) < 1e-5
    else:
        assert _rel_to_max(dwl, rdwl) < 6e-3
    assert _rel_to_max(dww, rdww) < 6e-3


@pytest.mark.parametrize("H,d,N,route", [
    (24, 32, 50, "tensor_core"), (12, 64, 77, "tensor_core"), (16, 64, 256, "tensor_core"),
    (4, 16, 17, "tensor_core"), (32, 32, 197, "tensor_core"), (12, 128, 256, "tensor_core"),
    (25, 8, 16, "tensor_core"), (2, 72, 9, "tensor_core"), (48, 8, 256, "wide"),
    (32, 64, 197, "wide"), (33, 8, 16, "wide"), (17, 48, 33, "wide")])
def test_training_routes_by_head_shape(H, d, N, route):
    """Under autograd the tensor-core shapes still take #5 and #6 on the tensor
    cores and the others the second route, one launch each, and the
    gradients are the plain autograd's."""
    rng = np.random.default_rng(H + d + N)
    B = 2
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), 0.5 * H ** -0.5)
    assert ta.grad_route(qkv, H, N) == route
    want = ({"transform_attention_save_p": 1, "transform_attention_bwd": 1}
            if route == "tensor_core" else
            {"transform_attention_save_p_wide": 1, "transform_attention_bwd_wide": 1})
    leaves = [t.clone().requires_grad_() for t in (qkv, wl, ww)]
    ops.reset_launch_counts()
    ta.transform_attention_rows_qkv(*leaves, heads=H, seq=N).backward(do)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), **want}
    ref = [t.float().requires_grad_() for t in (qkv, wl, ww)]
    ta.transform_attention_rows_qkv_plain(*ref, heads=H, seq=N, scale=d ** -0.5).backward(
        do.float())
    assert float((leaves[0].grad.float() - ref[0].grad).abs().max()) <= 3e-2
    for g, r in zip(leaves[1:], ref[1:]):
        # the bf16 mixes also round their own gradient (2^-9 relative)
        assert g.grad.dtype == torch.bfloat16 and _rel_to_max(g.grad, r.grad) < 6e-3 + 2 ** -8


def test_tensor_core_limits_are_the_librarys():
    """``tensor_core_takes`` and its shared-memory counts state the
    library's: the route ``grad_route`` asks the library for, and each
    block's bytes where the pair takes the shape."""
    from distillclip_tpu_torch.ops import _build

    lib = _build.lib()
    for N in (1, 16, 17, 50, 197, 256, 257):
        for H in (1, 2, 12, 16, 17, 24, 25, 32, 33, 48):
            for d in (8, 16, 24, 32, 40, 64, 72, 80, 96, 120, 128, 136):
                takes = ta.tensor_core_takes(N, H, d)
                assert takes == ta._tc_takes(lib, N, H, d), (N, H, d)
                if takes:
                    assert ta._tc_bwd_smem(N, H, d) == lib.dc_tf_bwd_smem_bytes(N, H, d)
                    assert ta._tc_fwd_smem(H, d) == lib.dc_tf_fwd_mma_smem_bytes(H, d)
                    assert ta._tensor_core_shape(lib, H, d)


def test_wide_route_limits_are_the_librarys():
    """``wide_route_takes`` and its shared-memory count state the library's."""
    from distillclip_tpu_torch.ops import _build

    lib = _build.lib()
    for N in (1, 17, 197, 256):
        for H in (1, 12, 24, 25, 32, 48, 64, 80):
            for d in (8, 32, 64, 128):
                for tq in (1, 5, 16):
                    assert ta._wide_smem(N, H, d, tq, 2) == lib.dc_tf_smem_bytes(N, H, d, tq)
                    assert ta._wide_smem(N, H, d, tq, 3) == lib.dc_tf_bwd_wide_smem_bytes(
                        N, H, d, tq)
                fits = lib.dc_tf_bwd_wide_smem_bytes(N, H, d, 1) <= _build.MAX_SMEM_BYTES
                assert ta.wide_route_takes(N, H, d) == fits, (N, H, d)


def test_wide_bwd_is_deterministic():
    """The partials of the mix gradients are added in block order: two runs
    give the same bits."""
    rng = np.random.default_rng(9)
    B, H, d, N = 4, 32, 32, 197
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    wl, ww = _bf16(rng, (H, H), H ** -0.5), _bf16(rng, (H, H), H ** -0.5)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = ta.transform_attention_save_p_wide(qkv, wl, ww, **kw)
    a = ta.transform_attention_bwd_wide(qkv, wl, ww, do, p, **kw)
    b = ta.transform_attention_bwd_wide(qkv, wl, ww, do, p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_training_refuses_what_neither_route_takes():
    """Past 256 tokens (the towers materialise there) and where one query
    row's score planes of all heads do not fit a block: a ValueError before
    any launch, from the autograd call and from the wide wrappers."""
    rng = np.random.default_rng(10)
    for H, d, N, match in ((32, 32, 257, "up to 256 tokens"), (4, 16, 300, "up to 256 tokens"),
                           (64, 8, 256, "does not fit")):
        qkv, do = _bf16(rng, (N, 3 * H * d)), _bf16(rng, (N, H * d))
        w = _bf16(rng, (H, H))
        p = torch.zeros((1, H, N, N), dtype=torch.bfloat16, device="cuda")
        kw = dict(heads=H, seq=N, scale=1.0)
        ops.reset_launch_counts()
        with pytest.raises(ValueError, match=match):
            ta.transform_attention_rows_qkv(qkv.clone().requires_grad_(), w, w, **kw)
        with pytest.raises(ValueError, match=match):
            ta.transform_attention_save_p_wide(qkv, w, w, **kw)
        with pytest.raises(ValueError, match=match):
            ta.transform_attention_bwd_wide(qkv, w, w, do, p, **kw)
        assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# -- plain attention: forward, saved probabilities, backward ------------------------

# (B, H, d, N): the teachers' and the plain-attention students' shapes, head
# shapes the TPU's block-diagonal kernel rejects (H=5; d=48), and the limits
_PA_SHAPES = [(3, 1, 8, 1), (5, 4, 16, 17), (4, 12, 64, 50), (4, 8, 64, 77), (4, 24, 32, 50),
              (3, 5, 64, 33), (3, 4, 48, 33), (2, 2, 8, 256), (2, 4, 128, 256)]


@pytest.mark.parametrize("B,H,d,N", _PA_SHAPES)
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short"),
                                       (True, "short")],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_plain_attention_kernels_match_plain(B, H, d, N, causal, kv):
    rng = np.random.default_rng(B * H * N + d)
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    kv_len = None if kv is None else max(1, N - 3)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    mask = dict(causal=causal, kv_len=kv_len)
    with torch.inference_mode():
        lean = pa.plain_attention_rows_qkv(qkv, **kw, **mask)
    o, p = pa.plain_attention_save_p(qkv, **kw, **mask)
    torch.cuda.synchronize()
    assert lean.shape == (B * N, H * d) and torch.equal(o, lean)
    assert p.shape == (B, H, N, N) and p.dtype == torch.bfloat16
    ro, rp = pa.plain_attention_save_p_plain(qkv.float(), **kw, **mask)
    torch.testing.assert_close(o.float(), ro, atol=8e-3, rtol=1e-2)
    assert float((p.float() - rp).abs().max()) < 4e-3
    hidden = ~pa.attention_mask(N, causal, kv_len, p.device)
    assert not p[:, :, hidden].any()          # masked probabilities are exact zeros
    dqkv = pa.plain_attention_bwd(qkv, do, p, **kw)
    rdqkv = pa.plain_attention_bwd_plain(qkv.float(), do.float(), p.float(), **kw)
    torch.cuda.synchronize()
    assert dqkv.dtype == torch.bfloat16 and torch.isfinite(dqkv.float()).all()
    torch.testing.assert_close(dqkv.float(), rdqkv, atol=3e-2, rtol=1e-2)


def test_plain_attention_backward_is_deterministic():
    rng = np.random.default_rng(6)
    B, H, d, N = 8, 8, 64, 77
    qkv, do = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = pa.plain_attention_save_p(qkv, causal=True, **kw)
    a = pa.plain_attention_bwd(qkv, do, p, **kw)
    b = pa.plain_attention_bwd(qkv, do, p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_autograd_on_card_matches_plain_autograd(causal):
    rng = np.random.default_rng(7)
    B, H, d, N = 3, 4, 16, 19
    qkv, g = _bf16(rng, (B * N, 3 * H * d)), _bf16(rng, (B * N, H * d))
    leaf = qkv.detach().clone().requires_grad_()
    ops.reset_launch_counts()
    out = pa.plain_attention_rows_qkv(leaf, heads=H, seq=N, causal=causal)
    (grad,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["plain_attention_save_p"] == 1 and counts["plain_attention_bwd"] == 1
    assert counts["plain_attention_rows_qkv"] == 0
    ref_leaf = qkv.float().cpu().requires_grad_()
    ref = pa.plain_attention_rows_qkv(ref_leaf, heads=H, seq=N, causal=causal)
    (ref_grad,) = torch.autograd.grad(ref, ref_leaf, g.float().cpu())
    torch.testing.assert_close(out.float().cpu(), ref, atol=8e-3, rtol=1e-2)
    torch.testing.assert_close(grad.float().cpu(), ref_grad, atol=3e-2, rtol=1e-2)


def test_plain_attention_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(8)
    qkv = _bf16(rng, (2 * 8, 3 * 2 * 16))
    with pytest.raises(TypeError):
        pa.plain_attention_rows_qkv(qkv.float(), heads=2, seq=8)
    with pytest.raises(ValueError):
        pa.plain_attention_rows_qkv(_bf16(rng, (2 * 8, 3 * 2 * 12)), heads=2, seq=8)   # d % 8
    # past 256 tokens #13, its save-P mode and #14 refuse (plain_attention_long
    # takes the EVA tower's long rows)
    long_qkv = _bf16(rng, (257, 3 * 16))
    with pytest.raises(ValueError):
        pa.plain_attention_rows_qkv(long_qkv, heads=2, seq=257)
    with pytest.raises(ValueError):
        pa.plain_attention_save_p(long_qkv, heads=2, seq=257, scale=0.25)
    with pytest.raises(ValueError):
        pa.plain_attention_bwd(long_qkv, _bf16(rng, (257, 16)), _bf16(rng, (1, 2, 257, 257)),
                               heads=2, seq=257, scale=0.25)
    with pytest.raises(ValueError):
        pa.plain_attention_rows_qkv(qkv, heads=2, seq=8, kv_len=0)


# -- #13L: plain attention past 256 tokens (the EVA-02 tower's) ---------------------

def _long_qkv(rng, B, H, N):
    """q and k at unit scale, v at 0.7, as #13's oracle cases draw them."""
    d = pa.LONG_HEAD_DIM
    return torch.cat([_bf16(rng, (B * N, 2 * H * d)), _bf16(rng, (B * N, H * d), 0.7)], dim=1)


# (B, H, d, N): the EVA cell's heads at 257 tokens (a 64-row q box at row 256
# holds one query; the last sample ends mid-box), ViT-L/14@336px's 577 (two
# passes of q tiles), a ragged 300, one head, one pass of two tiles, the limit
@pytest.mark.parametrize("B,H,N", [(4, 16, 257), (2, 16, 577), (3, 2, 300), (1, 1, 257),
                                   (2, 4, 100), (1, 2, 1024)])
def test_plain_attention_long_matches_plain(B, H, N):
    """Within #13's limit (8e-3 absolute) of the fp32 plain version on the
    same bf16 inputs; one launch a call."""
    rng = np.random.default_rng(B * H * N)
    qkv = _long_qkv(rng, B, H, N)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = pa.plain_attention_long(qkv, heads=H, seq=N)
        ref = pa.plain_attention_rows_qkv_plain(qkv.float(), heads=H, seq=N, scale=0.125)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "plain_attention_long": 1}
    assert out.shape == (B * N, H * 64) and torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().max().item() < 8e-3


def test_plain_attention_long_is_deterministic():
    rng = np.random.default_rng(11)
    B, H, N = 3, 16, 257
    qkv = _long_qkv(rng, B, H, N)
    with torch.inference_mode():
        first = pa.plain_attention_long(qkv, heads=H, seq=N)
        again = pa.plain_attention_long(qkv, heads=H, seq=N)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_plain_attention_long_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(12)
    qkv = _long_qkv(rng, 2, 2, 257)
    with pytest.raises(ValueError, match="unmasked"):
        pa.plain_attention_long(qkv, heads=2, seq=257, causal=True)
    with pytest.raises(ValueError, match="unmasked"):
        pa.plain_attention_long(qkv, heads=2, seq=257, kv_len=200)
    with pytest.raises(ValueError, match="heads of 64"):
        pa.plain_attention_long(_bf16(rng, (2 * 257, 3 * 4 * 32)), heads=4, seq=257)
    with pytest.raises(ValueError, match="heads of 64"):
        pa.plain_attention_long(_bf16(rng, (1025, 3 * 64)), heads=1, seq=1025)
    with pytest.raises(ValueError, match="forward only"):
        pa.plain_attention_long(qkv.clone().requires_grad_(), heads=2, seq=257)
    with pytest.raises(TypeError):
        pa.plain_attention_long(qkv.float(), heads=2, seq=257)


# -- the teacher's LN GEMMs: width 512, QuickGELU -------------------------------------

@pytest.mark.parametrize("rows", [77, 4 * 77])
def test_dense_ln_kernels_at_the_text_teachers_width(rows):
    rng = np.random.default_rng(rows)
    C = 512
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    for n, act in ((3 * C, None), (4 * C, "quick_gelu")):
        w, b = _bf16(rng, (C, n), C ** -0.5), _bf16(rng, (n,), 0.1)
        with torch.inference_mode():
            out = (fc1_act.dense_ln(x, ls, lb, w, b) if act is None
                   else fc1_act.dense_act_ln(x, ls, lb, w, b, act))
            ref = fc1_act.dense_ln_plain(x.float(), ls.float(), lb.float(), w.float(),
                                         b.float(), act=act)
        _close(out, ref)


def _grads(fn, args):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(out.shape), dtype=np.float32)).to(out.device).to(out.dtype)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("name", ["layer_norm_rows", "dense_ln", "dense_act_ln",
                                  "transform_attention_rows_qkv"])
def test_autograd_functions_on_card_match_plain_autograd(name):
    """Forward and backward of each public function on CUDA bf16 tensors
    (the kernels) against torch.autograd through the plain version on fp32
    copies of the same values."""
    rng = np.random.default_rng(11)
    rows, C, N, H, d, S = 96, 64, 3 * 4 * 16, 4, 16, 12
    x, ls, lb = _bf16(rng, (rows, C)), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1)
    qkv, wl, ww = _bf16(rng, (rows, N)), _bf16(rng, (H, H), 0.5), _bf16(rng, (H, H), 0.25)
    kw = dict(heads=H, seq=S, scale=d ** -0.5)
    cases = {
        "layer_norm_rows": (layer_norm.layer_norm_rows, layer_norm.layer_norm_rows_plain,
                            (x, ls, lb)),
        "dense_ln": (fc1_act.dense_ln, fc1_act.dense_ln_plain, (x, ls, lb, w, b)),
        "dense_act_ln": (fc1_act.dense_act_ln,
                         lambda *a: fc1_act.dense_ln_plain(*a, act="gelu_exact"),
                         (x, ls, lb, w, b)),
        "transform_attention_rows_qkv": (
            lambda *a: ta.transform_attention_rows_qkv(*a, heads=H, seq=S),
            lambda *a: ta.transform_attention_rows_qkv_plain(*a, **kw), (qkv, wl, ww)),
    }
    fn, plain, args = cases[name]
    out, grads = _grads(fn, args)
    ref, rgrads = _grads(plain, [a.float() for a in args])
    torch.cuda.synchronize()
    _close(out, ref)
    for g, r in zip(grads, rgrads):
        assert g.dtype == torch.bfloat16
        assert _rel_to_max(g, r) < 2e-2


# -- what the wrappers refuse, and what they count ---------------------------------

def _ln_args(rng, rows=16, C=64, N=64):
    return [_bf16(rng, (rows, C)), _bf16(rng, (C,)), _bf16(rng, (C,)), _bf16(rng, (C, N)),
            _bf16(rng, (N,))]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    x, ls, lb, w, b = _ln_args(rng)
    with pytest.raises(TypeError, match="bfloat16"):
        fc1_act.dense_ln(x.float(), ls, lb, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fc1_act.dense_ln(x, ls, lb, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="every operand must be on"):
        fc1_act.dense_ln(x, ls.cpu(), lb, w, b)
    with pytest.raises(ValueError, match="C % 32"):
        fc1_act.dense_ln(x[:, :48].contiguous(), ls[:48].contiguous(), lb[:48].contiguous(),
                         w[:48].contiguous(), b)
    u, mean, rstd = fc1_act.dense_ln_fwd(x, ls, lb, w, b, stats=True)
    with pytest.raises(TypeError, match="float32"):
        fc1_act.dense_ln_bwd(x, ls, lb, w, u, mean.to(torch.bfloat16), rstd)
    with pytest.raises(TypeError, match="bfloat16"):
        fc1_act.dense_ln_bwd(x, ls, lb, w, u.float(), mean, rstd)
    with pytest.raises(ValueError, match="multiple of 8"):
        ta.transform_attention_rows_qkv(_bf16(rng, (8, 3 * 2 * 12)), _bf16(rng, (2, 2)),
                                        _bf16(rng, (2, 2)), heads=2, seq=4)
    with pytest.raises(ValueError, match="does not fit"):
        ta.transform_attention_rows_qkv(_bf16(rng, (1024, 3 * 64 * 8)), _bf16(rng, (64, 64)),
                                        _bf16(rng, (64, 64)), heads=64, seq=1024)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm.layer_norm_rows(_bf16(rng, (4, 12)), _bf16(rng, (12,)), _bf16(rng, (12,)))


def test_each_launch_counts_once():
    rng = np.random.default_rng(1)
    x, ls, lb, w, b = _ln_args(rng, N=3 * 4 * 16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        qkv = fc1_act.dense_ln(x, ls, lb, w, b)
        ta.transform_attention_rows_qkv(qkv, _bf16(rng, (4, 4)), _bf16(rng, (4, 4)),
                                        heads=4, seq=8)
        fc1_act.dense_act_ln(x, ls, lb, w, b)
        layer_norm.layer_norm_rows(x, ls, lb)
        layer_norm.layer_norm_rows(x, ls, lb)
    torch.cuda.synchronize()
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"dense_ln": 1, "dense_act_ln": 1, "transform_attention_rows_qkv": 1,
                 "layer_norm_rows": 2})
    assert ops.launch_counts() == want


def test_backward_launches_count_once_each():
    """One differentiable call of each public function: the forward launches
    the statistics / residual / save-P modes, the backward its kernels."""
    rng = np.random.default_rng(1)
    x, ls, lb, w, b = (t.requires_grad_() for t in _ln_args(rng, N=3 * 4 * 16))
    wl, ww = _bf16(rng, (4, 4)).requires_grad_(), _bf16(rng, (4, 4)).requires_grad_()
    ops.reset_launch_counts()
    qkv = fc1_act.dense_ln(x, ls, lb, w, b)
    ctx = ta.transform_attention_rows_qkv(qkv, wl, ww, heads=4, seq=8)
    h = fc1_act.dense_act_ln(x, ls, lb, w, b)
    y = layer_norm.layer_norm_rows(x, ls, lb)
    (ctx.float().sum() + h.float().sum() + y.float().sum()).backward()
    torch.cuda.synchronize()
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"dense_ln": 1, "transform_attention_save_p": 1, "dense_act_ln_res": 1,
                 "layer_norm_rows": 1, "transform_attention_bwd": 1, "dense_ln_bwd": 2,
                 "layer_norm_rows_bwd": 1})
    assert ops.launch_counts() == want
    assert fc1_act.dense_ln_bwd.act_launches == 1      # K2's backward formed du in #9
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all()
               for t in (x, ls, lb, w, b, wl, ww))


def test_kernels_run_on_the_current_stream():
    rng = np.random.default_rng(2)
    x, ls, lb = _bf16(rng, (4096, 768)), _bf16(rng, (768,)), _bf16(rng, (768,))
    side = torch.cuda.Stream()
    with torch.inference_mode(), torch.cuda.stream(side):
        out = layer_norm.layer_norm_rows(x, ls, lb)
    side.synchronize()
    _close(out, layer_norm.layer_norm_rows_plain(x.float(), ls.float(), lb.float()))


# -- a tiny tower end to end ------------------------------------------------------

def test_tiny_scorer_on_card_matches_plain_cpu_path(tmp_path):
    import yaml

    from distillclip_tpu_torch.serving import LCLIPScorer

    common = dict(out_dim=64, embed_dim=64, depth=2, num_heads=4, repeated_times=2,
                  use_transform=True)
    cfg = {"model": {"init_args": {
        "image_student": {"class_path": "model.component.weight_share_model."
                                        "RepeatVisionTransformer",
                          "init_args": dict(common, img_size=32, patch_size=8, qkv_bias=True)},
        "text_student": {"class_path": "model.component.weight_share_model."
                                       "RepeatTextTransformer",
                         "init_args": dict(common, vocab_size=100, context_length=13)}}}}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    card = LCLIPScorer.from_config(str(path), device="cuda", seed=3)
    cpu = LCLIPScorer.from_config(str(path), device="cpu", dtype=torch.float32, seed=3)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    tokens = rng.integers(1, 99, size=(6, 13))
    tokens[:, 7] = 99
    ops.reset_launch_counts()
    feats = card.encode_images(images)
    assert ops.launch_counts()["layer_norm_rows"] == 1
    assert ops.launch_counts()["dense_ln"] == 2
    cos = (feats * cpu.encode_images(images)).sum(axis=1)
    assert cos.min() > 0.999
    cos = (card.encode_tokens(tokens) * cpu.encode_tokens(tokens)).sum(axis=1)
    assert cos.min() > 0.999


def test_tiny_teacher_and_text_cached_step_on_card_match_plain_cpu_path(tmp_path, monkeypatch):
    """A fabricated two-head teacher: its encode functions on the card against
    the fp32 CPU path, and one text-cached step's loss and launch counts: #9
    twice a trained layer, once in its activation mode a trained MLP, and the
    eager GELU gradient never on a CUDA tensor."""
    from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
    from distillclip_tpu_torch.training import DualDistillTask

    path = tmp_path / "tiny_clip.pt"
    torch.save(make_clip_state_dict(vision_width=128, vision_layers=2, patch_size=8,
                                    image_resolution=32, text_width=128, text_layers=2,
                                    context_length=13, vocab_size=100, embed_dim=64), str(path))
    common = dict(out_dim=64, embed_dim=64, depth=2, num_heads=4, repeated_times=2)

    def task(dtype):
        return DualDistillTask(
            image_student=RepeatVisionTransformer(img_size=32, patch_size=8, qkv_bias=True,
                                                  use_transform=True, **common),
            text_student=RepeatTextTransformer(vocab_size=100, context_length=13,
                                               use_transform=False, **common),
            loss_control_para={"loss_name": ["out_l1", "out_cos", "cos_diff"]},
            teacher_name=str(path), compute_dtype=dtype)

    card, cpu = task("bfloat16"), task("float32")
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    tokens = rng.integers(1, 99, size=(6, 13))
    tokens[:, 7] = 99
    ops.reset_launch_counts()
    img = card.make_teacher_image_encode("cuda")(images)
    txt = card.make_teacher_text_encode("cuda")(tokens)
    counts = ops.launch_counts()
    assert counts["plain_attention_rows_qkv"] == 4 and counts["dense_act_ln"] == 4
    assert counts["dense_ln"] == 4 and counts["layer_norm_rows"] == 3
    cos = torch.nn.functional.cosine_similarity
    assert cos(img.cpu(), cpu.make_teacher_image_encode("cpu")(images)).min() > 0.999
    assert cos(txt.cpu(), cpu.make_teacher_text_encode("cpu")(tokens)).min() > 0.999

    state, tx = card.init_state(0, 1, device="cuda")
    batch = [torch.from_numpy(tokens), torch.from_numpy(images), txt.cpu()]
    ref, _ = cpu.loss_fn_cached_text({k: v.cpu() for k, v in state.params.items()}, *batch)
    eager_du, act_du = [], fc1_act._act_du
    monkeypatch.setattr(fc1_act, "_act_du", lambda dh, *a: eager_du.append(dh.device.type)
                        or act_du(dh, *a))
    ops.reset_launch_counts()
    state, metrics = card.make_train_step(tx, cached_text_teacher=True)(
        state, *(t.cuda() for t in batch))
    counts = ops.launch_counts()
    assert abs(float(metrics["loss"]) - float(ref)) < 2e-2
    # two trained layers a student, each an MLP
    assert counts["dense_ln_bwd"] == 8 and counts["dense_act_ln_res"] == 4
    assert fc1_act.dense_ln_bwd.act_launches == 4 and "cuda" not in eager_du
    # image student: head-transform attention; text student: plain attention
    assert counts["transform_attention_save_p"] == counts["transform_attention_bwd"] == 2
    assert counts["plain_attention_save_p"] == counts["plain_attention_bwd"] == 2
    assert counts["plain_attention_rows_qkv"] == 2          # the image teacher, no gradient


def test_tiny_eval_step_on_card_takes_the_lean_kernels(tmp_path):
    """The stage-3 eval step on the card: every kernel on its lean route (no
    saved probabilities, residuals or statistics, no backward), metrics and
    representations near the fp32 CPU path's, accuracies in [0, 1]."""
    from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
    from distillclip_tpu_torch.training import DualDistillTask

    path = tmp_path / "tiny_clip.pt"
    torch.save(make_clip_state_dict(vision_width=128, vision_layers=2, patch_size=8,
                                    image_resolution=32, text_width=128, text_layers=2,
                                    context_length=13, vocab_size=100, embed_dim=64), str(path))
    common = dict(out_dim=64, embed_dim=64, depth=2, num_heads=4, repeated_times=2,
                  use_transform=True)

    def task(dtype):
        return DualDistillTask(
            image_student=RepeatVisionTransformer(img_size=32, patch_size=8, qkv_bias=True,
                                                  **common),
            text_student=RepeatTextTransformer(vocab_size=100, context_length=13, **common),
            loss_control_para={"loss_name": ["out_l1", "out_cos", "cos_diff"]},
            teacher_name=str(path), compute_dtype=dtype)

    card, cpu = task("bfloat16"), task("float32")
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8))
    tokens = rng.integers(1, 99, size=(6, 13))
    tokens[:, 7] = 99
    tokens = torch.from_numpy(tokens)
    state, _ = card.init_state(0, 1, device="cuda")
    cpu_state, _ = cpu.init_state(0, 1, params={k: v.cpu() for k, v in state.params.items()},
                                  device="cpu")
    ops.reset_launch_counts()
    metrics, reps = card.make_eval_step()(state, tokens.cuda(), images.cuda())
    counts = ops.launch_counts()
    # 2 + 2 student layers, 2 + 2 teacher layers, the students' two final norms
    # and the teachers' ln_pre, ln_post and ln_final
    assert counts == {**dict.fromkeys(ops.KERNELS, 0), "dense_ln": 8, "dense_act_ln": 8,
                      "transform_attention_rows_qkv": 4, "plain_attention_rows_qkv": 4,
                      "layer_norm_rows": 5}
    ref_metrics, ref_reps = cpu.make_eval_step()(cpu_state, tokens, images)
    for k, v in ref_metrics.items():
        if "acc" in k:
            assert 0.0 <= float(metrics[k]) <= 1.0
        else:
            assert abs(float(metrics[k]) - float(v)) < 2e-2, k
    for k, v in ref_reps.items():
        assert reps[k].dtype == torch.float32 and reps[k].is_cuda
        assert torch.nn.functional.cosine_similarity(reps[k].cpu(), v).min() > 0.999, k


def test_to_device_goes_through_pinned_memory():
    from distillclip_tpu_torch.training.trainer import to_device

    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8),
             "tokens": rng.integers(0, 100, size=(4, 5)).astype(np.int32),
             "nested": {"rep": rng.standard_normal((4, 3), dtype=np.float32)},
             "names": ["a", "b", "c", "d"]}
    moved = to_device(batch, "cuda")
    torch.cuda.synchronize()
    assert moved["names"] == batch["names"]
    for got, want in ((moved["images"], batch["images"]), (moved["tokens"], batch["tokens"]),
                      (moved["nested"]["rep"], batch["nested"]["rep"])):
        assert got.is_cuda and got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    pinned = torch.from_numpy(batch["tokens"]).pin_memory()
    assert pinned.is_pinned()
    again = to_device({"t": pinned, "on_card": moved["images"]}, "cuda")
    assert again["on_card"] is moved["images"]
    torch.testing.assert_close(again["t"].cpu(), pinned)


def test_prestaged_loader_on_card_gives_the_host_loaders_batches():
    """A datamodule with ``prestage_device`` keeps its items on the card: each
    epoch's batches equal the host loader's at that epoch's permutation."""
    from distillclip_tpu_torch.data.datamodule import DevicePrestagedLoader, MainDataModule
    from distillclip_tpu_torch.training.trainer import fit_loaders

    def module(prestage):
        return MainDataModule(
            dataset_para={"size": 40, "image_size": 16, "context_length": 9, "vocab_size": 50,
                          "uint8": True, "image_pool": 7, "cached_text_rep_dim": 4},
            dataset="synthetic", dataset_name="SyntheticPairDataset", num_workers=2,
            train_batch_size=8, val_batch_size=8, seed=3, prestage_device=prestage)

    staged, _ = fit_loaders(module(True), "cuda")
    host, _ = fit_loaders(module(False), "cuda")
    assert isinstance(staged, DevicePrestagedLoader) and len(staged) == len(host) == 5
    orders = []
    for epoch in range(3):
        staged.set_epoch(epoch)
        host.set_epoch(epoch)
        got, want = list(staged), list(host)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                assert a[k].is_cuda and a[k].dtype == torch.from_numpy(b[k]).dtype
                np.testing.assert_array_equal(a[k].cpu().numpy(), b[k])
        orders.append(np.concatenate([b["tokens"].cpu().numpy() for b in got]))
    assert not np.array_equal(orders[0], orders[1])


# -- attention on [B, H, N, d] views with the logsumexp residual ---------------------

import importlib  # noqa: E402

# ``ops.flash_attention`` is the public function; this is its module
fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

# (the last six: the widest head shapes the head-transform forward's tensor
# cores take, 32 heads of 32 to 16 of 128, and two past them, for its CUDA-core
# route)
_FA_SHAPES = [(3, 1, 8, 1), (5, 4, 16, 17), (4, 12, 64, 50), (3, 8, 64, 77), (4, 24, 32, 50),
              (2, 5, 48, 33), (2, 2, 128, 256), (2, 32, 32, 197), (2, 16, 128, 256),
              (2, 12, 96, 77), (3, 29, 24, 1), (2, 33, 32, 50), (2, 32, 64, 197)]


def _qkv_views(rng, B, H, d, N, layout):
    """q, k, v as ``[B, H, N, d]``: contiguous tensors, or the permuted views
    of one fused ``[B, N, 3, H, d]`` projection (v drawn at 0.7, see the
    fused-qkv cases)."""
    qkv = torch.cat([_bf16(rng, (B, N, 2, H, d)), _bf16(rng, (B, N, 1, H, d), 0.7)], dim=2)
    views = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return [t.contiguous() for t in views] if layout == "contiguous" else list(views)


def _kv(kv, N):
    return max(1, N - 4) if kv == "short" else None


@pytest.mark.parametrize("B,H,d,N", _FA_SHAPES)
@pytest.mark.parametrize("layout", ["contiguous", "fused_view"])
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short"),
                                       (True, "short")],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_flash_attention_kernels_match_plain(B, H, d, N, layout, causal, kv):
    rng = np.random.default_rng(B * 1000 + H * 100 + d + N)
    q, k, v = _qkv_views(rng, B, H, d, N, layout)
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=_kv(kv, N))
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), **kw)
        _close(o, ro)
        torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
        assert o.stride() == (q.contiguous().stride() if layout == "contiguous"
                              else (N * H * d, d, H * d, 1))
        do = _bf16(rng, (B, N, H, d)).permute(0, 2, 1, 3)      # as out_proj's gradient arrives
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), **kw)
    torch.cuda.synchronize()
    for g, r in zip(grads, refs):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        torch.testing.assert_close(g.float(), r, atol=3e-2, rtol=2e-2)


@pytest.mark.parametrize("B,H,d,N", _FA_SHAPES)
@pytest.mark.parametrize("layout", ["contiguous", "fused_view"])
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short")],
                         ids=["full", "causal", "kv_len"])
def test_flash_transform_attention_kernel_matches_plain(B, H, d, N, layout, causal, kv):
    """Every shape on the route it takes: the tensor cores up to 32 heads of
    32 and 16 of 128, the CUDA-core kernel past them (33 heads of 32, 32 of
    64)."""
    rng = np.random.default_rng(B * 1000 + H * 100 + d + N + 7)
    q, k, v = _qkv_views(rng, B, H, d, N, layout)
    wl, ww = _bf16(rng, (2, H, H), H ** -0.5)
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=_kv(kv, N))
    ops.reset_launch_counts()
    with torch.inference_mode():
        o = fa.flash_transform_attention_fwd(q, k, v, wl, ww, **kw)
        ref = fa.flash_transform_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                     wl.float(), ww.float(), **kw)
    assert o.shape == q.shape
    _close(o, ref)
    assert o.stride() == (q.contiguous().stride() if layout == "contiguous"
                          else (N * H * d, d, H * d, 1))
    route = ("flash_transform_attention_fwd" if fa.tensor_core_head_shape(H, d)
             else "flash_transform_attention_fwd_wide")
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), route: 1}


def test_flash_transform_attention_route_is_the_librarys():
    """The Python statement of the tensor-core route's head shapes is the
    library's own predicate."""
    from distillclip_tpu_torch.ops import _build

    lib = _build.lib()
    for H in range(1, 49):
        for d in range(4, 137, 4):
            assert fa._tensor_core_shape(lib, H, d) == fa.tensor_core_head_shape(H, d), (H, d)


@pytest.mark.parametrize("B,H,d,N", [(64, 4, 32, 200), (40, 12, 64, 77), (33, 24, 32, 50),
                                     (17, 16, 48, 33), (9, 6, 40, 130), (11, 24, 24, 45),
                                     (150, 32, 32, 90), (70, 16, 128, 130), (90, 29, 24, 61)])
@pytest.mark.parametrize("layout", ["contiguous", "fused_view"])
@pytest.mark.parametrize("causal,kv", [(True, None), (True, "third"), (False, "third")],
                         ids=["causal", "causal_kv_len", "kv_len"])
def test_flash_transform_attention_takes_many_tiles_a_block(B, H, d, N, layout, causal, kv):
    """More tiles than blocks, so a block takes tiles of different key
    counts in turn (the k / v buffers' parity follows each tile's count; at
    16 heads of 128 one k and one v buffer, refilled in turn)."""
    rng = np.random.default_rng(B + H + d + N)
    q, k, v = _qkv_views(rng, B, H, d, N, layout)
    wl, ww = _bf16(rng, (2, H, H), H ** -0.5)
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=None if kv is None else N // 3)
    ops.reset_launch_counts()
    with torch.inference_mode():
        o = fa.flash_transform_attention_fwd(q, k, v, wl, ww, **kw)
        ref = fa.flash_transform_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                     wl.float(), ww.float(), **kw)
    _close(o, ref)
    assert ops.launch_counts()["flash_transform_attention_fwd"] == 1


def test_flash_transform_attention_takes_a_broadcast_view():
    """k and v with a zero batch stride (one sample's keys for all) go to the
    tensor cores as copies: a TMA map takes no zero stride."""
    rng = np.random.default_rng(14)
    q, k, v = _qkv_views(rng, 4, 12, 64, 77, "contiguous")
    k, v = k[:1].expand_as(q), v[:1].expand_as(q)
    wl, ww = _bf16(rng, (2, 12, 12), 12 ** -0.5)
    with torch.inference_mode():
        o = fa.flash_transform_attention_fwd(q, k, v, wl, ww, scale=0.125)
        ref = fa.flash_transform_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                     wl.float(), ww.float(), scale=0.125)
    _close(o, ref)


@pytest.mark.parametrize("H,d,N", [(24, 32, 50), (12, 64, 77)], ids=["image", "text"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_transform_attention_is_deterministic(H, d, N, causal):
    rng = np.random.default_rng(12)
    q, k, v = _qkv_views(rng, 16, H, d, N, "fused_view")
    wl, ww = _bf16(rng, (2, H, H), H ** -0.5)
    kw = dict(scale=d ** -0.5, causal=causal)
    with torch.inference_mode():
        a = fa.flash_transform_attention_fwd(q, k, v, wl, ww, **kw)
        b = fa.flash_transform_attention_fwd(q, k, v, wl, ww, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_backward_is_deterministic():
    rng = np.random.default_rng(11)
    q, k, v = _qkv_views(rng, 8, 12, 64, 50, "fused_view")
    do = _bf16(rng, (8, 12, 50, 64))
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd(q, k, v, scale=0.125)
        a = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=0.125)
        b = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("transform", [False, True], ids=["plain", "head_transform"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_on_card_matches_plain_autograd(transform, causal):
    """The public entry under a gradient, from the views of a fused qkv that
    requires it: the gradient arrives on the fused tensor."""
    rng = np.random.default_rng(12)
    B, H, d, N = 4, 6, 32, 21
    qkv = torch.cat([_bf16(rng, (B, N, 2, H, d)), _bf16(rng, (B, N, 1, H, d), 0.7)], dim=2)
    mixes = _bf16(rng, (2, H, H), H ** -0.5)
    do = _bf16(rng, (B, H, N, d))

    def run(qkv, mixes, fn):
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        ht = (mixes[0], mixes[1]) if transform else None
        o = fn(q, k, v, causal=causal, head_transform=ht)
        leaves = (qkv, mixes) if transform else (qkv,)
        return o, torch.autograd.grad(o, leaves, do.to(o.dtype))

    ops.reset_launch_counts()
    o, grads = run(qkv.clone().requires_grad_(), mixes.clone().requires_grad_(),
                   ops.flash_attention)
    counts = ops.launch_counts()
    if transform:
        assert counts["flash_transform_attention_fwd"] == 1 and counts["flash_attention_bwd"] == 0
    else:
        assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 1
    ro, rgrads = run(qkv.float().requires_grad_(), mixes.float().requires_grad_(),
                     ops.reference_attention)
    _close(o, ro)
    for g, r in zip(grads, rgrads):
        torch.testing.assert_close(g.float(), r, atol=3e-2, rtol=2e-2)


def test_flash_attention_refuses_what_the_kernels_do_not_take():
    rng = np.random.default_rng(13)
    q, k, v = _qkv_views(rng, 2, 2, 16, 9, "contiguous")
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_fwd(q.float(), k.float(), v.float(), scale=0.25)
    with pytest.raises(ValueError, match="N<=256"):
        ops.flash_attention(*_qkv_views(rng, 1, 1, 8, 257, "contiguous"))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(*_qkv_views(rng, 1, 2, 12, 9, "contiguous"))
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=10)
    with pytest.raises(ValueError, match="must be on"):
        fa.flash_attention_fwd(q, k.cpu(), v, scale=0.25)
    # a view the kernels cannot read in place (d transposed) is copied, not refused
    qt = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    with torch.inference_mode():
        a = fa.flash_attention_fwd(qt, k, v, scale=0.25)[0]
        b = fa.flash_attention_fwd(q, k, v, scale=0.25)[0]
    assert torch.equal(a, b)


# -- the tensor-core forward of #13 and #16 at the edges of its tiles ----------------

# (B, H, d, N): a warp takes 16 query rows and a key block 64 keys, so N on
# either side of 16, 64, 128 and at 256; d padded to the k-step of 16 (8, 24,
# 40), 48 and 128; odd head counts at d = 32, where a block takes two heads
_TILE_EDGES = [(3, 5, 32, 15), (2, 3, 8, 16), (2, 5, 32, 17), (2, 2, 24, 63), (2, 3, 40, 64),
               (2, 2, 48, 65), (2, 1, 128, 128), (2, 3, 8, 129), (1, 2, 128, 256),
               (2, 7, 32, 256)]


@pytest.mark.parametrize("B,H,d,N", _TILE_EDGES)
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short"),
                                       (True, "short")],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_tensor_core_forward_at_tile_edges(B, H, d, N, causal, kv):
    """#13 lean and save-P on the fused rows, #16 forward on their views and
    on contiguous copies, against the plain versions in fp32: o within 8e-3,
    P within 4e-3 with masked entries exactly 0, lse within 1e-3; lean and
    save-P o the same bits."""
    rng = np.random.default_rng(B * 1000 + H * 100 + d + N + 13)
    fused = torch.cat([_bf16(rng, (B, N, 2, H, d)), _bf16(rng, (B, N, 1, H, d), 0.7)], dim=2)
    kv_len = _kv(kv, N)
    mask = dict(causal=causal, kv_len=kv_len)
    qkv = fused.view(B * N, 3 * H * d)
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    with torch.inference_mode():
        lean = pa.plain_attention_rows_qkv(qkv, **kw, **mask)
        o, p = pa.plain_attention_save_p(qkv, **kw, **mask)
        ro, rp = pa.plain_attention_save_p_plain(qkv.float(), **kw, **mask)
        views = list(fused.permute(2, 0, 3, 1, 4).unbind(0))
        fwd = [fa.flash_attention_fwd(*qs, scale=d ** -0.5, **mask)
               for qs in (views, [t.contiguous() for t in views])]
        fro, frlse = fa.flash_attention_fwd_plain(*(t.float() for t in views), scale=d ** -0.5,
                                                  **mask)
    torch.cuda.synchronize()
    assert torch.equal(o, lean)
    assert float((o.float() - ro).abs().max()) <= 8e-3
    assert float((p.float() - rp).abs().max()) <= 4e-3
    assert not p[:, :, ~pa.attention_mask(N, causal, kv_len, p.device)].any()
    for fo, flse in fwd:
        assert fo.dtype == torch.bfloat16 and torch.isfinite(fo.float()).all()
        assert float((fo.float() - fro).abs().max()) <= 8e-3
        assert float((flse - frlse).abs().max()) <= 1e-3


@pytest.mark.parametrize("B,H,d,N", _TILE_EDGES)
@pytest.mark.parametrize("layout", ["fused_view", "contiguous"])
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short"),
                                       (True, "short")],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_tensor_core_backward_at_tile_edges(B, H, d, N, layout, causal, kv):
    """#16 backward on the tensor cores (16-key and 16-query warp tiles, whole
    or streamed rows at d = 128, N = 256) against the fp32 plain version: dq,
    dk, dv within 3e-2, each in q's layout."""
    rng = np.random.default_rng(B * 1000 + H * 100 + d + N + 16)
    q, k, v = _qkv_views(rng, B, H, d, N, layout)
    do = _bf16(rng, (B, N, H, d)).permute(0, 2, 1, 3)
    if layout == "contiguous":
        do = do.contiguous()
    kw = dict(scale=d ** -0.5, causal=causal, kv_len=_kv(kv, N))
    with torch.inference_mode():
        o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), **kw)
    torch.cuda.synchronize()
    for g, r in zip(grads, refs):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert g.stride() == q.stride() or layout == "fused_view"
        assert torch.isfinite(g.float()).all()
        assert float((g.float() - r).abs().max()) <= 3e-2


# (B, H, d, N) of the fused-qkv backward: every N of {1, 15, 16, 17, 50, 77,
# 256} with every d of {8, 16, 32, 48, 64, 128} at three heads (a block takes
# ceil(64 / d) heads, so groups come out ragged; d >= 64 at N = 256 streams
# row chunks), the head-transform kernels' long shapes and #15's head shapes
_PA_BWD_EDGES = ([(2, 3, d, N) for N in (1, 15, 16, 17, 50, 77, 256)
                  for d in (8, 16, 32, 48, 64, 128)]
                 + [(2, 2, 8, 256), (2, 16, 64, 256), (3, 5, 64, 33), (3, 4, 48, 33)])


@pytest.mark.parametrize("B,H,d,N", _PA_BWD_EDGES)
@pytest.mark.parametrize("causal,kv", [(False, None), (True, None), (False, "short"),
                                       (True, "short")],
                         ids=["full", "causal", "kv_len", "causal_kv_len"])
def test_plain_attention_backward_at_tile_edges(B, H, d, N, causal, kv):
    """#14 on the tensor cores from the save-P kernel's P (exact zeros at
    masked keys) against the fp32 plain version on the same P: dqkv within
    3e-2."""
    rng = np.random.default_rng(B * 1000 + H * 100 + d + N + 14)
    qkv = torch.cat([_bf16(rng, (B * N, 2 * H * d)), _bf16(rng, (B * N, H * d), 0.7)], dim=1)
    do = _bf16(rng, (B * N, H * d))
    kw = dict(heads=H, seq=N, scale=d ** -0.5)
    _, p = pa.plain_attention_save_p(qkv, **kw, causal=causal, kv_len=_kv(kv, N))
    dqkv = pa.plain_attention_bwd(qkv, do, p, **kw)
    ref = pa.plain_attention_bwd_plain(qkv.float(), do.float(), p.float(), **kw)
    torch.cuda.synchronize()
    assert dqkv.dtype == torch.bfloat16 and dqkv.shape == qkv.shape
    assert torch.isfinite(dqkv.float()).all()
    assert float((dqkv.float() - ref).abs().max()) <= 3e-2


@pytest.mark.parametrize("rows,C", [(1, 768), (3, 768), (255, 768), (256, 768), (257, 768),
                                    (1024, 768), (1025, 768), (12800, 768), (19712, 768),
                                    (333, 512), (19712, 512), (77, 40), (5000, 40),
                                    (1000, 1024)])
def test_layer_norm_fwd_at_row_counts(rows, C):
    """K4 on the grid its wrapper picks from the row count (two-warp blocks
    where the call cannot fill the card, one wave of eight-warp blocks in which
    every warp takes the same number of rows otherwise; a row in registers up
    to C = 768, read from L1 above), with rows that leave the last warp and
    block short: y within 1e-2 of the plain version in fp32, mean and rstd
    within 1e-5 relative, and the lean mode's y the same bits; one launch
    each."""
    rng = np.random.default_rng(rows + C)
    x, s, b = _bf16(rng, (rows, C), 3.0, 1.0), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    ops.reset_launch_counts()
    lean = layer_norm.layer_norm_rows_fwd(x, s, b)[0]
    y, mean, rstd = layer_norm.layer_norm_rows_fwd(x, s, b, stats=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["layer_norm_rows"] == 2
    assert torch.equal(y, lean)
    ref, rmean, rrstd = layer_norm.layer_norm_rows_stats_plain(x.float(), s.float(), b.float())
    _close(y, ref)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)


def _ln_bwd_inputs(rng, rows, C=768):
    x = torch.from_numpy(rng.uniform(-3 ** 0.5, 3 ** 0.5, size=(rows, C)).astype(np.float32))
    x, s, b = x.cuda().to(torch.bfloat16), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    _, mean, rstd = layer_norm.layer_norm_rows_stats_plain(x, s, b)
    return x, s, _bf16(rng, (rows, C)), mean, rstd


@pytest.mark.parametrize("rows,C", [(1, 768), (2, 768), (255, 768), (257, 768), (12800, 768),
                                    (300, 1024), (40, 4096)])
def test_layer_norm_bwd_at_row_counts(rows, C):
    """#7 in one launch (rows a block from the row count, the blocks that
    finish last adding the partials; rows in registers up to C = 768, read
    twice above) against the plain version: dx within 3e-2, dscale and dbias
    within 6e-3 of their largest entry."""
    x, s, g, mean, rstd = _ln_bwd_inputs(np.random.default_rng(rows + C), rows, C)
    ops.reset_launch_counts()
    dx, ds, db = layer_norm.layer_norm_rows_bwd(x, s, g, mean, rstd)
    rdx, rds, rdb = layer_norm.layer_norm_rows_bwd_plain(x.float(), s.float(), g.float(),
                                                         mean, rstd)
    torch.cuda.synchronize()
    assert ops.launch_counts()["layer_norm_rows_bwd"] == 1
    assert dx.dtype == torch.bfloat16 and float((dx.float() - rdx).abs().max()) <= 3e-2
    assert ds.dtype == torch.float32 and db.dtype == torch.float32
    assert _rel_to_max(ds, rds) < 6e-3 and _rel_to_max(db, rdb) < 6e-3


@pytest.mark.parametrize("rows", [256, 19712])
def test_layer_norm_bwd_is_deterministic(rows):
    """The partials are added in block order by whichever block finishes
    last: two runs give the same bits, and a third on another stream too."""
    x, s, g, mean, rstd = _ln_bwd_inputs(np.random.default_rng(rows + 7), rows)
    a = layer_norm.layer_norm_rows_bwd(x, s, g, mean, rstd)
    b = layer_norm.layer_norm_rows_bwd(x, s, g, mean, rstd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        c = layer_norm.layer_norm_rows_bwd(x, s, g, mean, rstd)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) and torch.equal(u, w) for u, v, w in zip(a, b, c))


def test_tiny_tapped_steps_on_card_match_plain_cpu_path(tmp_path):
    """Stage-1 steps that collect hidden states, on a fabricated two-head
    teacher: the loss against the fp32 CPU path, and the attention kernels each
    tower launches (the head-transform forward in a student with head mixes,
    the plain forward and backward in one without, the plain forward in the
    teacher; none where the attention is materialised for a tap)."""
    from distillclip_tpu_torch.models import RepeatVisionTransformer
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
    from distillclip_tpu_torch.training import DistillTask

    path = tmp_path / "tiny_clip.pt"
    torch.save(make_clip_state_dict(vision_width=128, vision_layers=3, patch_size=8,
                                    image_resolution=32, text_width=128, text_layers=2,
                                    context_length=13, vocab_size=100, embed_dim=64), str(path))
    images = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(6, 32, 32, 3), dtype=np.uint8))

    def task(dtype, use_transform, losses):
        student = RepeatVisionTransformer(img_size=32, patch_size=8, qkv_bias=True, out_dim=64,
                                          embed_dim=128, depth=2, num_heads=4, repeated_times=2,
                                          use_transform=use_transform)
        return DistillTask(student=student, loss_control_para={"loss_name": losses},
                           teacher_name=str(path), teacher_need_layers=[0, 2],
                           compute_dtype=dtype)

    for use_transform, losses, want in (
            (True, ["out_l1", "hidden_rep_mse"],
             {"flash_transform_attention_fwd": 2, "flash_attention_fwd": 3}),
            (False, ["out_l1", "hidden_rep_mse", "embedding_mse"],
             {"flash_attention_fwd": 5, "flash_attention_bwd": 2}),
            (True, ["out_l1", "attention_probs_kl"], {})):
        card, cpu = task("bfloat16", use_transform, losses), task("float32", use_transform, losses)
        state, tx = card.init_state(0, 1, device="cuda")
        ref, _ = cpu.loss_fn({k: v.cpu() for k, v in state.params.items()}, images)
        ops.reset_launch_counts()
        state, metrics = card.make_train_step(tx)(state, images.cuda())
        counts = ops.launch_counts()
        assert abs(float(metrics["loss"]) - float(ref)) < 2e-2
        attention = {k: v for k, v in counts.items() if "attention" in k and v}
        assert attention == want, (losses, attention)


# -- the no-LN GEMM (#10-#12) and the knobs that reach it --------------------------

@pytest.mark.parametrize("rows,C,N", [(1, 32, 8), (63, 96, 136), (65, 768, 3072),
                                      (130, 256, 520)])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_kernels_match_plain(rows, C, N, act):
    """h only (#12), h with u and e (#10) and u only (#11) against the plain
    versions in fp32 on the same bf16 values; the residual mode's h is the lean
    mode's bit for bit.  x at std 3 and mean 1: an activation no LayerNorm
    bounds, which the kernel stages as bf16."""
    rng = np.random.default_rng(rows + C + N)
    x, w, b = _bf16(rng, (rows, C), 3.0, 1.0), _bf16(rng, (C, N), C ** -0.5 / 3), \
        _bf16(rng, (N,), 0.1)
    with torch.inference_mode():
        lean = fc1_act.dense_act(x, w, b, act)
    h, u, e = fc1_act.dense_act_res(x, w, b, act)
    u_only = fc1_act.dense_act_u(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(h, lean) and torch.equal(u_only, u)
    rh, ru, re = fc1_act.dense_act_res_plain(x.float(), w.float(), b.float(), act)
    _close(h, rh)
    _close(u, ru)
    _close(e, re)


# (rows, C, N) at the edges of the 128 x 256 x 64 tiles: N past a tile (264,
# 520, 2056), C = 32 < BK and C = 96 (a half-filled second K-stage), rows past a
# tile and a single row
@pytest.mark.parametrize("rows,C,N", [(1, 64, 264), (129, 32, 520), (257, 96, 2056),
                                      (300, 768, 264), (128, 160, 256)])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_at_tile_edges(rows, C, N, act):
    """#10, #11 and #12 on the wgmma main loop against the plain versions in
    fp32, with u and h the same bits across the modes."""
    rng = np.random.default_rng(rows * 7 + C + N)
    x, w, b = _bf16(rng, (rows, C), 1.0), _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1)
    with torch.inference_mode():
        lean = fc1_act.dense_act(x, w, b, act)
        h, u, e = fc1_act.dense_act_res(x, w, b, act)
        u_only = fc1_act.dense_act_u(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(h, lean) and torch.equal(u_only, u)
    for out, ref in zip((h, u, e), fc1_act.dense_act_res_plain(x.float(), w.float(),
                                                               b.float(), act)):
        assert out.shape == (rows, N)
        _close(out, ref)


def test_dense_act_refuses_a_misaligned_view():
    """TMA reads 16-byte aligned rows: a view that starts 2 bytes in is refused."""
    rng = np.random.default_rng(6)
    flat = _bf16(rng, (64 * 64 + 1,))
    x = flat[1:].view(64, 64)
    w, b = _bf16(rng, (64, 64)), _bf16(rng, (64,))
    with torch.inference_mode(), pytest.raises(ValueError, match="16-byte aligned"):
        fc1_act.dense_act_u(x, w, b)


def test_dense_act_keeps_activations_past_fp16_range():
    """bf16 operands: a row of 1e5 (past fp16's 65504) goes through."""
    rng = np.random.default_rng(3)
    x, w, b = _bf16(rng, (64, 64)), _bf16(rng, (64, 64), 1e-3), _bf16(rng, (64,), 0.1)
    x[5] = 1e5
    u = fc1_act.dense_act_u(x, w, b)
    torch.cuda.synchronize()
    ref = fc1_act.dense_act_u_plain(x.float(), w.float(), b.float())
    assert torch.isfinite(u.float()).all()
    torch.testing.assert_close(u.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("res", ["ue", "u"])
def test_dense_act_autograd_on_card_matches_plain_autograd(res):
    """One differentiable call: #10 (or #11) forward, plain products backward,
    against the same autograd Function on the CPU in fp32."""
    rng = np.random.default_rng(4)
    arrays = [_bf16(rng, (96, 128)), _bf16(rng, (128, 512), 128 ** -0.5), _bf16(rng, (512,), 0.1)]
    cot = _bf16(rng, (96, 512))
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [(a if dev == "cuda" else a.float().cpu()).clone().requires_grad_()
                  for a in arrays]
        ops.reset_launch_counts()
        out = fc1_act.dense_act(*leaves, "gelu_exact", res)
        out.backward(cot.to(out.device, out.dtype))
        grads[dev] = [out.detach()] + [t.grad for t in leaves]
        if dev == "cuda":
            torch.cuda.synchronize()
            want = dict.fromkeys(ops.KERNELS, 0)
            want["dense_act_u" if res == "u" else "dense_act_res"] = 1
            assert ops.launch_counts() == want
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _rel_to_max(g.cpu(), r) < 2e-2


def test_dense_act_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(5)
    x, w, b = _bf16(rng, (16, 64)), _bf16(rng, (64, 64)), _bf16(rng, (64,))
    with torch.inference_mode():
        with pytest.raises(TypeError, match="bfloat16"):
            fc1_act.dense_act(x.float(), w.float(), b.float())
        with pytest.raises(ValueError, match="C % 32"):
            fc1_act.dense_act(x[:, :48].contiguous(), w[:48].contiguous(), b)
        with pytest.raises(ValueError, match="contiguous"):
            fc1_act.dense_act(x, w.t().contiguous().t(), b)


# -- K1 and #9 on wgmma: stage, tile and cluster edges ------------------------------
#
# K1 takes C in steps of 64 (a C of 32 or 96 ends in a half-filled stage); #9
# runs a cluster of ceil(C/256) blocks along C (1 to 8 here); both tile rows
# by 128 and N by 256.

@pytest.mark.parametrize("C", [32, 96, 256, 512, 768, 1024])
@pytest.mark.parametrize("rows,N", [(1, 8), (130, 264), (257, 520)])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_dense_ln_at_stage_and_tile_edges(C, rows, N, bias):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1) if bias else None
    lean, _, _ = fc1_act.dense_ln_fwd(x, ls, lb, w, b)
    u, mean, rstd = fc1_act.dense_ln_fwd(x, ls, lb, w, b, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(u, lean)
    ref, rmean, rrstd = fc1_act.dense_ln_stats_plain(
        x.float(), ls.float(), lb.float(), w.float(), None if b is None else b.float())
    _close(u, ref)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)


# K2 and #8 run K1's kernel with an activation epilogue: C past the row tile
# of the kernel they replaced (1536, 2048), N of 8 and N % 256 != 0, one row
# and ragged rows, under both activations.

@pytest.mark.parametrize("C", [32, 96, 768, 1536, 2048])
@pytest.mark.parametrize("rows,N", [(1, 8), (130, 264), (257, 520)])
@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_ln_at_stage_and_tile_edges(C, rows, N, act):
    """Lean K2's h is #8's h bit for bit, two calls of #8 give the same bits,
    and every output holds against the plain version in fp32."""
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), C ** -0.5), _bf16(rng, (N,), 0.1)
    with torch.inference_mode():
        lean = fc1_act.dense_act_ln(x, ls, lb, w, b, act)
    outs = fc1_act.dense_act_ln_res(x, ls, lb, w, b, act)
    again = fc1_act.dense_act_ln_res(x, ls, lb, w, b, act)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], lean)
    assert all(torch.equal(p, q) for p, q in zip(outs, again))
    h, u, e, mean, rstd = outs
    rh, ru, re, rmean, rrstd = fc1_act.dense_act_ln_res_plain(
        x.float(), ls.float(), lb.float(), w.float(), b.float(), act)
    for out, ref in ((h, rh), (u, ru), (e, re)):
        assert out.shape == (rows, N)
        _close(out, ref)
    torch.testing.assert_close(mean, rmean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)


def test_dense_act_ln_takes_rows_as_wide_as_its_staging_holds():
    """γ/β staged beside the ring as fp16 take C up to 8640; one step of 32
    past it is refused before anything is launched."""
    rng = np.random.default_rng(4)
    for C in (8640, 8672):
        x, ls, lb = _bf16(rng, (3, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
        w, b = _bf16(rng, (C, 8), C ** -0.5), _bf16(rng, (8,), 0.1)
        if C == 8672:
            with pytest.raises(ValueError, match="too wide"):
                fc1_act.dense_act_ln_res(x, ls, lb, w, b)
            continue
        h = fc1_act.dense_act_ln_res(x, ls, lb, w, b, "quick_gelu")[0]
        _close(h, fc1_act.dense_ln_plain(x.float(), ls.float(), lb.float(), w.float(),
                                         b.float(), act="quick_gelu"))


@pytest.mark.parametrize("C", [32, 256, 512, 768, 1024, 1152, 2048])
@pytest.mark.parametrize("rows,N", [(1, 8), (130, 264), (257, 2304)])
def test_dense_ln_bwd_at_cluster_and_tile_edges(C, rows, N):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.5), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, du = _bf16(rng, (C, N), N ** -0.5), _bf16(rng, (rows, N))
    _, mean, rstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w)
    dx, xn, dls, dlb = fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
    rdx, rxn, rdls, rdlb = fc1_act.dense_ln_bwd_plain(
        x.float(), ls.float(), lb.float(), w.float(), du.float(), mean, rstd)
    _close(dx, rdx)
    _close(xn, rxn)
    assert _rel_to_max(dls, rdls) < 6e-3 and _rel_to_max(dlb, rdlb) < 6e-3


@pytest.mark.parametrize("rows,C,N", [(12800, 768, 2304), (1000, 1024, 520)])
def test_dense_ln_bwd_is_deterministic(rows, C, N):
    """The row moments add the cluster's partials in rank order and dγ/dβ the
    bands' partials in band order: two calls give the same bits."""
    rng = np.random.default_rng(rows)
    x, ls, lb = _bf16(rng, (rows, C)), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, du = _bf16(rng, (C, N), 0.02), _bf16(rng, (rows, N))
    _, mean, rstd = fc1_act.dense_ln_stats_plain(x, ls, lb, w)
    a = fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
    b = fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, rstd)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_dense_ln_bwd_refuses_a_row_wider_than_its_largest_cluster():
    from distillclip_tpu_torch.ops import _build

    rng = np.random.default_rng(3)
    C = _build.lib().dc_dense_ln_bwd_max_c() + 32
    x, ls, lb = _bf16(rng, (4, C)), _bf16(rng, (C,)), _bf16(rng, (C,))
    w, du = _bf16(rng, (C, 8)), _bf16(rng, (4, 8))
    mean = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="too wide"):
        fc1_act.dense_ln_bwd(x, ls, lb, w, du, mean, mean)
    # K1 takes the width (its tiles hold 64 columns of C at a time)
    _close(fc1_act.dense_ln(x, ls, lb, w), fc1_act.dense_ln_plain(
        x.float(), ls.float(), lb.float(), w.float()))


def test_dense_ln_bwd_clusters_fit_the_card():
    from distillclip_tpu_torch.ops import _build

    # the du mode and the activation mode (whose rings take more shared memory)
    assert _build.lib().dc_dense_ln_bwd_max_clusters(768, 0) >= 1
    assert _build.lib().dc_dense_ln_bwd_max_clusters(1024, 1) >= 1


# -- EVA-02's modes of the LN GEMM (the EVA-02-CLIP teacher) --------------------

def _eva_ln_args(rng, rows, C, N, width=None):
    """x zero past ``width`` (and γ, β, W's rows there), as EVA's padded
    SwiGLU rows reach LN_ffn."""
    width = width or C
    x, ls, lb = _bf16(rng, (rows, C), 1.0, 0.3), _bf16(rng, (C,), 0.1, 1.0), _bf16(rng, (C,), 0.1)
    w, b = _bf16(rng, (C, N), width ** -0.5), _bf16(rng, (N,), 0.1)
    for t in (x[:, width:], ls[width:], lb[width:], w[width:]):
        t.zero_()
    return x, ls, lb, w, b


@pytest.mark.parametrize("B,grid,C,heads", [(3, 3, 64, 4), (5, 4, 256, 4), (4, 16, 1024, 16)],
                         ids=["tiny", "ragged", "eva_l14"])
def test_dense_ln_rope_kernel_matches_plain(B, grid, C, heads):
    from distillclip_tpu_torch.models.eva_vit import rope_table

    seq, hd = grid * grid + 1, C // heads
    rng = np.random.default_rng(seq + C)
    x, ls, lb, w, b = _eva_ln_args(rng, B * seq, C, 3 * C)
    cs = rope_table(grid, hd).cuda()
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = fc1_act.dense_ln_rope(x, ls, lb, w, b, cs, seq, hd, 2 * C, 1e-6)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "dense_ln_rope": 1}
    ref = fc1_act.dense_ln_rope_plain(x.float(), ls.float(), lb.float(), w.float(), b.float(),
                                      cs, seq, hd, 2 * C, 1e-6)
    _close(out, ref)


@pytest.mark.parametrize("rows,C,N", [(1, 32, 16), (65, 96, 384), (257 * 4, 1024, 5504)],
                         ids=["one_row", "ragged", "eva_l14"])
def test_dense_swiglu_ln_kernel_matches_plain(rows, C, N):
    rng = np.random.default_rng(rows + C + N)
    x, ls, lb, w, b = _eva_ln_args(rng, rows, C, N)
    with torch.inference_mode():
        out = fc1_act.dense_swiglu_ln(x, ls, lb, w, b, 1e-6)
    assert out.shape == (rows, N // 2)
    ref = fc1_act.dense_swiglu_ln_plain(x.float(), ls.float(), lb.float(), w.float(), b.float(),
                                        1e-6)
    _close(out, ref)


@pytest.mark.parametrize("rows,C,width,N", [(65, 192, 170, 64), (257 * 4, 2752, 2730, 1024)],
                         ids=["tiny", "eva_l14"])
def test_dense_ln_width_kernel_matches_plain(rows, C, width, N):
    rng = np.random.default_rng(rows + width)
    x, ls, lb, w, b = _eva_ln_args(rng, rows, C, N, width)
    with torch.inference_mode():
        out = fc1_act.dense_ln_width(x, ls, lb, w, b, width, 1e-6)
    ref = fc1_act.dense_ln_width_plain(x.float(), ls.float(), lb.float(), w.float(), b.float(),
                                       width, 1e-6)
    _close(out, ref)
    # the moments are the true width's, not the padded row's: at 2730 of 2752
    # the two differ by 0.4% in rstd, under the bf16 store's rounding element
    # by element but not on the mean (0.0012 against 0.0033 at EVA-L's shape)
    padded = fc1_act.dense_ln_width_plain(x.float(), ls.float(), lb.float(), w.float(),
                                          b.float(), C, 1e-6)
    assert (out.float() - ref).abs().mean() < 0.5 * (out.float() - padded).abs().mean()


def test_tiny_eva_teacher_on_card_matches_plain_cpu_path(tmp_path):
    """A fabricated EVA-02-CLIP tower (two heads of 64 at 3 × 3 patches, and
    at 16 × 16 and 17 × 17, past 256 tokens, where attention is the long-row
    kernel) through the frozen teacher: each mode and each attention kernel
    once a block, the card against the fp32 CPU path."""
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher
    from distillclip_tpu_torch.tools.fabricate_teacher import make_eva_state_dict

    for res in (42, 224, 238):
        path = tmp_path / f"eva_{res}.pt"
        torch.save(make_eva_state_dict(width=128, layers=2, image_resolution=res), str(path))
        card, cpu = (FrozenTeacher(str(path), None, "image", None, dt)
                     for dt in (torch.bfloat16, torch.float32))
        images = np.random.default_rng(res).integers(0, 256, (5, res, res, 3), dtype=np.uint8)
        ops.reset_launch_counts()
        out = card.image_encode("cuda")(images)
        counts = ops.launch_counts()
        assert counts["dense_ln_rope"] == counts["dense_swiglu_ln"] == 2
        assert counts["dense_ln_width"] == counts["dense_ln"] == 2
        assert counts["plain_attention_rows_qkv"] == (2 if res == 42 else 0)
        # 257 and 290 tokens: the long-row kernel, once a layer
        assert counts["plain_attention_long"] == (0 if res == 42 else 2)
        cos = torch.nn.functional.cosine_similarity
        assert cos(out.cpu(), cpu.image_encode("cpu")(images)).min() > 0.999
