"""Parity of the PyTorch port's ops (distillclip_tpu_torch.ops) with the JAX
package's, on the CPU.

Each port function runs its plain PyTorch version here (the tensors lie on
the CPU); the JAX function runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it (conftest sets DISTILLCLIP_FLASH=1).  Inputs
are made with numpy from a seed and handed to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillclip_tpu.ops import fc1_act as jax_fc1
from distillclip_tpu.ops import layer_norm as jax_ln
from distillclip_tpu.ops import transform_attention as jax_ta
from distillclip_tpu_torch import ops
from distillclip_tpu_torch.ops import _build


def _arrays(seed, *specs):
    """float32 arrays of the given (shape, std, mean) from one numpy seed."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * std + mean).astype(np.float32)
            for shape, std, mean in specs]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- K4: row LayerNorm -------------------------------------------------------

@pytest.mark.parametrize("rows,C", [(16, 32), (37, 48)])
def test_layer_norm_rows_matches_jax(rows, C):
    x, s, b = _arrays(rows, ((rows, C), 2.0, 0.5), ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    ref = np.asarray(jax_ln.layer_norm_rows(*_j(x, s, b), eps=1e-5))
    out = ops.layer_norm_rows(*_t(x, s, b), eps=1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


# -- K1 / K2: LayerNorm-prologue dense layers --------------------------------

@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_dense_ln_matches_jax(bias):
    rows, C, N = 24, 32, 96
    x, ls, lb, w, b = _arrays(1, ((rows, C), 1.0, 0.0), ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                              ((C, N), 0.1, 0.0), ((N,), 0.1, 0.0))
    b = b if bias else None
    ref = np.asarray(jax_fc1.dense_ln(*_j(x, ls, lb, w), None if b is None else jnp.asarray(b)))
    out = ops.dense_ln(*_t(x, ls, lb, w), None if b is None else torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("act", ["gelu_exact", "quick_gelu"])
def test_dense_act_ln_matches_jax(act):
    rows, C, N = 40, 32, 128
    x, ls, lb, w, b = _arrays(2, ((rows, C), 1.0, 0.3), ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                              ((C, N), 0.2, 0.0), ((N,), 0.1, 0.0))
    ref = np.asarray(jax_fc1.dense_act_ln(*_j(x, ls, lb, w, b), act=act))
    out = ops.dense_act_ln(*_t(x, ls, lb, w, b), act=act).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_dense_act_ln_refuses_unknown_activation():
    x, ls, lb, w, b = _t(*_arrays(3, ((4, 8), 1, 0), ((8,), 1, 0), ((8,), 1, 0),
                                  ((8, 8), 1, 0), ((8,), 1, 0)))
    with pytest.raises(ValueError, match="unknown activation"):
        ops.dense_act_ln(x, ls, lb, w, b, act="relu")


# -- K3: head-transform attention --------------------------------------------

_D = 8  # head dim of the parity cases


def _qkv_case(H, N, qkv_bias, B=2, C=32, seed=4):
    """qkv [B·N, 3·H·d] made as the towers make it, by dense_ln (with or
    without the qkv bias).  conv_l at std H^-1/2 makes the mixed logits of
    std ~1, so the softmax is far from uniform; conv_w at half that keeps the
    outputs within ~1, where the JAX kernel's bf16 probabilities (relative
    error ~2^-8) stay inside the 8e-3 tolerance."""
    x, ls, lb, w, b, wl, ww = _arrays(
        seed + H + N, ((B * N, C), 1.0, 0.0), ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
        ((C, 3 * H * _D), C ** -0.5, 0.0), ((3 * H * _D,), 0.1, 0.0),
        ((H, H), H ** -0.5, 0.0), ((H, H), 0.5 * H ** -0.5, 0.0))
    qkv = ops.dense_ln(*_t(x, ls, lb, w), torch.from_numpy(b) if qkv_bias else None)
    return qkv.numpy(), wl, ww


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("N", [17, 32])
@pytest.mark.parametrize("H", [4, 12])
def test_transform_attention_matches_jax_kernel(H, N, qkv_bias):
    """Against the Pallas kernel in interpret mode.  8e-3: that kernel rounds
    the mixes and the probabilities to bf16 (transform_attention.py:107,113,
    169-170); the port's plain version keeps them in fp32."""
    qkv, wl, ww = _qkv_case(H, N, qkv_bias)
    ref = np.asarray(jax_ta.transform_attention_rows_qkv(*_j(qkv, wl, ww), heads=H, seq=N))
    out = ops.transform_attention_rows_qkv(*_t(qkv, wl, ww), heads=H, seq=N).numpy()
    assert out.shape == (qkv.shape[0], H * _D)
    np.testing.assert_allclose(out, ref, atol=8e-3, rtol=0)


@pytest.mark.parametrize("N", [17, 32])
@pytest.mark.parametrize("H", [4, 12])
def test_transform_attention_matches_jax_xla_fp32(H, N):
    """Against the JAX package's XLA reference math in fp32: 1e-5."""
    qkv, wl, ww = _qkv_case(H, N, qkv_bias=True)
    HD, B = H * _D, qkv.shape[0] // N
    q, k, v = (jnp.asarray(qkv[:, i * HD:(i + 1) * HD].reshape(B, N, HD)) for i in range(3))
    scale = _D ** -0.5
    ref = np.asarray(jax_ta._xla_transform_rows(q, k, v, jnp.asarray(wl), jnp.asarray(ww),
                                                scale, N, H)).reshape(B * N, HD)
    out = ops.transform_attention_rows_qkv(*_t(qkv, wl, ww), heads=H, seq=N,
                                           scale=scale).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_transform_attention_refuses_bad_shapes():
    qkv, wl, ww = _t(*_arrays(5, ((10, 3 * 4 * 8), 1, 0), ((4, 4), 1, 0), ((4, 4), 1, 0)))
    with pytest.raises(ValueError, match="transform_attention_rows_qkv"):
        ops.transform_attention_rows_qkv(qkv, wl, ww, heads=4, seq=3)  # 10 % 3 rows
    with pytest.raises(ValueError, match="transform_attention_rows_qkv"):
        ops.transform_attention_rows_qkv(qkv, wl[:3, :3], ww, heads=4, seq=5)


# -- the wrappers ------------------------------------------------------------

def _op_calls():
    x, ls, lb, w, b, wl, ww = _t(*_arrays(6, ((10, 16), 1, 0), ((16,), 1, 0), ((16,), 1, 0),
                                         ((16, 48), 1, 0), ((48,), 1, 0), ((2, 2), 1, 0),
                                         ((2, 2), 1, 0)))
    qkv = torch.randn(10, 48, generator=torch.Generator().manual_seed(0))
    qkv64 = torch.randn(10, 3 * 64, generator=torch.Generator().manual_seed(1))  # a head of 64
    do, p = qkv[:, :16].contiguous(), torch.full((2, 2, 5, 5), 0.2)
    stat = torch.ones(10)
    kw = dict(heads=2, seq=5, scale=0.5)
    q4 = qkv.view(2, 5, 3, 2, 8).permute(2, 0, 3, 1, 4).unbind(0)     # [B, H, N, d] views
    cs = torch.rand(4, 4, 2)                    # (cos, sin) of 4 patches, heads of 8
    on = lambda dev, *ts: (t.to(dev) for t in ts)
    return {
        "dense_ln": lambda dev: ops.dense_ln(*on(dev, x, ls, lb, w, b)),
        "dense_act_ln": lambda dev: ops.dense_act_ln(*on(dev, x, ls, lb, w, b)),
        "transform_attention_rows_qkv": lambda dev: ops.transform_attention_rows_qkv(
            *on(dev, qkv, wl, ww), heads=2, seq=5),
        "transform_attention_rows_qkv_wide": lambda dev: ops.transform_attention_rows_qkv_wide(
            *on(dev, qkv, wl, ww), **kw),
        "layer_norm_rows": lambda dev: ops.layer_norm_rows(*on(dev, x, ls, lb)),
        "transform_attention_save_p": lambda dev: ops.transform_attention_save_p(
            *on(dev, qkv, wl, ww), **kw)[0],
        "transform_attention_bwd": lambda dev: ops.transform_attention_bwd(
            *on(dev, qkv, wl, ww, do, p), **kw)[0],
        "layer_norm_rows_bwd": lambda dev: ops.layer_norm_rows_bwd(
            *on(dev, x, ls, x, stat, stat))[0],
        "dense_act_ln_res": lambda dev: ops.dense_act_ln_res(*on(dev, x, ls, lb, w, b))[0],
        "dense_ln_bwd": lambda dev: ops.dense_ln_bwd(
            *on(dev, x, ls, lb, w, qkv, stat, stat))[0],
        "plain_attention_rows_qkv": lambda dev: ops.plain_attention_rows_qkv(
            *on(dev, qkv), heads=2, seq=5, causal=True),
        "plain_attention_save_p": lambda dev: ops.plain_attention_save_p(
            *on(dev, qkv), kv_len=4, **kw)[0],
        "plain_attention_bwd": lambda dev: ops.plain_attention_bwd(*on(dev, qkv, do, p), **kw),
        "flash_attention_fwd": lambda dev: ops.flash_attention_fwd(
            *on(dev, *q4), scale=0.5, causal=True)[0],
        "flash_attention_bwd": lambda dev: ops.flash_attention_bwd(
            *on(dev, *q4, q4[0], torch.zeros(2, 2, 5), q4[1]), scale=0.5)[0],
        "flash_transform_attention_fwd": lambda dev: ops.flash_transform_attention_fwd(
            *on(dev, *q4, wl, ww), scale=0.5, kv_len=4),
        "flash_transform_attention_fwd_wide": lambda dev: ops.flash_transform_attention_fwd_wide(
            *on(dev, *q4, wl, ww), scale=0.5, causal=True),
        "dense_act": lambda dev: ops.dense_act(*on(dev, x, w, b)),
        "dense_act_res": lambda dev: ops.dense_act_res(*on(dev, x, w, b), "quick_gelu")[0],
        "dense_act_u": lambda dev: ops.dense_act_u(*on(dev, x, w, b)),
        "transform_attention_save_p_wide": lambda dev: ops.transform_attention_save_p_wide(
            *on(dev, qkv, wl, ww), **kw)[0],
        "transform_attention_bwd_wide": lambda dev: ops.transform_attention_bwd_wide(
            *on(dev, qkv, wl, ww, do, p), **kw)[0],
        "dense_ln_rope": lambda dev: ops.dense_ln_rope(*on(dev, x, ls, lb, w, b, cs), seq=5,
                                                       hd=8, rot=32),
        "dense_swiglu_ln": lambda dev: ops.dense_swiglu_ln(*on(dev, x, ls, lb, w, b)),
        "dense_ln_width": lambda dev: ops.dense_ln_width(*on(dev, x, ls, lb, w, b), width=12),
        "plain_attention_long": lambda dev: ops.plain_attention_long(*on(dev, qkv64), heads=1,
                                                                     seq=5),
    }


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_cpu_tensor_runs_plain_version_without_counting(name):
    ops.reset_launch_counts()
    out = _op_calls()[name]("cpu")
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_other_devices_are_refused(name):
    """Only a CPU tensor takes the plain version; any other non-CUDA device
    raises instead of computing somewhere unexpected."""
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _op_calls()[name]("meta")


def test_build_names_library_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdistillclip_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()  # stable for unchanged sources
    assert {p.name for p in _build._sources()} == {
        "dense_act.cu", "dense_ln_bwd.cu", "dense_ln_wgmma.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "flash_transform_attention.cu",
        "flash_transform_attention_mma.cu", "layer_norm.cu",
        "plain_attention.cu", "plain_attention_bwd.cu", "plain_attention_long.cu",
        "transform_attention.cu",
        "transform_attention_bwd.cu", "transform_attention_bwd_wide.cu",
        "transform_attention_mma.cu"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
