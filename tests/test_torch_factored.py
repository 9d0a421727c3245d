"""The ``tf_impl: factored`` route (kernel #18 of the JAX package) against the
JAX package on the CPU.

The JAX side is ``transform_attention_rows_qkv`` with
``DISTILLCLIP_TF_IMPL=factored``: in interpret mode it always runs the
per-head Pallas kernels of ``ops/transform_factored.py::tf_factored_qkv``,
padding N to 16 and masking the padded keys with its ``kv_len``.  The port's
``ops.transform_attention_rows_qkv`` (K3 / #5 / #6, which compute the
per-head formulation; here their plain versions) runs at the true N.  The factored kernel rounds its scaled q, the saved P'
and dS to bf16 inside even for fp32 inputs, and the JAX package's own test
holds it to the XLA math within 1e-2 (output) and 2e-2 (gradients) of the
largest entry (``tests/test_flash_attention.py::
test_factored_transform_matches_oracle``): the same limits hold here for the
output and dqkv, dconv_l, dconv_w, in fp32 and in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.ops import transform_attention as jax_ta
from distillclip_tpu_torch import ops

from test_teacher import CTX, RES, VOCAB, _make_state_dict
from test_torch_teacher_steps import B as STEP_B
from test_torch_teacher_steps import _assert_step_parity, _port_loss, _states, _tasks
from test_torch_unfused_steps import _knobs

H, D, B = 4, 16, 2
OUT_TOL, GRAD_TOL = 1e-2, 2e-2


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _case(N, seed):
    """qkv at unit scale and the mixes at std H^-1/2: logits of std ~1."""
    rng = np.random.default_rng(seed)
    f = lambda shape, std: (rng.standard_normal(shape) * std).astype(np.float32)
    return f((B * N, 3 * H * D), 1.0), f((H, H), H ** -0.5), f((H, H), H ** -0.5), \
        f((B * N, H * D), 1.0)


def _jax(qkv, wl, ww, do, N, dtype, kv_len=None):
    fn = lambda q, l, w: jax_ta.transform_attention_rows_qkv(q, l, w, heads=H, seq=N,
                                                             scale=D ** -0.5, kv_len=kv_len)
    args = [jnp.asarray(a, dtype) for a in (qkv, wl, ww)]
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(do, out.dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(qkv, wl, ww, do, N, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (qkv, wl, ww)]
    out = ops.transform_attention_rows_qkv(*leaves, heads=H, seq=N, scale=D ** -0.5)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(dtype))
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [10, 16])
def test_factored_route_matches_jax_tf_factored(monkeypatch, N, dtype):
    monkeypatch.setenv("DISTILLCLIP_TF_IMPL", "factored")
    qkv, wl, ww, do = _case(N, N)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = _jax(qkv, wl, ww, do, N, jdt)
    got = _port(qkv, wl, ww, do, N, tdt)
    for name, g, r, tol in zip(("out", "dqkv", "dconv_l", "dconv_w"), got, ref,
                               (OUT_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert g.shape == r.shape
        assert _rel(g, r) < tol, f"{name}: {_rel(g, r):.3e}"


def test_factored_kv_len_is_the_true_n(monkeypatch):
    """JAX's factored kernel on 16 rows per sample with kv_len = 12 hides the
    last 4 keys; the port computes at the true N = 12.  The first 12 rows of
    the output and of dqkv agree, and JAX's dqkv of the hidden rows is 0 (their
    output gradient is 0 and their keys are masked)."""
    monkeypatch.setenv("DISTILLCLIP_TF_IMPL", "factored")
    Np, n = 16, 12
    qkv, wl, ww, do = _case(Np, 5)
    do.reshape(B, Np, -1)[:, n:] = 0.0
    ref = _jax(qkv, wl, ww, do, Np, jnp.float32, kv_len=n)
    true_rows = lambda a: np.ascontiguousarray(a.reshape(B, Np, -1)[:, :n].reshape(B * n, -1))
    got = _port(true_rows(qkv), wl, ww, true_rows(do), n, torch.float32)
    assert _rel(got[0], true_rows(ref[0])) < OUT_TOL
    assert _rel(got[1], true_rows(ref[1])) < GRAD_TOL
    assert np.abs(ref[1].reshape(B, Np, -1)[:, n:]).max() == 0.0
    for g, r in zip(got[2:], ref[2:]):
        assert _rel(g, r) < GRAD_TOL


def test_factored_knob_leaves_the_towers_unchanged(monkeypatch):
    """K3 computes the per-head formulation already: a student built under
    tf_impl: factored gives the default's values bit for bit."""
    from distillclip_tpu_torch.models import RepeatVisionTransformer
    from distillclip_tpu_torch.serving.lclip_score import seeded_init

    images = torch.from_numpy(np.random.default_rng(3).normal(size=(2, RES, RES, 3))
                              .astype(np.float32))
    outs = []
    for impl in ("colcat", "factored"):
        monkeypatch.setenv("DISTILLCLIP_TF_IMPL", impl)
        tower = RepeatVisionTransformer(img_size=RES, patch_size=8, out_dim=8, embed_dim=32,
                                        depth=2, num_heads=H, repeated_times=2,
                                        use_transform=True)
        with torch.no_grad():
            outs.append(seeded_init(tower, np.random.default_rng(0))(images))
    assert torch.equal(*outs)


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(STEP_B, CTX)).astype(np.int32)
    toks[np.arange(STEP_B), rng.integers(2, CTX, size=STEP_B)] = VOCAB - 1
    return dict(tokens=toks,
                images=rng.normal(size=(STEP_B, RES, RES, 3)).astype(np.float32),
                tea_text=rng.normal(size=(STEP_B, 48)).astype(np.float32))


def test_factored_step_matches_jax(monkeypatch, ckpt_path, batch):
    """The stage-3 text-cached step under tf_impl: factored equals the JAX XLA
    math (DISTILLCLIP_FLASH=0) at the fp32 limits of
    test_torch_unfused_steps.py (loss 1e-5, gradients 1e-4, three AdamW steps
    1e-5), since the port's route computes K3's function, and its loss the
    JAX step through the factored kernel within that kernel's 1e-2."""
    _knobs(monkeypatch, flash="0", tf_impl="factored")
    _, ptask, _ = _assert_step_parity("share", "cached_text", ckpt_path, batch)

    # the JAX factored forward kernel in the step (its backward is held at the
    # op level above)
    monkeypatch.setenv("DISTILLCLIP_FLASH", "1")
    jtask, ptask = _tasks("share", ckpt_path, compute_dtype="float32")
    jstate, _, pstate, _ = _states(jtask, ptask, batch)
    toks, imgs, tea = (jnp.asarray(batch[k]) for k in ("tokens", "images", "tea_text"))
    jloss = jtask.loss_fn_cached_text(jstate.params, jtask.teacher_vars, toks, imgs, tea,
                                      jax.random.PRNGKey(0), True)[0]
    with torch.no_grad():
        loss, _ = _port_loss(ptask, "cached_text", pstate.params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss))
