"""The port's eval steps against the JAX package's, fp32 on the CPU.

Each JAX task initialises its tiny students, the parameters cross to the port
through ``convert``, and both eval steps see the same batch with the same
fabricated teacher live (the JAX towers on their XLA path,
DISTILLCLIP_FLASH=0): metrics and representations within 1e-5, retrieval
accuracies equal.  The port's step runs under ``torch.no_grad()`` with the
students in eval mode, so on a card its kernels take their lean routes
(``tests/test_torch_cuda.py`` counts them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.parallel.mesh import create_mesh
from distillclip_tpu_torch.convert import jax_distill_params_to_torch, jax_dual_params_to_torch

from test_teacher import CTX, RES, VOCAB, _make_state_dict
from test_torch_distill import _tasks
from test_torch_training import _jax_task, _np_tree, _port_task

B, OUT = 16, 48


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    """Tokens, images and the other modality's representations of 16 pairs."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return dict(tokens=toks, text=toks, images=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                contrary=rng.normal(size=(B, OUT)).astype(np.float32))


def _assert_eval_parity(metrics, reps, jmetrics, jreps):
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        got, want = float(metrics[k]), float(v)
        if "acc" in k:
            assert got == want, (k, got, want)
        else:
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (k, got, want)
    assert set(reps) == set(jreps)
    for k, v in jreps.items():
        assert reps[k].dtype == torch.float32
        np.testing.assert_allclose(reps[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)


def test_dual_eval_step_matches_jax(ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask = _jax_task(ckpt_path, compute_dtype="float32")
    jstate, _ = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(batch["tokens"][:1]),
                                 jnp.asarray(batch["images"][:1]), steps_per_epoch=1)
    ptask = _port_task(compute_dtype="float32", teacher_name=ckpt_path)
    pstate, _ = ptask.init_state(0, 1, params=jax_dual_params_to_torch(_np_tree(jstate.params)),
                                 device="cpu")
    jmetrics, jreps = jtask.make_eval_step(create_mesh())(
        jstate, jtask.teacher_compute_vars, jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["images"]))
    before = {k: v.clone() for k, v in pstate.params.items()}
    metrics, reps = ptask.make_eval_step()(pstate, torch.from_numpy(batch["tokens"]),
                                          torch.from_numpy(batch["images"]))
    _assert_eval_parity(metrics, reps, jmetrics, jreps)
    assert not ptask.student.training
    assert all(not v.requires_grad for v in metrics.values())
    assert all(torch.equal(before[k], v) for k, v in pstate.params.items())


@pytest.mark.parametrize("model_type", ["text", "image"])
def test_distill_eval_step_matches_jax(model_type, ckpt_path, batch, monkeypatch):
    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    jtask, ptask = _tasks("share", model_type, ckpt_path, compute_dtype="float32")
    x = batch["images" if model_type == "image" else "text"]
    jstate, _ = jtask.init_state(jax.random.PRNGKey(1), jnp.asarray(x[:1]), steps_per_epoch=1)
    pstate, _ = ptask.init_state(0, 1, params=jax_distill_params_to_torch(
        _np_tree(jstate.params), model_type), device="cpu")
    contrary = batch["contrary"]
    jmetrics, jreps = jtask.make_eval_step(create_mesh())(
        jstate, jtask.teacher_compute_vars, jnp.asarray(x), jnp.asarray(contrary))
    metrics, reps = ptask.make_eval_step()(pstate, torch.from_numpy(x), torch.from_numpy(contrary))
    _assert_eval_parity(metrics, reps, jmetrics, jreps)
    assert not ptask.student.training
