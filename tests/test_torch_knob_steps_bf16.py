"""The stage-3 text-cached step in bf16 under the perf knobs that change the
port's function path, against the JAX step on its kernel path under the same
``DISTILLCLIP_*`` variables (``DISTILLCLIP_FLASH=1``: the no-LN fc1 kernels
#10-#12 of ``ops/fc1_act.py``, or its ``fc1_res: u`` mode, in interpret mode),
on the CPU: loss and parts within 2e-2 absolute (the bf16 class).  The fp32
parity of the same steps is in ``test_torch_unfused_steps.py``.
"""

import numpy as np
import pytest
import torch

from test_teacher import CTX, RES, VOCAB, _make_state_dict
from test_torch_teacher_steps import B, _jax_value_and_grad, _port_loss, _states, _tasks
from test_torch_unfused_steps import _knobs


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    toks[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1      # the EOT id
    return dict(tokens=toks, images=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                tea_text=rng.normal(size=(B, 48)).astype(np.float32))


@pytest.mark.parametrize("knobs", [{"fc1_ln": "0"}, {"fc1_ln": "0", "fc1_res": "u"},
                                   {"fc1_res": "u"}],
                         ids=["fc1_ln=0", "fc1_ln=0,fc1_res=u", "fc1_res=u"])
def test_text_cached_loss_under_knobs_matches_jax_kernels_bf16(monkeypatch, knobs, ckpt_path,
                                                                batch):
    """bf16 compute: the port's step against the JAX step through its Pallas
    kernels (interpret mode) under the same knobs, loss and parts 2e-2."""
    _knobs(monkeypatch, **knobs)
    jtask, ptask = _tasks("share", ckpt_path)
    jstate, _, pstate, _ = _states(jtask, ptask, batch)
    (jloss, jparts), _ = _jax_value_and_grad(jtask, "cached_text", jstate.params, batch)
    loss, (parts, _, _) = _port_loss(ptask, "cached_text", pstate.params, batch)
    assert abs(float(loss) - float(jloss)) <= 2e-2
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) <= 2e-2, k
