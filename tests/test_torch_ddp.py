"""Data parallelism of the port (``parallel.distributed``, the sum rule) on
the CPU: two gloo ranks as subprocesses (``tools/dryrun.py``, one torch
thread each) against the single-process step on the global batch, and one
case against the JAX package's step on the global batch.

After three steps the loss is within 1e-6 relative, ``grad_norm`` within
1e-5 and every master within 1e-6 of the single process's, and the ranks'
masters are equal bit for bit.  Every case trains at the learning rate of
``smoke_dual.yaml`` (1e-4), in fp32 (the dry run's dtype on the CPU): Adam
divides a gradient by its root mean square plus 1e-8, so an element whose
gradient is at that scale moves by up to lr · (summation noise) / 1e-8, and
the 1e-6 bound on the masters holds at this rate, not at
``smoke_text.yaml``'s 5e-3.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240

CONTRASTIVE = {"loss_name": ["hard_label", "soft_label", "logits_mse", "fine_grain",
                             "smd_multi_model"], "temperature": 2.0}
# per-layer taps, stacked [L, B, ...] (gathered along their batch axis 1), a
# sum-reduced KL, and vit_kd, whose own variables act after the gather
TAPS = {"loss_name": ["attention_score_mse", "attention_probs_kl", "hidden_rep_mse",
                      "embedding_mse", "vit_kd", "cos_diff"],
        "vit_kd_para": {"student_dims": 64, "teacher_dims": 64, "low_layers_num": 1,
                        "high_layers_num": 1}}
# (config, step, model overrides): the loss sets of the smoke configs, a set
# of the contrastive losses (with cos_diff in smoke_dual.yaml's, every loss of
# IMAGE_TEXT_LOSS sees the gathered batch) and the taps
CASES = {
    "smoke_dual text-cached": ("configs/smoke_dual.yaml", "text-cached", {}),
    "smoke_dual live": ("configs/smoke_dual.yaml", "live", {}),
    "smoke_text live": ("configs/smoke_text.yaml", "live", {}),
    "contrastive live": ("configs/smoke_dual.yaml", "live", {"loss_control_para": CONTRASTIVE}),
    "taps live": ("configs/smoke_dual.yaml", "live",
                  {"loss_control_para": TAPS, "teacher_need_layers": [0, 1]}),
}


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """The smoke configs' teacher shape (the fabricator's defaults)."""
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

    path = tmp_path_factory.mktemp("ddp") / "tiny_clip.pt"
    torch.save(make_clip_state_dict(), str(path))
    return str(path)


def dryrun(tmp_path, *args):
    """(exit code, output, the JSON result) of the dry run with 2 gloo ranks
    (fp32 on the CPU), one torch thread a process."""
    cmd = [sys.executable, "-m", "distillclip_tpu_torch.tools.dryrun", "--procs", "2",
           "--device", "cpu", "--steps", "3", "--timeout", str(TIMEOUT),
           "--work", str(tmp_path / "work"), *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, _ = proc.communicate(timeout=TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        pytest.fail(f"the dry run did not end within {TIMEOUT + 60} s:\n{out[-3000:]}")
    last = out.strip().splitlines()[-1] if out.strip() else "{}"
    return proc.returncode, out, json.loads(last) if last.startswith("{") else {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_the_single_process_step(case, teacher, tmp_path):
    config, step, over = CASES[case]
    cfg = yaml.safe_load(open(os.path.join(ROOT, config)))
    cfg["model"]["init_args"].update(lr=1e-4, **over)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    rc, out, res = dryrun(tmp_path, "--config", str(tmp_path / "config.yaml"), "--step", step,
                          "--teacher", teacher, "--pairs", "8")
    assert rc == 0, out[-3000:]
    assert res["ok"] and res["world"] == 2 and res["same_losses"] and res["masters_equal"]
    assert res["losses"][0] == res["losses"][1]
    assert res["loss_rel_diff"] <= 1e-6 and res["max_master_diff"] <= 1e-6
    assert res["grad_norm_rel_diff"] <= 1e-5
    # the steps trained: the first update has lr 0 under the warm-up, the next do not
    assert res["single_losses"][2] != res["single_losses"][0]


def test_a_mismatch_exits_one(teacher, tmp_path):
    """The dry run's check is live: a bound no float run meets fails it."""
    rc, out, res = dryrun(tmp_path, "--config", "configs/smoke_dual.yaml", "--teacher",
                          teacher, "--pairs", "4", "--master-atol", "-1")
    assert rc == 1 and res["ok"] is False and res["masters_equal"], out[-2000:]


# -- against the JAX package's step on the global batch ---------------------------


def test_two_ranks_equal_jax_on_the_global_batch(tmp_path, monkeypatch):
    """The all-cached stage-3 step of ``tests/test_torch_training.py`` on two
    ranks of 8 rows, from the JAX task's initial parameters, against three
    JAX steps on the 16 rows, at that file's tolerance."""
    from distillclip_tpu_torch.convert import jax_dual_params_to_torch
    from test_teacher import _make_state_dict
    from test_torch_training import (
        B,
        CTX,
        IMAGE_ARGS,
        LOSSES,
        OUT,
        RES,
        TASK_ARGS,
        TEXT_ARGS,
        VOCAB,
        _assert_adam_steps_close,
        _flat,
        _jax_state,
        _jax_task,
        _jax_value_and_grad,
        _np_tree,
    )

    monkeypatch.setenv("DISTILLCLIP_FLASH", "0")
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(ckpt))
    rng = np.random.default_rng(0)

    tokens = rng.integers(1, VOCAB - 1, size=(B, CTX)).astype(np.int32)
    tokens[np.arange(B), rng.integers(2, CTX, size=B)] = VOCAB - 1
    batch = dict(tokens=tokens, images=rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
                 tea_text=rng.normal(size=(B, OUT)).astype(np.float32),
                 tea_image=rng.normal(size=(B, OUT)).astype(np.float32))
    np.savez(tmp_path / "batch.npz", tokens=batch["tokens"], images=batch["images"],
             tea_rep=batch["tea_text"], tea_img_rep=batch["tea_image"])

    jtask = _jax_task(str(ckpt), compute_dtype="float32")
    jstate, jtx = _jax_state(jtask, batch)
    init = jax_dual_params_to_torch(_np_tree(jstate.params))
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in init.items()},
               str(tmp_path / "init.pt"))
    jlosses, first = [], None
    for _ in range(3):
        (loss, _), grads = _jax_value_and_grad(jtask, jstate.params, batch)
        jlosses.append(float(loss))
        first = grads if first is None else first
        jstate = jstate.apply_gradients(grads, jtx)

    node = lambda path, args: {"class_path": path, "init_args": args}
    config = {"model": node("DualDistillModel", {
        "image_student": node("model.component.weight_share_model.RepeatVisionTransformer",
                              IMAGE_ARGS),
        "text_student": node("model.component.weight_share_model.RepeatTextTransformer",
                             TEXT_ARGS),
        "loss_control_para": LOSSES, "teacher_name": str(ckpt), **TASK_ARGS})}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(config))
    rc, out, res = dryrun(tmp_path, "--config", str(tmp_path / "tiny.yaml"), "--step",
                          "all-cached", "--teacher", str(ckpt), "--batch",
                          str(tmp_path / "batch.npz"), "--init", str(tmp_path / "init.pt"),
                          "--out", str(tmp_path / "out.pt"))
    assert rc == 0 and res["ok"], out[-3000:]
    ddp = torch.load(tmp_path / "out.pt", weights_only=False)["ranks"][0]
    np.testing.assert_allclose(ddp["losses"], jlosses, rtol=1e-5, atol=0)
    _assert_adam_steps_close(ddp["masters"], _flat(jstate.params), _flat(first))
