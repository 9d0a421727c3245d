"""The port's phase spans (``training.profiling.span``) on the CPU, tiny towers.

Under ``torch.profiler`` every train step emits ``step.student``,
``step.teacher``, ``step.loss``, ``step.backward`` and ``step.optimizer``
once each, side by side on the calling thread, and the score stream emits
``score.stage``, ``score.launch`` and ``score.wait`` once per batch.  With no
profiler running neither enters ``record_function``: a span is a flag check.
"""

import json

import numpy as np
import pytest
import torch

from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
from distillclip_tpu_torch.serving import LCLIPScorer
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
from distillclip_tpu_torch.training import DistillTask, DualDistillTask
from distillclip_tpu_torch.training.profiling import span

STEP = ("step.student", "step.teacher", "step.loss", "step.backward", "step.optimizer")
SCORE = ("score.stage", "score.launch", "score.wait")
B, RES, CTX, VOCAB, OUT = 4, 32, 13, 100, 32
TOWER = dict(out_dim=OUT, embed_dim=32, depth=1, num_heads=2, repeated_times=1)
LOSSES = {"loss_name": ["out_l1", "out_cos"]}
CALL = "test.call"


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    path = tmp_path_factory.mktemp("teacher") / "tiny_clip.pt"
    torch.save(make_clip_state_dict(vision_width=64, vision_layers=1, patch_size=8,
                                    image_resolution=RES, text_width=64, text_layers=1,
                                    context_length=CTX, vocab_size=VOCAB, embed_dim=OUT),
               str(path))
    return str(path)


def _image():
    return RepeatVisionTransformer(img_size=RES, patch_size=8, qkv_bias=True,
                                   use_transform=True, **TOWER)


def _text():
    return RepeatTextTransformer(vocab_size=VOCAB, context_length=CTX, use_transform=True,
                                 **TOWER)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB - 1, size=(B, CTX))
    tokens[:, 6] = VOCAB - 1
    images = rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
    return torch.from_numpy(tokens), torch.from_numpy(images), torch.randn(B, OUT)


def _dual_step(teacher, cached_text):
    task = DualDistillTask(image_student=_image(), text_student=_text(),
                           loss_control_para=LOSSES, teacher_name=teacher,
                           compute_dtype="float32")
    state, tx = task.init_state(0, 1, device="cpu")
    step = task.make_train_step(tx, cached_text_teacher=cached_text)
    tokens, images, rep = _batch()
    return lambda: step(state, tokens, images, *([rep] if cached_text else []))


def _distill_step(teacher):
    task = DistillTask(student=_image(), loss_control_para=LOSSES, teacher_name=teacher,
                       compute_dtype="float32", model_type="image")
    state, tx = task.init_state(0, 1, device="cpu")
    step = task.make_train_step(tx)
    images = _batch()[1]
    return lambda: step(state, images)


def _traced(work, tmp_path) -> list:
    """The program's spans (and the enclosing :data:`CALL`) of ``work()``
    run under the profiler: (start, end, name, thread id), in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALL):
            work()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(("step.", "score.", CALL)))


def _assert_siblings(spans):
    """Every program span on the thread of :data:`CALL`, inside it, and none
    inside another."""
    call = next(s for s in spans if s[2] == CALL)
    phases = [s for s in spans if s[2] != CALL]
    assert all(s[3] == call[3] and call[0] <= s[0] and s[1] <= call[1] for s in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:])), phases


@pytest.mark.parametrize("which", ["dual_cached_text", "dual_live", "distill_live"])
def test_train_step_emits_each_phase_once(which, teacher, tmp_path):
    work = {"dual_cached_text": lambda: _dual_step(teacher, True),
            "dual_live": lambda: _dual_step(teacher, False),
            "distill_live": lambda: _distill_step(teacher)}[which]()
    work()                     # the teacher is built at first use, outside the trace
    spans = _traced(work, tmp_path)
    _assert_siblings(spans)
    assert [s[2] for s in spans if s[2] != CALL] == list(STEP)


@pytest.fixture(scope="module")
def scorer():
    return LCLIPScorer(_image(), _text(), device="cpu", dtype=torch.float32)


def test_score_stream_emits_three_spans_a_batch(scorer, tmp_path):
    batches = [_batch(seed)[:2][::-1] for seed in range(3)]
    out = []
    spans = _traced(lambda: out.extend(scorer.score_tokens_stream(iter(batches), depth=2)),
                    tmp_path)
    assert len(out) == 3
    _assert_siblings(spans)
    names = [s[2] for s in spans if s[2] != CALL]
    assert {n: names.count(n) for n in SCORE} == {n: 3 for n in SCORE}
    # the first two batches launch before the oldest is waited on (depth 2)
    assert names[:5] == ["score.stage", "score.launch", "score.stage", "score.launch",
                         "score.wait"]


def test_no_profiler_no_record_function(teacher, scorer, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    step = _dual_step(teacher, True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("step.student"):
        pass
    step()
    batches = [_batch(seed)[:2][::-1] for seed in range(2)]
    assert len(list(scorer.score_tokens_stream(iter(batches), depth=2))) == 2
