"""The port's tools (``distillclip_tpu_torch/tools``) on the CPU: the kernel
oracle's verdict, the trajectory verdict against the JAX package's, the
roofline's counts, the trace digest, the input bench, the cached-teacher A/B
and the experiment grid tools."""

import json

import numpy as np
import pytest
import torch
import yaml

from distillclip_tpu.tools import hw_trajectory as jax_trajectory
from distillclip_tpu_torch.tools import (
    cached_teacher_ab,
    experiments,
    hw_oracle,
    hw_trajectory,
    input_bench,
    roofline,
    trace_summary,
)

TOOLS = (hw_oracle, hw_trajectory, roofline, trace_summary, input_bench, cached_teacher_ab,
         experiments)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_help(tool, capsys):
    with pytest.raises(SystemExit) as done:
        tool.main(["--help"])
    assert done.value.code == 0 and "usage" in capsys.readouterr().out


# -- hw_trajectory --------------------------------------------------------------------

def test_compare_envelope():
    """The JAX tool's four cases: wrong math fails the early window; drift
    inside the shadow envelope passes; drift far beyond it fails late too."""
    compare = hw_trajectory.compare
    base = [1.0 / (i + 1) for i in range(20)]
    v = compare(base, base, shadow=base)
    assert v["ok"] and v["early_ok"] and v["final_ok"]
    wrong = [x * 2.0 for x in base]
    v = compare(wrong, base, shadow=base)
    assert not v["ok"] and not v["early_ok"]
    drift = [x * (1.0 + (0.05 if i > 8 else 0.0)) for i, x in enumerate(base)]
    shadow = [x * (1.0 - (0.04 if i > 7 else 0.0)) for i, x in enumerate(base)]
    assert compare(drift, base, shadow=shadow)["ok"]
    blowup = [x * (1.0 + (3.0 if i > 10 else 0.0)) for i, x in enumerate(base)]
    v = compare(blowup, base, shadow=shadow)
    assert not v["ok"] and v["envelope_broken_at"] is not None


@pytest.mark.parametrize("seed", range(4))
def test_compare_equals_jax_on_seeded_curves(seed):
    rng = np.random.default_rng(seed)
    cpu = list(np.exp(-np.linspace(0, 2, 30)) * (1 + 0.1 * rng.random(30)))
    dev = [x * (1 + rng.normal(0, 0.004 * (1 + i / 3))) for i, x in enumerate(cpu)]
    shadow = [x * (1 + rng.normal(0, 0.002 * (1 + i / 3))) for i, x in enumerate(cpu)]
    for args in ((dev, cpu, shadow), (dev, cpu), (cpu, dev, shadow)):
        assert hw_trajectory.compare(*args) == jax_trajectory.compare(*args)


def test_trajectory_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(hw_trajectory, "CACHE", tmp_path)
    losses = hw_trajectory.run_trajectory(steps=3, device="cpu")
    shadow = hw_trajectory.run_trajectory(steps=3, device="cpu", perturb=1e-3)
    assert len(losses) == 3 and np.isfinite(losses).all() and np.isfinite(shadow).all()
    assert losses != shadow
    assert hw_trajectory.compare(losses, losses, shadow)["ok"]


# -- hw_oracle --------------------------------------------------------------------------

def _case(kernel, off):
    x = torch.linspace(-1.0, 1.0, 64).reshape(8, 8)
    return hw_oracle.Case(kernel, "8x8", lambda: (x + off,), lambda: (x,), (("abs", 1e-3),),
                          lambda: x, 128.0, 512.0)


def test_oracle_exits_1_on_an_injected_disagreement(monkeypatch, capsys):
    cases = [_case("layer_norm_rows", 0.0), _case("dense_ln", 0.0)]
    monkeypatch.setattr(hw_oracle, "oracle_cases", lambda rng, samples, device, only: list(cases))
    assert hw_oracle.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("oracle ") == 2
    cases.append(_case("dense_ln", 0.5))
    assert hw_oracle.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL dense_ln 8x8: output 0 disagrees" in out and "2 of 3 cases agree" in out
    assert hw_oracle.main(["--device", "cpu", "--only", "layer_norm"]) == 0
    assert hw_oracle.main(["--device", "cpu", "--only", "nothing_like_it"]) == 2


def test_oracle_limits_hold_on_a_real_case():
    """One of the table's own cases, built small on the CPU: the plain
    version in bf16 against fp32 meets the kernel's limits."""
    cases = [c for c in hw_oracle.oracle_cases(np.random.default_rng(0), samples=2, device="cpu")
             if c.kernel == "layer_norm_rows" and c.label.startswith("[77,40]")]
    assert len(cases) == 1
    with torch.no_grad():
        assert hw_oracle.check_case(cases[0]) <= 1e-2


@pytest.mark.parametrize("kernel", ["dense_ln_rope", "dense_swiglu_ln", "dense_ln_width",
                                    "plain_attention_long"])
def test_eva_oracle_cases_hold_on_the_cpu(kernel, monkeypatch):
    """EVA-02's modes and its long-row attention at the EVA cell's widths
    (one picture's 4 x 257 rows): the plain version in bf16 meets the limits,
    K1w's case refuses a kernel that takes the moments over the padded row,
    and the attention's library time is the materialised bf16 attention of
    the same function."""
    from distillclip_tpu_torch.ops import fc1_act

    cases = [c for c in hw_oracle.oracle_cases(np.random.default_rng(0), samples=1,
                                               device="cpu", only=kernel)
             if c.kernel == kernel]
    assert len(cases) == 1
    with torch.no_grad():
        assert hw_oracle.check_case(cases[0]) <= 1e-2
        if kernel == "dense_ln_width":
            plain = fc1_act.dense_ln_width_plain
            monkeypatch.setattr(fc1_act, "dense_ln_width",
                                lambda x, ls, lb, w, b, width, eps: plain(x, ls, lb, w, b,
                                                                          x.shape[1], eps))
            with pytest.raises(hw_oracle.Disagreement, match="true width"):
                hw_oracle.check_case(cases[0])
        if kernel == "plain_attention_long":
            ref = cases[0].ref()[0]
            assert (cases[0].library().float() - ref).abs().max() < 3e-2


# -- roofline ---------------------------------------------------------------------------

def test_roofline_text_dense_flops_equal_a_hand_count():
    comps = {c.name: c for c in roofline.text_components(256)}
    rows, C, L = 256 * 77, 768, 4       # 77 tokens, 768 wide, 4 logical layers
    # forward, dX and dW: three products of 2·rows·Cin·Cout each, per layer
    assert comps["qkv projection (K1 / #9)"].gflops == pytest.approx(
        3 * 2 * rows * C * 3 * C * L / 1e9)
    assert comps["mlp fc1 + gelu (#8 / #9)"].gflops == pytest.approx(
        3 * 2 * rows * C * 4 * C * L / 1e9)
    assert comps["mlp fc2"].gflops == comps["mlp fc1 + gelu (#8 / #9)"].gflops
    assert comps["attn out proj"].gflops == pytest.approx(3 * 2 * rows * C * C * L / 1e9)
    attn = comps["transform attention (#5 + #6)"]
    mix = 2 * 256 * 12 * 12 * 77 * 77 * L / 1e9
    assert attn.issued_gflops - attn.gflops == pytest.approx(mix)      # a seventh mix issued
    out = roofline.roofline("text", 256)
    assert out["floor_ms"] == pytest.approx(sum(c.min_ms for c in comps.values()))
    c = comps["mlp fc2"]
    assert c.min_ms == pytest.approx(max(c.gflops / 989.0, c.gbytes / 3.35))


def test_roofline_json(capsys):
    assert roofline.main(["--stage", "joint", "--batch", "8", "--step-ms", "2", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["stage"] == "joint" and out["step_over_floor"] == pytest.approx(2 / out["floor_ms"])
    assert any(c["name"].startswith("img-teacher") for c in out["components"])


# -- trace_summary ------------------------------------------------------------------------

def _synthetic_trace(tmp_path, phases: bool = False):
    """A chrome trace as torch.profiler writes it: host spans, runtime calls
    and the device events they launched; with ``phases`` also the step's
    phase spans around the launches (the second from autograd's thread)."""
    ev = []
    for s in range(3):
        t = 1000.0 * s
        if phases:
            ev += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t + a, "dur": 10,
                    "tid": 1} for name, a in (("step.student", 15), ("step.backward", 28),
                                              ("step.optimizer", 38))]
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "host_to_device", "ts": t, "dur": 10},
            {"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": t + 10, "dur": 100},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 20,
             "dur": 5, "args": {"correlation": 3 * s}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 30,
             "dur": 5, "tid": 2, "args": {"correlation": 3 * s + 1}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": t + 40,
             "dur": 5, "args": {"correlation": 3 * s + 2}},
            {"ph": "X", "cat": "kernel", "name": "void dense_ln_wgmma_kernel<1, 0>(Params)",
             "ts": t + 200, "dur": 300, "args": {"correlation": 3 * s}},
            {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16bf16_bf16f32",
             "ts": t + 500, "dur": 100, "args": {"correlation": 3 * s + 1}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
             "ts": t + 600, "dur": 50, "args": {"correlation": 3 * s + 2}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t + 20, "dur": 9999},
        ]
    path = tmp_path / "run" / "torch_trace" / "trace.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"traceEvents": ev}))
    return tmp_path / "run"


def test_trace_summary_groups_device_events_by_family(tmp_path, capsys):
    run = _synthetic_trace(tmp_path)
    out = trace_summary.summarize(run, steps=3, ops=2)
    fams = {f["family"]: f for f in out["families"]}
    assert fams["K2 / #8 dense_act_ln + dense_act_ln_res (wgmma, activation epilogue)"][
        "ms_per_step"] == 0.3
    assert fams["library products (cuBLAS)"]["count"] == 3
    assert fams["copies and memset"]["ms_per_step"] == 0.05
    assert out["device_total_ms_per_step"] == 0.45 and len(fams) == 3
    assert out["ops"][0]["op"].startswith("void dense_ln_wgmma_kernel<1")
    assert trace_summary.family_of("ELEMENTWISE_kernel<add>") == trace_summary.REST
    split = trace_summary.trace_split(run / "torch_trace" / "trace.json", skip=1)
    assert split["steps"] == 2 and split["host_step_ms"] == 1.0
    assert split["device_busy_ms"] == pytest.approx(0.45)
    assert trace_summary.main([str(run), "--steps", "3"]) == 0
    assert "ms/step" in capsys.readouterr().out


def test_trace_split_by_phase_spans(tmp_path):
    """Each ``step.*`` span's device ms is the work launched while it was
    open, from whichever thread; its host ms is its own length."""
    run = _synthetic_trace(tmp_path, phases=True)
    phases = trace_summary.trace_split(run / "torch_trace" / "trace.json", skip=1)["phases"]
    assert phases == {"step.backward": {"device_ms": 0.1, "host_ms": 0.01},
                      "step.optimizer": {"device_ms": 0.05, "host_ms": 0.01},
                      "step.student": {"device_ms": 0.3, "host_ms": 0.01}}
    plain = trace_summary.trace_split(_synthetic_trace(tmp_path / "plain") / "torch_trace"
                                      / "trace.json", skip=1)
    assert plain["phases"] == {}


# -- input_bench, cached_teacher_ab, experiments ----------------------------------------

def test_input_bench_on_sixteen_images(tmp_path):
    from distillclip_tpu_torch.tools.fabricate_images import fabricate

    fabricate(str(tmp_path / "corpus"), n_train=16, n_val=1, size=32)
    out = input_bench.run(str(tmp_path / "corpus"), n=16, threads_list=[1], image_size=32,
                          n_captions=64, device="cpu", cache_dir=str(tmp_path),
                          batch_size=4)
    for variant in ("uint8_augment", "f32_augment", "uint8_noaugment"):
        assert out["images_per_s"][variant]["1"] > 0
    assert out["captions_per_s"]["python"] > 0


def test_cached_teacher_ab_smallest_scale(tmp_path):
    out = cached_teacher_ab.run_ab(str(tmp_path), epochs=1, n_train=32, n_val=32,
                                   device="cpu")
    assert set(out) == {"augmented_live", "noaugment_cached"}
    for metrics in out.values():
        assert np.isfinite(metrics["val_loss/loss"])
        assert "val_stu_acc/stu_acc_top1" in metrics


def test_experiments_scaffold_merge_and_dry_run(tmp_path, capsys):
    cfg_dir = tmp_path / "config"
    rc = experiments.main(["scaffold", "-e", "my_ex", "-v", "2", "-c", str(cfg_dir),
                           "-t", str(cfg_dir / "missing.yaml")])
    assert rc == 0
    assert (cfg_dir / "my_ex" / "version_1" / "version.yaml").exists()
    (cfg_dir / "my_ex" / "share.yaml").write_text(
        yaml.safe_dump({"model": {"a": 1, "b": 2}, "trainer": {"max_epochs": 5}}))
    (cfg_dir / "my_ex" / "version_0" / "version.yaml").write_text(
        yaml.safe_dump({"model": {"b": 9}}))
    rc = experiments.main(["merge", "-n", "my_ex", "-v", "version_0", "-c", str(cfg_dir)])
    assert rc == 0
    final = yaml.safe_load((cfg_dir / "my_ex" / "version_0" / "final.yaml").read_text())
    assert final["model"] == {"a": 1, "b": 9}
    capsys.readouterr()
    rc = experiments.main(["run", "-e", "my_ex", "--all_ver", "-c", str(cfg_dir), "--dry-run",
                           "--device", "cpu"])
    assert rc == 0
    runs = [l for l in capsys.readouterr().out.splitlines() if l.startswith("DRY RUN:")]
    assert len(runs) == 2 and all("-m distillclip_tpu_torch.cli fit -c" in l
                                  and l.endswith("--device cpu") for l in runs)


def test_experiments_template(tmp_path):
    out = tmp_path / "tpl.yaml"
    assert experiments.main(["template", "bs", "--out", str(out)]) == 0
    tpl = yaml.safe_load(out.read_text())
    assert tpl["trainer"]["profiler"] == "simple"
    assert tpl["trainer"]["limit_train_batches"] == 20
