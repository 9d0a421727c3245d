#!/usr/bin/env python3
"""Side-by-side timings of checkouts of the port, in one run on one card.

    python3 chip_ab.py [--only SECTION[,SECTION ...]] ROOT [ROOT ...]

ROOT is the root of a checkout of this repository (``.`` for this one).  In
a fresh Python process per checkout, in the order given and then in the
reverse order, the script imports ``distillclip_tpu_torch`` from ROOT (its
kernels built under ROOT/build/, as ``chip_smoke.py`` builds them) and prints
lines ``ab <ROOT's name> <what>: ...`` that end with the card's name and power
limit (with ``--only``, only the sections named):

- ``build``: nvcc over the checkout's ``distillclip_tpu_torch/csrc/*.cu``
  with its own flags, one process per source and all at once, as its
  ``ops._build`` builds them, into a scratch directory under ROOT/build/ (the
  checkout's library cache untouched): the wall seconds and the four slowest
  sources' seconds (no card needed);
- ``k1``: ``dense_ln`` with its statistics (K1, as a train step runs it) at
  the image and text qkv ([12800, 768] and [19712, 768] -> 2304), the text
  teacher's qkv ([19712, 512] -> 1536) and the fc1 of ``fc1_res: u`` ([12800,
  768] and [19712, 768] -> 3072), device ms per call over 20 calls replayed
  from one CUDA graph;
- ``dln_bwd``: ``dense_ln_bwd`` (#9) at its four main-path shapes (image and
  text rows, qkv and fc1), the same way;
- ``k2_bwd``: K2's backward as the checkout runs it
  (``fc1_act._DenseActLn.backward`` on the saved tensors of
  ``dense_act_ln_res``: fc1's input, LayerNorm and weight gradients, exact
  GELU, u and e saved) at the fc1 of the ``distill_l14`` student ([100864,
  1024] -> 4096) and of the two ``lclip_b32`` students ([25600, 768] and
  [39424, 768] -> 3072); where the checkout's #9 has its activation mode
  (``dense_ln_bwd.act_launches`` exists), also #9 alone in it (e saved, and
  recomputed as under ``fc1_res: u``), the composition it replaced
  (``_act_du``, then #9 on du), the plain version (events over 3 eager
  calls) and the bound (bytes of x, γ, β, W, dh, u, e and the statistics
  read, dx, xn, du, dγ, dβ written, over 3.35 TB/s; 2·rows·C·N FLOPs over
  989 TFLOP/s), device ms per call as ``k1``;
- ``k2``: lean ``dense_act_ln`` (K2, as the teachers and serving run it) and
  ``dense_act_ln_res`` (#8, as a train step runs it) at the fc1 of the image
  and text students (exact GELU) and of the image and text teachers
  (QuickGELU): [12800, 768] and [19712, 768] -> 3072, [12800, 768] -> 3072,
  [19712, 512] -> 2048; beside each the PyTorch composition that does the
  same work (``hw_oracle.ln_gemm_act``: ``native_layer_norm``, ``addmm``,
  the activation; #8's also e), the same way;
- ``tf_fwd``: lean ``transform_attention_rows_qkv`` (K3, as serving runs it)
  and ``transform_attention_save_p`` (#5, as a train step runs it) at the two
  students' shapes (B=256; 24 heads of 32 at 50 tokens, 12 of 64 at 77) and
  at the widest heads the tensor-core pair takes (B=256, 32 heads of 32 at
  197 tokens, the stage-1 ViT-L/14 student's; B=64, 12 of 128 at 256), beside the PyTorch composition that does the same work
  (``hw_oracle.tf_composition``: bf16 ``matmul``, ``einsum`` mixes,
  ``softmax``, ``matmul``), device ms per call over 20 calls replayed from one
  CUDA graph, three rounds in turn: the median and the rounds;
- ``flash_tf``: ``flash_transform_attention_fwd`` (#17, as the tapped stage-1
  steps run it: q, k, v the views of a fused qkv, no mask) at the two
  students' shapes and at ``tf_fwd``'s two widest, beside the PyTorch
  composition of the same work (``hw_oracle.flash_tf_composition``), the same
  way; at the widest two also its CUDA-core route
  ``flash_transform_attention_fwd_wide`` (17w) and the bound (the larger of
  q, k, v and O's bytes over 3.35 TB/s and the products' and mixes' FLOPs
  over 989 TFLOP/s);
- ``tf_bwd``: ``transform_attention_bwd`` (#6) at ``tf_fwd``'s four shapes,
  beside the PyTorch composition of the same work
  (``hw_oracle.tf_bwd_composition``), the same way;
- ``reduce_partials``: device ms per call of the kernels named
  ``reduce_partials`` (the fixed-order sums of per-block partials) in
  ``dense_ln_bwd`` (#9) at its four main-path shapes and in #6 at both
  shapes, from ``torch.profiler`` over 20 eager calls;
- ``k4 host``: µs per eager ``layer_norm_rows`` call at [256, 768] (the
  serving call's final norms), host clock over 2000 calls, five times;
- ``serving``: ms per ``score_tokens`` call of the final students at batch
  256, device-resident, host clock (the numpy readback fences), five rounds
  of five calls;
- ``step``: ms per train step at 256 pairs of the text-cached stage-3 step
  (the main path) and of the same step under ``fc1_ln: "0"`` (which runs
  neither K1 nor #9), built by the checkout's own ``chip_smoke.py``
  (``make_task``, its seeded teacher and stage checkpoints under
  ROOT/build/chip_smoke/), host clock fenced by the loss readback, three
  rounds of five steps after three warm-up steps.

Compare two checkouts only within one run: the card's power limit and the
host's load move every number between runs.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _graph_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(torch, fn, key: str, iters: int = 20) -> float:
    """Device ms per call of the kernels whose name holds ``key``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if key in ev.key and not str(getattr(ev, "device_type", "")).endswith("CPU"):
            us += getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
    return us / 1e3 / iters


def _own_yardsticks():
    """The kernel oracle beside this script (``distillclip_tpu_torch/tools/
    hw_oracle.py``, not the checkout's), for the PyTorch compositions that
    every checkout is timed against."""
    import importlib.util

    path = Path(__file__).resolve().parent / "distillclip_tpu_torch" / "tools" / "hw_oracle.py"
    spec = importlib.util.spec_from_file_location("hw_oracle_of_chip_ab", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module       # for its dataclasses
    spec.loader.exec_module(module)
    return module


SECTIONS = ("build", "k1", "dln_bwd", "k2_bwd", "k2", "tf_fwd", "flash_tf", "tf_bwd",
            "reduce_partials", "k4", "serving", "step")


def _rounds(torch, fns, rounds: int = 3) -> list[str]:
    """Each of ``fns`` timed by _graph_ms ``rounds`` times, in turn: per
    function "median [round, round, ...]"."""
    times = [[_graph_ms(torch, fn) for fn in fns] for _ in range(rounds)]
    return [f"{statistics.median(r[i] for r in times):.4f} "
            f"[{' '.join(f'{r[i]:.4f}' for r in times)}]" for i in range(len(fns))]


def one(root: Path, only: tuple[str, ...] = SECTIONS) -> None:
    """The measurements of one checkout, in this process: the sections in
    ``only``."""
    sys.path.insert(0, str(root))
    import importlib

    import torch

    from distillclip_tpu_torch.ops import fc1_act, layer_norm
    from distillclip_tpu_torch.ops import transform_attention as ta
    from distillclip_tpu_torch.serving import LCLIPScorer

    own = _own_yardsticks()
    ln_gemm_act, tf_composition = own.ln_gemm_act, own.tf_composition
    # ops.flash_attention is the public function; this is its module
    fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    card, tag = _card(), f"ab {root.resolve().name}"
    rng = np.random.default_rng(0)
    if "build" in only:
        build_times(root, tag, card)

    def t(shape, std=1.0, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
        return torch.from_numpy(a).cuda().to(torch.bfloat16)

    k1, dlb = [], []
    for rows, c, n in () if {"k1", "dln_bwd"}.isdisjoint(only) else ((12800, 768, 2304), (19712, 768, 2304), (19712, 512, 1536),
                       (12800, 768, 3072), (19712, 768, 3072)):
        x, g, b, w, bias = t((rows, c)), t((c,), 0.1, 1.0), t((c,), 0.1), t((c, n), 0.02), \
            t((n,), 0.02)
        fn = lambda: fc1_act.dense_ln_fwd(x, g, b, w, bias, stats=True)
        k1.append(f"[{rows},{c}]->{n} {_graph_ms(torch, fn):.4f}")
        if c == 768:
            du = t((rows, n))
            _, mean, rstd = fn()
            fn = lambda: fc1_act.dense_ln_bwd(x, g, b, w, du, mean, rstd)
            dlb.append(f"[{rows},{n}]->{c} {_graph_ms(torch, fn):.4f}")
    if "k1" in only:
        print(f"{tag} k1 ms: {'; '.join(k1)} [{card}]", flush=True)
    if "dln_bwd" in only:
        print(f"{tag} dln_bwd ms: {'; '.join(dlb)} [{card}]", flush=True)

    if "k2_bwd" in only:
        k2_bwd(torch, fc1_act, t, own, tag, card)

    k2 = []
    for rows, c, act in () if "k2" not in only else ((12800, 768, "gelu_exact"), (19712, 768, "gelu_exact"),
                         (12800, 768, "quick_gelu"), (19712, 512, "quick_gelu")):
        n = 4 * c
        args = (t((rows, c)), t((c,), 0.1, 1.0), t((c,), 0.1), t((c, n), 0.02), t((n,), 0.02))
        times = [_graph_ms(torch, fn) for fn in (
            lambda: fc1_act.dense_act_ln(*args, act),
            lambda: fc1_act.dense_act_ln_res(*args, act),
            lambda: ln_gemm_act(*args, act),
            lambda: ln_gemm_act(*args, act, res=True))]
        k2.append(f"[{rows},{c}]->{n} {act} K2 {times[0]:.4f} #8 {times[1]:.4f} "
                  f"(compositions {times[2]:.4f}, {times[3]:.4f})")
    if k2:
        print(f"{tag} k2 ms: {'; '.join(k2)} [{card}]", flush=True)

    tff = []
    tf_shapes = ((256, 24, 32, 50), (256, 12, 64, 77), (256, 32, 32, 197), (64, 12, 128, 256))
    for B, H, d, N in () if "tf_fwd" not in only else tf_shapes:
        qkv, wl, ww = t((B * N, 3 * H * d)), t((H, H), H ** -0.5), t((H, H), H ** -0.5)
        kw = dict(heads=H, seq=N, scale=d ** -0.5)
        with torch.inference_mode():
            times = _rounds(torch, (
                lambda: ta.transform_attention_rows_qkv(qkv, wl, ww, **kw),
                lambda: ta.transform_attention_save_p(qkv, wl, ww, **kw),
                lambda: tf_composition(qkv, wl, ww, **kw)))
        tff.append(f"H={H} d={d} N={N} K3 {times[0]} #5 {times[1]} (composition {times[2]})")
    if tff:
        print(f"{tag} tf_fwd ms: {'; '.join(tff)} [{card}]", flush=True)

    ftf = []
    for B, H, d, N in () if "flash_tf" not in only else tf_shapes:
        qkv = torch.cat([t((B, N, 2, H, d)), t((B, N, 1, H, d), 0.7)], dim=2)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
        kw = dict(scale=d ** -0.5)
        fns = [lambda: fa.flash_transform_attention_fwd(q, k, v, wl, ww, **kw),
               lambda: own.flash_tf_composition(q, k, v, wl, ww, **kw)]
        wide = N > 77
        if wide:
            fns.append(lambda: fa.flash_transform_attention_fwd_wide(q, k, v, wl, ww, **kw))
        with torch.inference_mode():
            times = _rounds(torch, fns)
        bound = max(2 * (4 * B * N * H * d + 2 * H * H) / own.HBM_BYTES_PER_S,
                    4.0 * B * H * N * N * (d + H) / own.TENSOR_FLOPS) * 1e3
        ftf.append(f"B={B} H={H} d={d} N={N} #17 {times[0]} (composition {times[1]}"
                   + (f"; 17w {times[2]}; bound {bound:.4f}" if wide else "") + ")")
    if ftf:
        print(f"{tag} flash_tf ms: {'; '.join(ftf)} [{card}]", flush=True)

    tf, red = [], []
    for B, H, d, N in () if {"tf_bwd", "reduce_partials"}.isdisjoint(only) else tf_shapes:
        if "tf_bwd" not in only and N > 77:
            continue                    # reduce_partials: the students' shapes
        qkv, do = t((B * N, 3 * H * d)), t((B * N, H * d))
        wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
        kw = dict(heads=H, seq=N, scale=d ** -0.5)
        p = ta.transform_attention_save_p(qkv, wl, ww, **kw)[1]
        fn = lambda: ta.transform_attention_bwd(qkv, wl, ww, do, p, **kw)
        if "tf_bwd" in only:
            times = _rounds(torch, (
                fn, lambda: own.tf_bwd_composition(qkv, wl, ww, do, p, **kw)))
            tf.append(f"H={H} d={d} N={N} #6 {times[0]} (composition {times[1]})")
        if "reduce_partials" in only and N <= 77:
            red.append(f"#6 H={H} {_kernel_ms(torch, fn, 'reduce_partials'):.4f}")
    if "tf_bwd" in only:
        print(f"{tag} tf_bwd ms: {'; '.join(tf)} [{card}]", flush=True)

    for rows in () if "reduce_partials" not in only else (12800, 19712):
        for n in (2304, 3072):
            x, du = t((rows, 768)), t((rows, n))
            g, b, w = t((768,), 0.1, 1.0), t((768,), 0.1), t((768, n), 0.02)
            _, mean, rstd = fc1_act.dense_ln_stats_plain(x, g, b, w, None)
            fn = lambda: fc1_act.dense_ln_bwd(x, g, b, w, du, mean, rstd)
            red.append(f"#9 [{rows},{n}] {_kernel_ms(torch, fn, 'reduce_partials'):.4f}")
    if "reduce_partials" in only:
        print(f"{tag} reduce_partials ms: {'; '.join(red)} [{card}]", flush=True)
    if "k4" in only:
        k4_host(torch, layer_norm, t, tag, card)
    if "serving" in only:
        serving(torch, LCLIPScorer, root, rng, tag, card)
    if "step" in only:
        steps(root, tag, card)


def _event_ms(torch, fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_bwd(torch, fc1_act, t, own, tag: str, card: str) -> None:
    """The ``k2_bwd`` lines (see the module's docstring)."""
    from types import SimpleNamespace

    fused = hasattr(fc1_act.dense_ln_bwd, "act_launches")
    for rows, c in ((100864, 1024), (25600, 768), (39424, 768)):
        n, act = 4 * c, "gelu_exact"
        x, g, b, w, bias = t((rows, c)), t((c,), 0.1, 1.0), t((c,), 0.1), t((c, n), c ** -0.5), \
            t((n,), 0.02)
        _, u, e, mean, rstd = fc1_act.dense_act_ln_res(x, g, b, w, bias, act)
        dh = t((rows, n), 0.01)
        ctx = SimpleNamespace(saved_tensors=(x, g, b, w, u, e, mean, rstd), act=act)
        ms = _graph_ms(torch, lambda: fc1_act._DenseActLn.backward(ctx, dh))
        line = f"[{rows},{c}]->{n} K2 backward {ms:.4f}"
        if fused:
            def composition():
                du = fc1_act._act_du(dh, u, e, act)
                return fc1_act.dense_ln_bwd(x, g, b, w, du, mean, rstd)

            kernel, kernel_u, comp = (_graph_ms(torch, fn) for fn in (
                lambda: fc1_act.dense_ln_bwd(x, g, b, w, dh, mean, rstd, act, u, e),
                lambda: fc1_act.dense_ln_bwd(x, g, b, w, dh, mean, rstd, act, u, None),
                composition))
            plain = _event_ms(torch, lambda: fc1_act.dense_ln_bwd_plain(
                x.float(), g.float(), b.float(), w.float(), dh, mean, rstd, act, u, e))
            nbytes = 2 * (rows * c + 2 * c + c * n + 3 * rows * n) + 8 * rows \
                + 2 * (2 * rows * c + rows * n) + 8 * c
            bound = max(nbytes / own.HBM_BYTES_PER_S, 2.0 * rows * c * n / own.TENSOR_FLOPS) * 1e3
            line += (f"; #9 activation mode {kernel:.4f} (e recomputed {kernel_u:.4f}); "
                     f"composition (_act_du, #9) {comp:.4f}; plain {plain:.4f}; bound "
                     f"{bound:.4f} ({2.0 * rows * c * n / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        print(f"{tag} k2_bwd ms: {line} [{card}]", flush=True)
        del x, w, u, e, dh, ctx
        torch.cuda.empty_cache()


def build_times(root: Path, tag: str, card: str) -> None:
    """The ``build`` line: the checkout's sources through nvcc, one process
    each and all at once, into a scratch directory removed after."""
    import shutil
    import tempfile

    from distillclip_tpu_torch.ops import _build

    (root / "build").mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="ab_build_", dir=root / "build"))
    t0, done = time.perf_counter(), {}
    procs = {src.name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-c", "-o",
         str(out / f"{src.stem}.o"), str(src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for src in _build._sources()}
    while len(done) < len(procs):
        for name, proc in procs.items():
            if name not in done and proc.poll() is not None:
                done[name] = time.perf_counter() - t0
                if proc.returncode:
                    sys.exit(f"{tag} build: nvcc failed for {name}")
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    slowest = sorted(done.items(), key=lambda kv: -kv[1])[:4]
    print(f"{tag} build s: wall {wall:.1f} ({len(done)} sources at once); slowest "
          + ", ".join(f"{name} {sec:.1f}" for name, sec in slowest) + f" [{card}]", flush=True)


def k4_host(torch, layer_norm, t, tag: str, card: str) -> None:
    x, g, b = t((256, 768)), t((768,), 0.1, 1.0), t((768,), 0.1)
    with torch.inference_mode():
        host = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                layer_norm.layer_norm_rows(x, g, b)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) / 2000 * 1e6)
    host = host[1:]
    print(f"{tag} k4 host us/call [256,768]: {' '.join(f'{u:.2f}' for u in host)} median "
          f"{statistics.median(host):.2f} [{card}]", flush=True)


def serving(torch, LCLIPScorer, root: Path, rng, tag: str, card: str) -> None:
    scorer = LCLIPScorer.from_config(str(root / "configs" / "final" / "l_clip.yaml"),
                                     device="cuda", seed=0)
    images = torch.from_numpy(rng.integers(0, 256, size=(256, 224, 224, 3), dtype=np.uint8))
    tokens = np.zeros((256, 77), np.int64)
    tokens[:, 0], tokens[:, 1:20], tokens[:, 20] = 49406, rng.integers(1, 49406, (256, 19)), 49407
    images, tokens = images.cuda(), torch.from_numpy(tokens).cuda()
    for _ in range(2):
        scorer.score_tokens(images, tokens)
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(5):
            scorer.score_tokens(images, tokens)
        rounds.append((time.perf_counter() - t0) / 5 * 1e3)
    print(f"{tag} serving 256 device-resident ms/call: {' '.join(f'{m:.3f}' for m in rounds)} "
          f"median {statistics.median(rounds):.3f} [{card}]", flush=True)


def steps(root: Path, tag: str, card: str) -> None:
    import chip_smoke as cs     # the checkout's own, first on the path

    for label, section in (("text-cached", {}), ('text-cached fc1_ln "0"', {"fc1_ln": "0"})):
        with cs.perf_section(section):
            task = cs.make_task("bfloat16")
            state, tx = task.init_state(cs.SEED, steps_per_epoch=1, device="cuda")
            step = task.make_train_step(tx, cached_text_teacher=True)
            batch = cs.train_batch(np.random.default_rng(cs.SEED + 11), 256, "cuda", 1)
            for _ in range(3):
                state, metrics = step(state, *batch)
            float(metrics["loss"])
            rounds = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(5):
                    state, metrics = step(state, *batch)
                float(metrics["loss"])
                rounds.append((time.perf_counter() - t0) / 5 * 1e3)
        print(f"{tag} step {label} 256 pairs ms/step: {' '.join(f'{m:.3f}' for m in rounds)} "
              f"median {statistics.median(rounds):.3f} [{card}]", flush=True)
        del task, state, tx, step, batch


def main() -> None:
    args = sys.argv[1:]
    only = SECTIONS
    if args[:1] == ["--only"] and len(args) > 1:
        only = tuple(args[1].split(","))
        if unknown := set(only) - set(SECTIONS):
            sys.exit(f"unknown sections {sorted(unknown)}; the sections: {', '.join(SECTIONS)}")
        args = args[2:]
    if args[:1] == ["--one"]:
        one(Path(args[1]), only)
        return
    if not args:
        sys.exit(__doc__)
    rc = 0
    for root in args + args[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--only", ",".join(only), "--one", root],
                              text=True, capture_output=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(f"ab {root}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            rc = 1
    sys.exit(rc)


if __name__ == "__main__":
    main()
