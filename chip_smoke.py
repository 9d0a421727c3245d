#!/usr/bin/env python3
"""Smoke run of the PyTorch port (distillclip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; it fails with no card.  The
phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi);
2. build the four kernels from distillclip_tpu_torch/csrc with nvcc into
   build/torch_kernels/;
3. kernel oracles: each kernel on bf16 inputs at the serving shapes against
   its plain PyTorch version in fp32 on the same values (TF32 off);
4. the serving slice: both students of configs/final/l_clip.yaml at full
   width with seeded random weights, 256 uint8 images scored against 256
   token rows through LCLIPScorer.score_tokens; scores finite and in [-1, 1],
   the first 16 within 2e-2 of the plain path (same weights, fp32, CPU),
   every kernel launched by that run, and the streamed path equal to the
   serial calls;
5. card numbers: each kernel's time beside its plain version's, and fenced
   scored pairs/s at batch 256 and 1024.

The last two lines before the final one are the card line and a JSON object
of the kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "final" / "l_clip.yaml"
SEED = 0
SOT, EOT = 49406, 49407  # CLIP's start / end of text ids

# Oracle limits (max abs, and mean abs where given) against fp32.  K3: the
# bf16 class the TPU kernels met in their hardware oracle.
LIMITS = {
    "dense_ln": (1e-2, 1e-3),
    "dense_act_ln": (1e-2, 1e-3),
    "transform_attention_rows_qkv": (8e-3, None),
    "layer_norm_rows": (1e-2, None),
}
SOURCES = {
    "dense_ln": ("distillclip_tpu_torch/csrc/dense_ln.cu",
                 "distillclip_tpu/ops/fc1_act.py:419"),
    "dense_act_ln": ("distillclip_tpu_torch/csrc/dense_ln.cu",
                     "distillclip_tpu/ops/fc1_act.py:521"),
    "transform_attention_rows_qkv": ("distillclip_tpu_torch/csrc/transform_attention.cu",
                                     "distillclip_tpu/ops/transform_attention.py:118"),
    "layer_norm_rows": ("distillclip_tpu_torch/csrc/layer_norm.cu",
                        "distillclip_tpu/ops/layer_norm.py:50"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16(rng: np.random.Generator, shape, std: float = 1.0, mean: float = 0.0,
         device: str = "cuda"):
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
    return torch.from_numpy(a).to(device).to(torch.bfloat16)


# -- phase 3 ----------------------------------------------------------------

def oracle_cases(rng, device: str = "cuda"):
    """(kernel, label, kernel call, plain fp32 call, plain call on the kernel's
    own bf16 inputs for timing) at the shapes the serving path gives each.

    Every output is bf16, which rounds |y| in [2, 4) by up to 0.0078 and
    |y| >= 4 by up to 0.0156, so an absolute limit of 1e-2 or 8e-3 only holds
    while the outputs stay under 4; the inputs below keep them there."""
    from distillclip_tpu_torch.ops import fc1_act, layer_norm, transform_attention as ta

    t = lambda shape, std=1.0, mean=0.0: bf16(rng, shape, std, mean, device)
    f32 = lambda ts: [None if x is None else x.float() for x in ts]
    cases = []
    C = 768
    # K1/K2: LN output of std ~1 times W of std 0.02 over C = 768 gives
    # outputs of std ~0.55 (largest ~3.2 over 30M values).
    for label, rows, n, bias in (("image qkv", 256 * 50, 3 * C, True),
                                 ("text qkv", 256 * 77, 3 * C, False)):
        args = [t((rows, C)), t((C,), 0.1, 1.0), t((C,), 0.1),
                t((C, n), 0.02), t((n,), 0.02) if bias else None]
        cases.append(("dense_ln", f"{label} [{rows},{C}]->{n}",
                      lambda a=args: fc1_act.dense_ln(*a),
                      lambda a=args: fc1_act.dense_ln_plain(*f32(a)),
                      lambda a=args: fc1_act.dense_ln_plain(*a)))
    rows = 256 * 50
    args = [t((rows, C)), t((C,), 0.1, 1.0), t((C,), 0.1),
            t((C, 4 * C), 0.02), t((4 * C,), 0.02)]
    cases.append(("dense_act_ln", f"image fc1 [{rows},{C}]->{4 * C} gelu_exact",
                  lambda a=args: fc1_act.dense_act_ln(*a, "gelu_exact"),
                  lambda a=args: fc1_act.dense_ln_plain(*f32(a), act="gelu_exact"),
                  lambda a=args: fc1_act.dense_ln_plain(*a, act="gelu_exact")))
    # K3: the head mixes are drawn at std H^-1/2, so the mixed logits have
    # std ~1 and the softmax is far from uniform; at the towers' init std
    # (0.02) it is nearly uniform and the check would be weak.
    for label, B, H, d, N in (("image", 256, 24, 32, 50), ("text", 256, 12, 64, 77),
                              ("ragged", 64, 4, 16, 17)):
        qkv = t((B * N, 3 * H * d))
        wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
        kw = dict(heads=H, seq=N, scale=d ** -0.5)
        cases.append(("transform_attention_rows_qkv", f"{label} B={B} H={H} d={d} N={N}",
                      lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv(q, l, w, **k),
                      lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv_plain(
                          q.float(), l.float(), w.float(), **k),
                      lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv_plain(
                          q, l, w, **k)))
    # K4: rows uniform on [-sqrt(3), sqrt(3)] (unit variance), so the
    # normalised values stay within sqrt(3) and |y| within ~2.2; unit
    # Gaussian rows put ~50 of the 786k outputs past 4.
    x = rng.uniform(-3 ** 0.5, 3 ** 0.5, size=(1024, C)).astype(np.float32)
    args = [torch.from_numpy(x).to(device).to(torch.bfloat16), t((C,), 0.1, 1.0),
            t((C,), 0.1)]
    cases.append(("layer_norm_rows", f"[1024,{C}]",
                  lambda a=args: layer_norm.layer_norm_rows(*a),
                  lambda a=args: layer_norm.layer_norm_rows_plain(*f32(a)),
                  lambda a=args: layer_norm.layer_norm_rows_plain(*a)))
    return cases


def kernel_oracles(card: str) -> dict:
    """Phases 3 and 5a: per kernel, the worst error over its shapes and the
    kernel/plain times at its first (main-path) shape."""
    results = {}
    with torch.inference_mode():
        for name, label, kern, plain, plain_bf16 in oracle_cases(np.random.default_rng(SEED)):
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            diff = (out.float() - ref.float()).abs()
            max_err, mean_err = diff.max().item(), diff.mean().item()
            if not (torch.isfinite(out.float()).all() and torch.isfinite(ref).all()):
                fail(f"{name} {label}: non-finite output")
            lim_max, lim_mean = LIMITS[name]
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain_bf16)
            print(f"oracle {name} {label}: max_abs_err {max_err:.3e} (limit {lim_max:g}) "
                  f"mean_abs_err {mean_err:.3e}"
                  + (f" (limit {lim_mean:g})" if lim_mean else "")
                  + f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
            if max_err > lim_max or (lim_mean is not None and mean_err > lim_mean):
                fail(f"{name} {label} disagrees with its plain version")
            r = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms})
            r["max_abs_err"] = max(r["max_abs_err"], max_err)
    return results


# -- phase 4 ----------------------------------------------------------------

def make_tokens(rng: np.random.Generator, n: int, ctx: int = 77) -> np.ndarray:
    """SOT, random ids, EOT at varied lengths, then zeros."""
    toks = np.zeros((n, ctx), np.int64)
    lengths = rng.integers(3, ctx + 1, size=n)
    for i, L in enumerate(lengths):
        toks[i, 0] = SOT
        toks[i, 1:L - 1] = rng.integers(1, SOT, size=L - 2)
        toks[i, L - 1] = EOT
    return toks


def serving_slice(ops, LCLIPScorer):
    rng = np.random.default_rng(SEED)
    scorer = LCLIPScorer.from_config(str(CONFIG), device="cuda", seed=SEED)
    images = rng.integers(0, 256, size=(256, 224, 224, 3), dtype=np.uint8)
    tokens = make_tokens(rng, 256)

    ops.reset_launch_counts()
    scores = scorer.score_tokens(images, tokens)
    counts = ops.launch_counts()
    print(f"slice: launches in the main-path run {counts}", flush=True)
    if missing := [k for k, v in counts.items() if v == 0]:
        fail(f"kernels not launched by the main path: {missing}")
    if scores.shape != (256,) or not np.isfinite(scores).all():
        fail(f"scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if np.abs(scores).max() > 1.0 + 1e-5:
        fail(f"scores outside [-1, 1]: max |s| = {np.abs(scores).max()}")

    cpu_state = lambda m: {k: v.float().cpu() for k, v in m.state_dict().items()}
    plain = LCLIPScorer.from_config(str(CONFIG), cpu_state(scorer.image_tower),
                                    cpu_state(scorer.text_tower), device="cpu",
                                    dtype=torch.float32)
    ref = plain.score_tokens(images[:16], tokens[:16])
    err = float(np.abs(scores[:16] - ref).max())
    print(f"slice: scores[:16] vs plain fp32 CPU path max_abs_err {err:.3e} (limit 2e-2); "
          f"score range [{scores.min():.4f}, {scores.max():.4f}]", flush=True)
    if err > 2e-2:
        fail("kernel-path scores disagree with the plain path")
    # Random towers score near 0, so also hold the unit features themselves
    # to the plain path: the cosine of each kernel-path row with its plain row.
    for name, enc, x in (("image", "encode_images", images[:16]),
                         ("text", "encode_tokens", tokens[:16])):
        cos = (getattr(scorer, enc)(x) * getattr(plain, enc)(x)).sum(axis=1)
        print(f"slice: {name} features vs plain fp32 CPU path min row cosine "
              f"{cos.min():.6f} (limit 0.999)", flush=True)
        if cos.min() < 0.999:
            fail(f"kernel-path {name} features disagree with the plain path")

    batches = [(images[i:i + 64], tokens[i:i + 64]) for i in range(0, 256, 64)]
    streamed = list(scorer.score_tokens_stream(batches, depth=2))
    serial = [scorer.score_tokens(*b) for b in batches]
    sdiff = max(float(np.abs(a - b).max()) for a, b in zip(streamed, serial))
    print(f"slice: score_tokens_stream over 4 batches vs serial max diff {sdiff:.3e} "
          f"(limit 1e-6)", flush=True)
    if len(streamed) != 4 or sdiff > 1e-6:
        fail("streamed scores differ from the serial calls")
    return scorer, counts


# -- phase 5b ---------------------------------------------------------------

def throughput(scorer, card: str) -> None:
    rng = np.random.default_rng(SEED + 1)
    for batch in (256, 1024):
        images = rng.integers(0, 256, size=(batch, 224, 224, 3), dtype=np.uint8)
        tokens = make_tokens(rng, batch)
        d_images, d_tokens = torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda()
        for label, args in (("host uint8 in", (images, tokens)),
                            ("device-resident", (d_images, d_tokens))):
            scorer.score_tokens(*args)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                scorer.score_tokens(*args)  # returns numpy: the readback fences
            dt = (time.perf_counter() - t0) / iters
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"throughput score_tokens batch {batch} ({label}): {batch / dt:.1f} pairs/s, "
                  f"{dt * 1e3:.2f} ms/call, peak device memory {peak:.2f} GiB [{card}]",
                  flush=True)
        del d_images, d_tokens
    batches = [(rng.integers(0, 256, size=(256, 224, 224, 3), dtype=np.uint8),
                make_tokens(rng, 256)) for _ in range(8)]
    list(scorer.score_tokens_stream(batches[:2]))  # warm-up
    t0 = time.perf_counter()
    n = sum(len(s) for s in scorer.score_tokens_stream(batches, depth=2))
    dt = time.perf_counter() - t0
    print(f"throughput score_tokens_stream 8 x 256 (host uint8 in, depth 2): "
          f"{n / dt:.1f} pairs/s [{card}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from distillclip_tpu_torch import ops
    from distillclip_tpu_torch.ops import _build
    from distillclip_tpu_torch.serving import LCLIPScorer

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.1f} s "
          f"(log: {_build.BUILD_DIR / 'build.log'})", flush=True)

    results = kernel_oracles(card)
    scorer, counts = serving_slice(ops, LCLIPScorer)
    throughput(scorer, card)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": counts[name],
                "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]} for name in ops.KERNELS]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
