#!/usr/bin/env python3
"""Smoke run of the PyTorch port (distillclip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # the check, then torch.profiler tables

Needs one CUDA card (Hopper, sm_90a) and nvcc; it fails with no card.  The
phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from distillclip_tpu_torch/csrc with nvcc (one process
   per source, all at once) into build/torch_kernels/, and print the
   registers and spill bytes (nvcc -Xptxas -v, in the build log) of each
   instance of PTXAS_KERNELS, and how many of #9's thread-block clusters (one
   block per 256 columns of C) the card holds at once at C = 768;
3. kernel oracles: each kernel on bf16 inputs at the shapes the serving call,
   the teacher and the train steps give it, and on a ragged small shape,
   against its plain PyTorch version in fp32 on the same values (TF32 off).
   The modes that also write statistics, residuals or probabilities must give
   the same bits as the lean mode for the shared output, and every masked
   entry of the plain attention's saved probabilities must be 0;
4. the serving slice: both students of configs/final/l_clip.yaml at full
   width with seeded random weights, 256 uint8 images scored against 256
   token rows through LCLIPScorer.score_tokens; scores finite and in [-1, 1],
   the first 16 within 2e-2 of the plain path (same weights, fp32, CPU),
   every serving kernel launched by that run, and the streamed path equal to
   the serial calls;
5. the train slice: DualDistillTask.make_train_step(cached_teachers=True) on
   the same students (full width, full depth, seeded weights, seeded uint8
   images, tokens and teacher representations).  (a) 16 pairs: loss, parts and
   every parameter's gradient on the kernel path against the plain fp32 CPU
   path on the same masters; (b) 256 pairs: steps on one fixed batch, every
   loss finite, the last lower than the first, parameters changed, and the
   launch counts of one step as expected; (c) ms/step, pairs/s and peak
   device memory at 256 pairs;
5b. the teacher: a seeded ViT-B/32-architecture CLIP checkpoint (vision 768 x
   12 layers x 12 heads, text 512 x 12 x 8, out 512) written by the port's
   fabricator and loaded through teacher_load; both encode functions on 256
   pairs, the first 16 against the plain fp32 CPU path, launches as expected;
5c. the train steps that run it, phased like 5, on students warm-started as
   the config's load_path asks (stage checkpoints that the run writes from
   seeded towers; the masters must equal them): the stage-3 step with the text
   teacher cached and the image teacher live (the main path), the live step,
   a step that trains through plain attention (use_transform=False students,
   both teachers cached), and the stage-1 DistillTask step of
   configs/final/image.yaml with its live image teacher;
5d. the tap-reading steps, each phased like 5 ((a) 16 pairs against the plain
   fp32 CPU path, (b) steps on one batch with the launch table met, (c)
   ms/step): stage 1 of configs/final/image.yaml with hidden_rep_mse,
   embedding_mse and vit_kd over six teacher layers (the towers collect hidden
   states, so attention runs on [B, H, N, d] views: the head-transform forward
   in the student, the plain forward in the teacher), the same with a
   use_transform=False student (plain forward and backward), the same student
   with the attention-score and -probability losses (materialised fp32 taps,
   no attention kernel), the value-map tap of both tower families against the
   plain fp32 CPU towers, stage 3 live with the contrastive losses, and a
   short stochastic phase (dropout and drop-path: seeded runs repeat);
5d'. the modules off the main path, each phased like 5: stage 1 of
   configs/final/image.yaml with iRPE on q, k and v (product buckets,
   contextual, a table per head; every table seeded non-zero), whose student
   attention is materialised; a seeded teacher of RN50's geometry (the
   ModifiedResNet image tower): its image encode of 256 rows in bf16 against
   the plain fp32 CPU encode of the first 16 (unit rows within 2e-2, cosines
   at least the plain bf16 CPU encode's less 1e-3), rows/s and peak memory,
   and the teacher scorer's score_tokens at
   256 pairs (pairs/s, the text tower's launches); stage 1 with that teacher
   live (out_dim 1024, no embedding copy, out_l1 + out_cos);
5d''. past 256 tokens and at the widest heads, in bf16, nothing cut:
   seeded checkpoints of ViT-L/14, ViT-L/14@336px and ViT-B/16's published
   geometries (tools/fabricate_teacher.py --preset); each image encode of 256
   rows (257, 577 and 197 tokens: the first two materialise the attention, as
   the JAX towers take XLA's past 256 tokens) with its launches, the first 16
   rows against the plain fp32 CPU encode (cosine >= 0.999) and a
   `throughput teacher` line; LCLIPScorer.from_teacher on the ViT-L/14
   checkpoint, score_tokens at 256 pairs (16 against the plain fp32 CPU
   scorer, 2e-2); stage 1 of configs/final/image.yaml against the live
   ViT-L/14 (teacher layers [0, 1, 22, 23]) with a student 1024 wide of 32
   heads of 32, patch 16 (197 tokens, freeze_embed off: the patch geometry
   differs), out_dim 768, 256 pairs: #5 and #6 on the tensor cores (the
   widened pair), six launches each a step, their CUDA-core route none; then
   the same student at patch 14 (257 tokens, its
   attention materialised, freeze_embed on), 64 pairs; the 1024-wide student
   (out_dim 512) tapped by vit_kd against the live ViT-B/16 (197 tokens, six
   teacher layers), 256 pairs: #17 at 32 heads of 32, six launches a step,
   its CUDA-core route none, #16's forward in the teacher; each step phased
   like 5 ((a) 16 pairs against the plain fp32 CPU path, (b), (c));
5e. the perf knobs (config.perf): under fc1_ln "0", fc1_ln "0" with fc1_res u,
   fc1_res u, and tf_impl factored, the serving call and the text-cached step
   of 5c, rebuilt under the knob: 16 pairs against the plain fp32 CPU path
   built under the same knob, then 256 pairs with the launch table the knob
   gives (the no-LN GEMM #12 in serving, #10 or #11 in the step, K4 and #7 for
   every norm; factored: the default step's launches and its losses bit for
   bit);
5f. the score entry point: cli.main(["score", ...]) on 256 image files and
   captions, with the teacher checkpoint and with port-format checkpoints of
   the seeded students; one JSON line per pair, finite scores in [-1, 1],
   equal to score_tokens on the same decoded and tokenised rows, and the
   pairs/s of file scoring beside score_tokens (the host's decode and
   tokenise cost);
5g. the trainer through the CLI: cli.main fit on configs/bench_fit_lclip.yaml
   (the final students at full width, 256 pairs, uint8 images, the text
   teacher's representations cached) with an overlay under build/ (the seeded
   teacher, 1024 pairs, two epochs, validation on two batches every epoch, a
   log line every step): finite train and validation losses and retrieval
   accuracies, the teacher's baseline at epoch 0 only, checkpoints/last and
   index.json, the first logged loss equal (1e-3 relative) to the bare
   cached-text step's on the same first batch and seeded masters, one train
   and one eval step's launches as the tables say (the eval step's all lean)
   and the fit's launches their sum; then fit --ckpt last for a third epoch,
   validate --ckpt last and lr_find (16 steps, a suggestion); the warm
   epoch's items/s and input stall beside the bare text-cached step's
   pairs/s (the `fit` line);
5h. the final configs' own data (``data_phases``): a corpus in their layouts
   written from a seed by tools/fabricate_images.py (1024 combined and 1024
   COCO train2017 JPEGs, 256 val2017, 4096 CC3M captions) under build/; each
   config's prepare through MainDataModule.prepare_data on the card (per
   cache: rows, seconds, rows/s, launches = chunks x one encode's, the first
   16 rows against the plain fp32 CPU encode: unit rows within 2e-2, cosine
   >= 0.999); cli.main fit on configs/final/{l_clip,image,text}.yaml with an
   overlay of the corpus paths, the seeded teacher, the stage checkpoints as
   load_path and the cuts (256 items a step, 2 epochs of 4 steps, validation
   on 2 batches of 128): the first logged loss against the bare step on the
   trainer's first batch and seeded masters (1e-3 relative), finite
   validation metrics, one train and one eval step's launches as the tables
   say, the warm epoch's items/s and input stall beside the bare step's
   pairs/s; then tools/dryrun.py over NCCL on min(2, device_count) ranks (4
   text-cached steps of l_clip.yaml, 256 pairs a rank): every rank the same
   losses, masters bitwise equal, and at world size 1 the single process's
   loss exactly or within 1e-6 relative;
5i. the tools (distillclip_tpu_torch/tools) on the card: hw_oracle on the row
   LayerNorm's cases (rc 0), hw_trajectory at its defaults (50 steps against
   the CPU and its perturbed shadow: the verdict), the roofline floors of the
   joint and text stages beside the text-cached step and fit text.yaml's bare
   step, trace_summary of the traced l_clip fit, input_bench on phase 5h's
   corpus (1 and 4 loader threads, 256 items) and cached_teacher_ab --epochs 1;
6. card numbers: each kernel's time beside its plain version's, its bound
   and, where one PyTorch call computes the same function, that call's time
   (for K2, #8, K3, #5 and #6 on either route, which no one call matches, the
   PyTorch composition that does their work)
   (kernel and library call: device time of calls replayed from a CUDA graph,
   so that a wrapper's host cost does not enter it; a library call through
   autograd, SDPA's backward, which a graph cannot capture: the device time of
   its kernels from torch.profiler); fenced scored pairs/s at
   batch 256 and 1024.

The last two lines before the final one are the card line and a JSON object
of the kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# the oracle table and the timing helpers live in the port's kernel oracle
# (python -m distillclip_tpu_torch.tools.hw_oracle), so that the two agree;
# chip_ab.py reads the PyTorch compositions from there too
from distillclip_tpu_torch.tools.hw_oracle import (
    Disagreement,
    bf16,
    cuda_ms,
    device_events,
    kernel_oracles,
    library_device_times,
)
from distillclip_tpu_torch.tools.trace_summary import PROFILE_GROUPS, REST, family_of, trace_split

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "final" / "l_clip.yaml"
IMAGE_CONFIG = ROOT / "configs" / "final" / "image.yaml"
SEED = 0
PAIRS = 256     # pairs per serving call and per train step
DEVICE = "cuda"
SOT, EOT = 49406, 49407  # CLIP's start / end of text ids


def add_counts(*parts: dict) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


# kernel -> (source, the TPU kernel it replaces; None for EVA-02's modes, of
# which the JAX package has no tower and no kernel)
SOURCES = {
    "dense_ln": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu",
                 "distillclip_tpu/ops/fc1_act.py:419"),
    "dense_act_ln": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu",
                     "distillclip_tpu/ops/fc1_act.py:521"),
    "transform_attention_rows_qkv": ("distillclip_tpu_torch/csrc/transform_attention_mma.cu",
                                     "distillclip_tpu/ops/transform_attention.py:118"),
    "transform_attention_rows_qkv_wide": ("distillclip_tpu_torch/csrc/transform_attention.cu",
                                          "distillclip_tpu/ops/transform_attention.py:118"),
    "layer_norm_rows": ("distillclip_tpu_torch/csrc/layer_norm.cu",
                        "distillclip_tpu/ops/layer_norm.py:50"),
    "transform_attention_save_p": ("distillclip_tpu_torch/csrc/transform_attention_mma.cu",
                                   "distillclip_tpu/ops/transform_attention.py:467"),
    "transform_attention_bwd": ("distillclip_tpu_torch/csrc/transform_attention_bwd.cu",
                                "distillclip_tpu/ops/transform_attention.py:224"),
    "transform_attention_save_p_wide": ("distillclip_tpu_torch/csrc/transform_attention.cu",
                                        "distillclip_tpu/ops/transform_attention.py:467"),
    "transform_attention_bwd_wide": ("distillclip_tpu_torch/csrc/transform_attention_bwd_wide.cu",
                                     "distillclip_tpu/ops/transform_attention.py:224"),
    "layer_norm_rows_bwd": ("distillclip_tpu_torch/csrc/layer_norm.cu",
                            "distillclip_tpu/ops/layer_norm.py:63"),
    "dense_act_ln_res": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu",
                         "distillclip_tpu/ops/fc1_act.py:307"),
    "dense_ln_bwd": ("distillclip_tpu_torch/csrc/dense_ln_bwd.cu",
                     "distillclip_tpu/ops/fc1_act.py:571"),
    "plain_attention_rows_qkv": ("distillclip_tpu_torch/csrc/plain_attention.cu",
                                 "distillclip_tpu/ops/blockdiag_attention.py:107"),
    "plain_attention_save_p": ("distillclip_tpu_torch/csrc/plain_attention.cu",
                               "distillclip_tpu/ops/blockdiag_attention.py:198"),
    "plain_attention_bwd": ("distillclip_tpu_torch/csrc/plain_attention_bwd.cu",
                            "distillclip_tpu/ops/blockdiag_attention.py:144"),
    "flash_attention_fwd": ("distillclip_tpu_torch/csrc/flash_attention.cu",
                            "distillclip_tpu/ops/flash_attention.py:131"),
    "flash_attention_bwd": ("distillclip_tpu_torch/csrc/flash_attention_bwd.cu",
                            "distillclip_tpu/ops/flash_attention.py:150"),
    "flash_transform_attention_fwd": (
        "distillclip_tpu_torch/csrc/flash_transform_attention_mma.cu",
        "distillclip_tpu/ops/flash_attention.py:632"),
    "flash_transform_attention_fwd_wide": (
        "distillclip_tpu_torch/csrc/flash_transform_attention.cu",
        "distillclip_tpu/ops/flash_attention.py:632"),
    "dense_act": ("distillclip_tpu_torch/csrc/dense_act.cu",
                  "distillclip_tpu/ops/fc1_act.py:207"),
    "dense_act_res": ("distillclip_tpu_torch/csrc/dense_act.cu",
                      "distillclip_tpu/ops/fc1_act.py:71"),
    "dense_act_u": ("distillclip_tpu_torch/csrc/dense_act.cu",
                    "distillclip_tpu/ops/fc1_act.py:131"),
    "dense_ln_rope": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu", None),
    "dense_swiglu_ln": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu", None),
    "dense_ln_width": ("distillclip_tpu_torch/csrc/dense_ln_wgmma.cu", None),
    "plain_attention_long": ("distillclip_tpu_torch/csrc/plain_attention_long.cu", None),
}
# the head-by-head formulation (tf_impl: factored) is served by K3 / #5 / #6
FACTORED = ("tf_factored_qkv", "distillclip_tpu/ops/transform_factored.py:392",
            ("transform_attention_rows_qkv", "transform_attention_save_p",
             "transform_attention_bwd"))
SERVING_KERNELS = ("dense_ln", "dense_act_ln", "transform_attention_rows_qkv",
                   "layer_norm_rows")
# one serving call: 10 logical layers of K1, K2 and K3, the two final norms
SERVING_LAUNCHES = {"dense_ln": 10, "dense_act_ln": 10, "transform_attention_rows_qkv": 10,
                    "layer_norm_rows": 2}
# K3's, #5 / #6's and #17's second routes, the CUDA-core kernels, serve head
# shapes past the tensor-core kernels' (past 32 heads of 32 and 16 of 128 for
# all four), which no published CLIP geometry has and no path here runs (the
# 32-head students train on the tensor-core #5 and #6, and run #17 when a loss
# taps their hidden states): their oracle cases hold them against their plain
# versions
OFF_MAIN_PATH = ("transform_attention_rows_qkv_wide", "transform_attention_save_p_wide",
                 "transform_attention_bwd_wide", "flash_transform_attention_fwd_wide")
# launches of one train step: 10 logical layers (6 image + 4 text), two LN
# GEMMs and so two backward GEMMs each, and the two towers' final norm
TRAIN_STEP_LAUNCHES = {
    "dense_ln": 10, "dense_act_ln_res": 10, "transform_attention_save_p": 10,
    "transform_attention_bwd": 10, "dense_ln_bwd": 20, "layer_norm_rows": 2,
    "layer_norm_rows_bwd": 2,
}
# one teacher tower under no_grad: 12 layers of lean K1, lean K2 and plain
# attention, and its row LayerNorms (ln_pre + ln_post; ln_final)
TEACHER_LAYERS = 12
IMAGE_TEACHER_LAUNCHES = {"dense_ln": 12, "dense_act_ln": 12, "plain_attention_rows_qkv": 12,
                          "layer_norm_rows": 2}
TEXT_TEACHER_LAUNCHES = {"dense_ln": 12, "dense_act_ln": 12, "plain_attention_rows_qkv": 12,
                         "layer_norm_rows": 1}
# the students without head mixes: plain attention with saved P, and its backward
PLAIN_STEP_LAUNCHES = {
    "dense_ln": 10, "dense_act_ln_res": 10, "plain_attention_save_p": 10,
    "plain_attention_bwd": 10, "dense_ln_bwd": 20, "layer_norm_rows": 2,
    "layer_norm_rows_bwd": 2,
}
# stage 1: the image student alone (6 logical layers, one final norm)
IMAGE_STEP_LAUNCHES = {
    "dense_ln": 6, "dense_act_ln_res": 6, "transform_attention_save_p": 6,
    "transform_attention_bwd": 6, "dense_ln_bwd": 12, "layer_norm_rows": 1,
    "layer_norm_rows_bwd": 1,
}

# stage 1 with hidden states collected (need_rep): the student's attention is
# the head-transform forward on [B, H, N, d] views (its gradient is a plain
# recompute, no kernel), the teacher's the plain forward with the logsumexp
TAPPED_IMAGE_STEP_LAUNCHES = {
    "dense_ln": 6, "dense_act_ln_res": 6, "flash_transform_attention_fwd": 6,
    "dense_ln_bwd": 12, "layer_norm_rows": 1, "layer_norm_rows_bwd": 1,
}
TAPPED_IMAGE_TEACHER_LAUNCHES = {"dense_ln": 12, "dense_act_ln": 12,
                                 "flash_attention_fwd": 12, "layer_norm_rows": 2}
# the same with a student without head mixes: plain forward and backward
TAPPED_PLAIN_IMAGE_STEP_LAUNCHES = {
    "dense_ln": 6, "dense_act_ln_res": 6, "flash_attention_fwd": 6, "flash_attention_bwd": 6,
    "dense_ln_bwd": 12, "layer_norm_rows": 1, "layer_norm_rows_bwd": 1,
}
# attention taps (scores, probabilities, value map) and attention dropout
# materialise the attention in plain PyTorch: no attention kernel in either tower
MATERIALISED_IMAGE_STEP_LAUNCHES = {
    "dense_ln": 6, "dense_act_ln_res": 6, "dense_ln_bwd": 12, "layer_norm_rows": 1,
    "layer_norm_rows_bwd": 1,
}
MATERIALISED_IMAGE_TEACHER_LAUNCHES = {"dense_ln": 12, "dense_act_ln": 12, "layer_norm_rows": 2}
# six of the teacher's twelve layers, for the six repeats the student returns
SIX_TEACHER_LAYERS = [0, 1, 2, 9, 10, 11]

# fc1_ln "0": every norm of the 10 logical layers is K4 (#7 under a gradient)
# beside the two final norms, qkv a plain product, fc1 the no-LN GEMM: #12
# without a gradient, #10 (#11 under fc1_res u) with one; the image teacher's
# 12 layers run two K4 each beside ln_pre and ln_post, and #13
UNFUSED_SERVING_LAUNCHES = {"layer_norm_rows": 22, "dense_act": 10,
                            "transform_attention_rows_qkv": 10}
UNFUSED_STEP_LAUNCHES = {"layer_norm_rows": 22, "layer_norm_rows_bwd": 22, "dense_act_res": 10,
                         "transform_attention_save_p": 10, "transform_attention_bwd": 10}
UNFUSED_U_STEP_LAUNCHES = {**{k: v for k, v in UNFUSED_STEP_LAUNCHES.items()
                              if k != "dense_act_res"}, "dense_act_u": 10}
UNFUSED_IMAGE_TEACHER_LAUNCHES = {"layer_norm_rows": 26, "plain_attention_rows_qkv": 12}
# fc1_res u with the LayerNorm fused: fc1 under a gradient is K1 with its statistics
U_STEP_LAUNCHES = {"dense_ln": 20, "transform_attention_save_p": 10,
                   "transform_attention_bwd": 10, "dense_ln_bwd": 20, "layer_norm_rows": 2,
                   "layer_norm_rows_bwd": 2}
# knob set -> (its perf section, serving launches, text-cached step launches)
KNOB_PHASES = {
    "fc1_ln=0": ({"fc1_ln": "0"}, UNFUSED_SERVING_LAUNCHES,
                 add_counts(UNFUSED_STEP_LAUNCHES, UNFUSED_IMAGE_TEACHER_LAUNCHES)),
    "fc1_ln=0 fc1_res=u": ({"fc1_ln": "0", "fc1_res": "u"}, UNFUSED_SERVING_LAUNCHES,
                           add_counts(UNFUSED_U_STEP_LAUNCHES, UNFUSED_IMAGE_TEACHER_LAUNCHES)),
    "fc1_res=u": ({"fc1_res": "u"}, SERVING_LAUNCHES,
                  add_counts(U_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES)),
    "tf_impl=factored": ({"tf_impl": "factored"}, SERVING_LAUNCHES,
                         add_counts(TRAIN_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES)),
}


# kernels whose registers and spills (nvcc -Xptxas -v, in the build log) the
# run prints: the LN GEMM (its statistics launch, and its product in every
# instance: K1 <0, 0>, K2 <1|2, 0>, #8 <1|2, 1>; EVA-02's three modes and
# their statistics launch), #9 and the no-LN GEMM on the
# wgmma main loop, K4, #17 and K3 / #5 on the tensor cores
# (flash_tf_fwd_mma_kernel<KS, HPW, NH, ND, PIX>, tf_fwd_mma_kernel<KS, HPW,
# NH, ND, PIX>: one tile loop) and the CUDA-core routes of K3 (its save-P mode #5's)
# and #17, #6's row, dq/dk and column kernels and its CUDA-core route's two,
# and the partials' reduction that #6 and #9 share.  An
# entry function takes the first name it holds (flash_tf_fwd_mma_kernel holds
# tf_fwd_mma_kernel).
PTXAS_KERNELS = ("dense_ln_wgmma_kernel", "ln_stats_w16_kernel", "dense_ln_rope_wgmma_kernel",
                 "dense_swiglu_ln_wgmma_kernel", "dense_ln_width_wgmma_kernel",
                 "ln_stats_width_w16_kernel", "dense_ln_bwd_wgmma_kernel",
                 "dense_act_wgmma_kernel", "layer_norm_rows_kernel", "flash_tf_fwd_mma_kernel",
                 "tf_fwd_mma_kernel", "transform_attention_kernel",
                 "flash_transform_attention_fwd_kernel", "tf_bwd_rows_kernel",
                 "tf_bwd_qk_kernel", "tf_bwd_cols_kernel", "tf_bwd_wide_q_kernel",
                 "tf_bwd_wide_kv_kernel", "reduce_partials_kernel",
                 "plain_attention_long_kernel")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_lines(log: Path) -> None:
    """One line per instance of PTXAS_KERNELS from the build log: registers a
    thread and spill bytes (ptxas prints the entry function, its spill line,
    then its register count)."""
    import re

    name, spills = None, ""
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spills = None, ""
            for kernel in PTXAS_KERNELS:
                if (k := re.search(kernel + r"(I(?:L[a-z]\d+E)+E)?", m.group(1))):
                    args = re.findall(r"L[a-z](\d+)E", k.group(1) or "")
                    name = kernel + (f"<{', '.join(args)}>" if args else "")
                    break
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            print(f"ptxas {name}: {m.group(1)} registers; {spills}", flush=True)
            name = None


def cluster_line(lib, card: str) -> None:
    """#9's cluster at the students' width, in its du mode and its activation
    mode: its blocks (one per 256 columns of C) and how many such clusters
    the card holds at once."""
    C = 768
    blocks = -(-C // 256)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for act, mode in ((0, "du"), (1, "activation")):
        n = lib.dc_dense_ln_bwd_max_clusters(C, act)
        print(f"cluster dense_ln_bwd ({mode} mode) C={C}: {blocks} blocks a cluster, at most "
              f"{n} clusters at once ({max(n, 0) * blocks} of {sms} SMs) [{card}]", flush=True)
        if n < 1:
            fail(f"dense_ln_bwd: no cluster of {blocks} blocks fits the card ({n})")


def scale_lines(card: str) -> None:
    """PyTorch compositions and library attention at the main-path shapes,
    for scale only: none of them computes the same function as a kernel (no
    head mixes in the attention; separate passes in the GEMMs)."""
    rng = np.random.default_rng(SEED + 2)
    t = lambda shape, std=1.0, mean=0.0: bf16(rng, shape, std, mean)
    C = 768
    with torch.no_grad():
        for label, rows, n in (("image qkv", PAIRS * 50, 3 * C), ("image fc1", PAIRS * 50, 4 * C),
                               ("text qkv", PAIRS * 77, 3 * C), ("text fc1", PAIRS * 77, 4 * C)):
            x, g, b, w, bias, du = (t((rows, C)), t((C,), 0.1, 1.0), t((C,), 0.1),
                                    t((C, n), 0.02), t((n,), 0.02), t((rows, n)))
            fwd = lambda: F.layer_norm(x, (C,), g, b, 1e-5) @ w + bias
            print(f"scale (not the same function) {label}: F.layer_norm + matmul + bias "
                  f"{cuda_ms(fwd):.4f} ms, + F.gelu {cuda_ms(lambda: F.gelu(fwd())):.4f} ms, "
                  f"backward du @ W^T + native_layer_norm_backward "
                  f"{cuda_ms(lambda: _ln_gemm_bwd(x, g, b, w, du)):.4f} ms [{card}]", flush=True)
            if "fc1" in label:      # the no-LN GEMM's nearest composition
                lin = lambda: F.gelu(F.linear(x, w.t(), bias))
                print(f"scale (two calls, not one) {label}: F.linear + F.gelu "
                      f"{cuda_ms(lin):.4f} ms [{card}]", flush=True)
    for label, B, H, d, N in (("image", PAIRS, 24, 32, 50), ("text", PAIRS, 12, 64, 77)):
        q, k, v, do = (t((B, H, N, d)).requires_grad_() for _ in range(4))
        with torch.no_grad():
            f_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        o = F.scaled_dot_product_attention(q, k, v)
        b_ms = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
        print(f"scale (not the same function: no head mixes) {label} B={B} H={H} d={d} N={N}: "
              f"F.scaled_dot_product_attention forward {f_ms:.4f} ms, backward {b_ms:.4f} ms "
              f"[{card}]", flush=True)


def _ln_gemm_bwd(x, g, b, w, du):
    C = x.shape[1]
    _, mean, rstd = torch.native_layer_norm(x, (C,), g, b, 1e-5)
    return torch.ops.aten.native_layer_norm_backward(du @ w.t(), x, [C], mean, rstd, g, b,
                                                     [True, True, True])


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


def make_images(rng: np.random.Generator, n: int, size: int = 224) -> np.ndarray:
    return rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def serving_slice(ops, LCLIPScorer):
    rng = np.random.default_rng(SEED)
    scorer = LCLIPScorer.from_config(str(CONFIG), device=DEVICE, seed=SEED)
    images = make_images(rng, PAIRS, scorer.image_tower.img_size)
    tokens = make_tokens(rng, PAIRS, scorer.text_tower.context_length)

    ops.reset_launch_counts()
    scores = scorer.score_tokens(images, tokens)
    counts = ops.launch_counts()
    print(f"slice: launches in the main-path run {counts}", flush=True)
    if missing := [k for k in SERVING_KERNELS if counts[k] == 0]:
        fail(f"kernels not launched by the serving path: {missing}")
    if scores.shape != (PAIRS,) or not np.isfinite(scores).all():
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

    batches = [(images[i:i + PAIRS // 4], tokens[i:i + PAIRS // 4])
               for i in range(0, PAIRS, PAIRS // 4)]
    streamed = list(scorer.score_tokens_stream(batches, depth=2))
    serial = [scorer.score_tokens(*b) for b in batches]
    sdiff = max(float(np.abs(a - b).max()) for a, b in zip(streamed, serial))
    print(f"slice: score_tokens_stream over 4 batches vs serial max diff {sdiff:.3e} "
          f"(limit 1e-6)", flush=True)
    if len(streamed) != 4 or sdiff > 1e-6:
        fail("streamed scores differ from the serial calls")
    return scorer, counts


# -- phases 5, 5b, 5c ---------------------------------------------------------

def teacher_checkpoint() -> str:
    """A seeded CLIP checkpoint of ViT-B/32's architecture (no pretrained
    weights are in the repository), written once under build/."""
    from distillclip_tpu_torch.tools.fabricate_teacher import preset_state_dict

    path = ROOT / "build" / "chip_smoke" / f"clip_vit_b32_arch_seed{SEED}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(preset_state_dict("ViT-B/32", seed=SEED, vision_layers=TEACHER_LAYERS,
                                     text_layers=TEACHER_LAYERS), str(path))
    return str(path)


def _config_args(path: Path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)["model"]["init_args"]


def stage_checkpoints() -> dict:
    """The config's ``load_path``: stage-1 and stage-2 checkpoints of the
    students of configs/final/l_clip.yaml in the port's format, written once
    under build/ from seeded towers (seeds SEED + 1 and SEED + 2, so that the
    warm start differs from the task's own seeded init)."""
    from distillclip_tpu_torch.serving.lclip_score import build_tower, seeded_init
    from distillclip_tpu_torch.training.checkpoints import nest, save_pytree

    args, paths = _config_args(CONFIG), {}
    for i, key in enumerate(("image", "text")):
        path = ROOT / "build" / "chip_smoke" / f"l_clip_{key}_stage_seed{SEED + 1 + i}.pt"
        if not path.exists():
            tower = seeded_init(build_tower(args[f"{key}_student"]),
                                np.random.default_rng(SEED + 1 + i))
            save_pytree(str(path), {"params": {"student": nest(tower.state_dict())}})
        paths[key] = str(path)
    return paths


def make_task(compute_dtype: str, use_transform: bool = True, losses: Optional[dict] = None):
    """The stage-3 task on the students of configs/final/l_clip.yaml, with the
    config's losses (or ``losses``), optimizer settings and ``load_path``, the
    latter pointed at :func:`stage_checkpoints`, and the seeded teacher.
    ``use_transform=False`` takes the head mixes out of both students, which
    then train through plain attention; those towers have no stage
    checkpoints (their parameters differ), so they start from the seeded
    init."""
    from distillclip_tpu_torch.serving.lclip_score import build_tower
    from distillclip_tpu_torch.training import DualDistillTask

    args = _config_args(CONFIG)
    for key in ("image_student", "text_student"):
        args[key]["init_args"]["use_transform"] = use_transform
    return DualDistillTask(
        image_student=build_tower(args["image_student"]),
        text_student=build_tower(args["text_student"]),
        loss_control_para=losses or args["loss_control_para"], warm_steps=args["warm_steps"],
        total_steps=args["total_steps"], weight_decay=args["weight_decay"], lr=args["lr"],
        load_path=stage_checkpoints() if use_transform else None,
        teacher_name=teacher_checkpoint(), compute_dtype=compute_dtype)


def check_warm_start(task) -> None:
    """The masters of a task built with ``load_path`` are its stage
    checkpoints' towers, not the seeded init."""
    from distillclip_tpu_torch.training.checkpoints import flatten, restore_pytree

    params = task.init_params(SEED, "cpu")
    for key in ("image", "text"):
        saved = flatten(restore_pytree(task.load_path[key])["params"]["student"])
        saved = {f"student.{key}_tower.{k}": v for k, v in saved.items()}
        tower = {k: v for k, v in params.items() if k.startswith(f"student.{key}_tower.")}
        if set(saved) != set(tower) or not all(torch.equal(tower[k], v.float())
                                               for k, v in saved.items()):
            fail(f"load_path: the {key} tower's masters are not its stage checkpoint's")
    names = {k: Path(v).name for k, v in task.load_path.items()}
    print(f"train: load_path {names}: both towers' masters equal the stage checkpoints' "
          f"({sum(v.numel() for v in params.values()) / 1e6:.2f} M)", flush=True)


def make_image_task(compute_dtype: str, losses: Optional[dict] = None,
                    need_layers: Optional[list] = None, lr: Optional[float] = None,
                    teacher: Optional[str] = None, task_over: Optional[dict] = None,
                    **student_over):
    """The stage-1 task of configs/final/image.yaml (weight-share image
    student, out_l1 + out_cos, freeze_embed, the live image teacher), or the
    same with other losses, teacher layers, learning rate, teacher checkpoint,
    task arguments (``task_over``, the config's names) or student arguments."""
    from distillclip_tpu_torch.serving.lclip_score import build_tower
    from distillclip_tpu_torch.training import DistillTask

    args = {**_config_args(IMAGE_CONFIG), **(task_over or {})}
    args["student_encoder"]["init_args"].update(student_over)
    return DistillTask(
        student=build_tower(args["student_encoder"]),
        loss_control_para=losses or args["loss_control_para"],
        freeze_embed=args["freeze_embed"],
        teacher_need_layers=need_layers or args["teacher_need_layers"],
        model_type=args["model_type"],
        warm_steps=args["warm_steps"], total_steps=args["total_steps"],
        weight_decay=args["weight_decay"], lr=lr or args["lr"], norm=args["norm"],
        teacher_name=teacher or teacher_checkpoint(), compute_dtype=compute_dtype)


def train_batch(rng: np.random.Generator, n: int, device: str, reps: int = 2):
    """tokens, uint8 images and ``reps`` cached teacher representations (the
    text teacher's, then the image teacher's; fp32 ``[n, 512]``)."""
    arrays = [make_tokens(rng, n), make_images(rng, n)]
    arrays += [rng.standard_normal((n, 512), dtype=np.float32) for _ in range(2)]
    return [torch.from_numpy(a).to(device) for a in arrays[:2 + reps]]


# step -> (the task's loss function, make_train_step's keywords, cached
# representations in the batch)
DUAL_STEPS = {
    "all-cached": ("loss_fn_cached_all", {"cached_teachers": True}, 2),
    "text-cached": ("loss_fn_cached_text", {"cached_text_teacher": True}, 1),
    "live": ("loss_fn", {}, 0),
}


def _loss_and_grads(loss_fn, params, batch, left_out: Optional[dict] = None):
    """``left_out`` maps a loss name to its weight in the total: the gradients
    are those of the total without these shares."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss, (parts, _, _) = loss_fn(leaves, *batch)
    target = loss - sum(w * parts[name] for name, w in (left_out or {}).items())
    grads = torch.autograd.grad(target, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def compare_with_plain(label: str, task, plain, loss_name: str, params, small,
                       selecting: tuple = (), noise_floor: float = 0.0,
                       relative_loss: bool = False) -> None:
    """(a) 16 pairs: loss, parts and every leaf's gradient on the kernel path
    against the plain fp32 CPU path on the same masters.  ``selecting`` names
    losses that pick by comparison (a max over tokens, a mined index): a pick
    can flip between bf16 and fp32 and the gradient with it, so their values
    are compared like every part's, and the gradients are those of the total
    without their shares.  A leaf whose plain-path gradient is below
    ``noise_floor`` times the global norm is at float-noise level, where a
    cosine compares noise: its gradient's distance from the plain one must be
    below that bound instead, and the line lists it.  ``relative_loss`` holds
    a loss or part past 1 to 2e-2 of its size (a teacher whose
    representations are O(100) makes the losses O(10))."""
    left_out = {name: task.loss_control.percent[name] for name in selecting}
    if left_out:
        print(f"train {label} (a): gradients compared without the shares of {selecting}, "
              f"which select by comparison", flush=True)
    loss, parts, grads = _loss_and_grads(getattr(task, loss_name), params,
                                         [t.to(DEVICE) for t in small], left_out)
    torch.cuda.synchronize()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    ref_loss, ref_parts, ref_grads = _loss_and_grads(getattr(plain, loss_name), cpu_params,
                                                     small, left_out)
    # the error over the limit's unit: 1, or the value's size under relative_loss
    unit = (lambda ref: max(1.0, abs(float(ref)))) if relative_loss else (lambda ref: 1.0)
    err = abs(float(loss) - float(ref_loss)) / unit(ref_loss)
    part_err = max(abs(float(parts[k]) - float(ref_parts[k])) / unit(ref_parts[k])
                   for k in parts)
    kind = "relative to max(1, |value|)" if relative_loss else "abs"
    print(f"train {label} (a) 16 pairs: loss {float(loss):.6f} vs plain fp32 CPU "
          f"{float(ref_loss):.6f} ({kind} err {err:.3e}, parts max err {part_err:.3e}, limit "
          f"2e-2)", flush=True)
    if not np.isfinite(float(loss)) or err > 2e-2 or part_err > 2e-2:
        fail(f"{label}: train loss disagrees with the plain path")
    gn = float(torch.sqrt(sum(g.float().square().sum() for g in grads.values())))
    ref_gn = float(torch.sqrt(sum(g.square().sum() for g in ref_grads.values())))
    worst_name, worst_cos, noise = None, 1.0, {}
    for k, g in grads.items():
        g, r = g.float().cpu().flatten(), ref_grads[k].flatten()
        if not torch.isfinite(g).all():
            fail(f"{label}: train gradient of {k} is not finite")
        if float(r.norm()) == 0.0 and float(g.norm()) == 0.0:
            continue
        if float(r.norm()) < noise_floor * ref_gn:
            noise[k] = (float(g.norm()), float(r.norm()), float((g - r).norm()))
            continue
        cos = float(torch.dot(g, r) / (g.norm() * r.norm()).clamp_min(1e-30))
        if cos < worst_cos:
            worst_name, worst_cos = k, cos
    print(f"train {label} (a) gradients: global norm {gn:.6f} vs {ref_gn:.6f} (limit 5%), "
          f"lowest per-parameter cosine {worst_cos:.6f} at {worst_name} (limit 0.99)",
          flush=True)
    if noise:
        print(f"train {label} (a) gradients at float-noise level (plain norm below "
              f"{noise_floor:g} of the global norm; kernel-path norm, plain norm, distance): "
              + "; ".join(f"{k} {a:.3e} {b:.3e} {d:.3e}" for k, (a, b, d) in noise.items())
              + f" (distance limit {noise_floor * ref_gn:.3e})", flush=True)
    if abs(gn - ref_gn) > 0.05 * ref_gn or worst_cos < 0.99 or \
            any(d > noise_floor * ref_gn for _, _, d in noise.values()):
        fail(f"{label}: train gradients disagree with the plain path")


def run_steps(ops, card: str, label: str, step, state, batch, expected: dict, steps: int,
              keep_state: bool, frozen=()) -> dict:
    """(b) ``steps`` steps on one fixed batch: losses finite and falling,
    every trainable leaf moved, the launches of one step as expected; then (c)
    ms/step, pairs/s and peak memory over 10 more steps, fenced by the loss
    readback."""
    before = {k: v.clone() for k, v in state.params.items()}
    first = state.step
    pairs = int(batch[0].shape[0])
    losses, counts = [], None
    for _ in range(steps):
        ops.reset_launch_counts()
        state, metrics = step(state, *batch)
        if counts is None:
            counts = ops.launch_counts()
        losses.append(float(metrics["loss"]))
    print(f"train {label} (b) {pairs} pairs: launches of one step {counts}", flush=True)
    print(f"train {label} (b) losses " + " ".join(f"{x:.6f}" for x in losses), flush=True)
    if counts != {**dict.fromkeys(ops.KERNELS, 0), **expected}:
        fail(f"{label}: launch counts of one train step differ from {expected}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{label}: train losses are not finite or did not fall")
    still = sorted(k for k, v in state.params.items() if torch.equal(before[k], v))
    finite = all(bool(torch.isfinite(v).all()) for v in state.params.values())
    print(f"train {label} (b) {len(before) - len(still)} of {len(before)} parameter leaves "
          f"changed ({len(frozen)} frozen); all finite: {finite}; "
          f"parts {({k: round(float(v), 6) for k, v in metrics.items()})}", flush=True)
    if still != sorted(frozen) or not finite or state.step != first + steps:
        fail(f"{label}: the train step left trainable parameters unchanged, moved frozen "
             f"ones or made them not finite: {still}")
    del before

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what is allocated when the timing starts: this step's state and batch,
    # and what earlier phases keep (their steps' tasks and teacher copies)
    resident = torch.cuda.memory_allocated() / 2 ** 30
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, *batch)
    float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"throughput train step {label} {pairs} pairs (device-resident): {dt * 1e3:.2f} "
          f"ms/step, {pairs / dt:.1f} pairs/s, peak device memory {peak:.2f} GiB "
          f"({resident:.2f} GiB allocated when the timing starts) [{card}]", flush=True)
    # the state (0.9 GB of masters and moments) only outlives the phase where
    # the caller profiles it, so that a later phase's peak memory is its own
    return {"counts": counts, "state": state if keep_state else None, "step": step,
            "batch": batch, "losses": losses, "ms": dt * 1e3}


def dual_phase(ops, card: str, label: str, kind: str, task, plain, expected: dict, steps: int,
               seed: int, keep_state: bool, selecting: tuple = ()) -> dict:
    """One stage-3 step, ``kind`` of ``DUAL_STEPS``, on ``task``: (a) against
    ``plain`` where one is given, then (b) and (c)."""
    loss_name, step_kw, reps = DUAL_STEPS[kind]
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    print(f"train {label}: {len(state.params)} parameter leaves, "
          f"{sum(v.numel() for v in state.params.values()) / 1e6:.2f} M fp32 masters", flush=True)
    if plain is not None:
        small = train_batch(np.random.default_rng(seed), 16, "cpu", reps)
        compare_with_plain(label, task, plain, loss_name, state.params, small, selecting)
    batch = train_batch(np.random.default_rng(seed + 1), PAIRS, DEVICE, reps)
    return run_steps(ops, card, label, task.make_train_step(tx, **step_kw), state, batch,
                     expected, steps, keep_state)


def teacher_phase(ops, card: str, task, plain) -> dict:
    """Phase 5b: both teacher encode functions at full width and depth on 256
    pairs; the first 16 rows against the plain fp32 CPU path on the same
    weights; launches as expected."""
    from distillclip_tpu_torch.models.clip import cosine_logits

    rng = np.random.default_rng(SEED + 5)
    images, tokens = make_images(rng, PAIRS), make_tokens(rng, PAIRS)
    t0 = time.perf_counter()
    enc_image, enc_text = task.make_teacher_image_encode(DEVICE), \
        task.make_teacher_text_encode(DEVICE)
    print(f"teacher: ViT-B/32 architecture, seeded weights, "
          f"{sum(p.numel() for p in task.teacher.module.parameters()) / 1e6:.2f} M parameters, "
          f"loaded and cast in {time.perf_counter() - t0:.1f} s", flush=True)
    counts, reps = {}, {}
    for name, enc, x, want in (("image", enc_image, images, IMAGE_TEACHER_LAUNCHES),
                               ("text", enc_text, tokens, TEXT_TEACHER_LAUNCHES)):
        ops.reset_launch_counts()
        rep = enc(x)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        print(f"teacher: launches of one {name} encode {counts[name]}", flush=True)
        if counts[name] != {**dict.fromkeys(ops.KERNELS, 0), **want}:
            fail(f"launch counts of the {name} teacher differ from {want}")
        if rep.shape != (PAIRS, 512) or rep.dtype != torch.float32 \
                or not torch.isfinite(rep).all():
            fail(f"{name} teacher representations: shape {tuple(rep.shape)}, {rep.dtype}")
        reps[name] = rep
        ms = cuda_ms(lambda: enc(x), iters=5, warmup=1)
        print(f"throughput teacher {name} encode {PAIRS} rows: {ms:.2f} ms, "
              f"{PAIRS / ms * 1e3:.1f} rows/s [{card}]", flush=True)
    ref = {"image": plain.make_teacher_image_encode("cpu")(images[:16]),
           "text": plain.make_teacher_text_encode("cpu")(tokens[:16])}
    for name in ("image", "text"):
        got = reps[name][:16].cpu()
        cos = torch.nn.functional.cosine_similarity(got, ref[name], dim=1)
        print(f"teacher: {name} representations[:16] vs plain fp32 CPU path min row cosine "
              f"{float(cos.min()):.6f} (limit 0.999)", flush=True)
        if float(cos.min()) < 0.999:
            fail(f"kernel-path {name} teacher representations disagree with the plain path")
    err = float((cosine_logits(reps["image"][:16].cpu(), reps["text"][:16].cpu())
                 - cosine_logits(ref["image"], ref["text"])).abs().max())
    print(f"teacher: logits[:16, :16] vs plain fp32 CPU path max_abs_err {err:.3e} "
          f"(limit 2e-2)", flush=True)
    if err > 2e-2:
        fail("kernel-path teacher logits disagree with the plain path")
    return counts


def image_stage_phase(ops, card: str) -> dict:
    """The stage-1 step of configs/final/image.yaml, image teacher live."""
    task = make_image_task("bfloat16")
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    frozen = [k for k, m in (task._mask or {}).items() if not m]
    print(f"train stage-1: {len(state.params)} parameter leaves, frozen by freeze_embed: "
          f"{frozen}", flush=True)
    tea = task.teacher.state("visual")
    if len(frozen) != 3 or not torch.equal(state.params["student.patch_kernel"].cpu(),
                                           tea["patch_kernel"]):
        fail("freeze_embed did not copy and freeze the teacher's embeddings")
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 8), PAIRS)).to(DEVICE)]
    return run_steps(ops, card, "stage-1", task.make_train_step(tx), state, batch,
                     add_counts(IMAGE_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES), 8, False, frozen)


# -- phase 5d: the tap-reading steps ---------------------------------------------

@contextlib.contextmanager
def seeded_vit_kd_masks(seed: int):
    """vit_kd draws its token mask on the device it runs on, and the card's
    generator gives other numbers than the CPU's.  Where the two paths are
    compared, the mask is drawn on the CPU from one seed and moved."""
    from distillclip_tpu_torch.losses import vit_kd

    original = vit_kd.random_masking

    def same(x, ratio, generator=None):
        mask = original(torch.empty(x.shape, dtype=x.dtype), ratio,
                        torch.Generator().manual_seed(seed))
        return mask.to(x.device)

    vit_kd.random_masking = same
    try:
        yield
    finally:
        vit_kd.random_masking = original


# configs/final/image.yaml's lr of 5e-3 is tuned for out_l1 + out_cos: with
# the per-layer losses added, eight steps on one repeated batch fall to 0.63
# and then blow up to 1.97 at it, so the tap phases step at 1e-3
TAPPED_LR = 1e-3
# stage 1 over six teacher layers: label -> (losses, student arguments, launches)
VIT_KD_PARA = {"student_dims": 768, "teacher_dims": 768}      # 49 = 7 x 7 patch tokens
TAPPED_IMAGE_PHASES = {
    "stage-1 tapped": (
        {"loss_name": ["out_l1", "out_cos", "hidden_rep_mse", "embedding_mse", "vit_kd"],
         "vit_kd_para": VIT_KD_PARA}, {},
        add_counts(TAPPED_IMAGE_STEP_LAUNCHES, TAPPED_IMAGE_TEACHER_LAUNCHES)),
    "stage-1 tapped plain-attention": (
        {"loss_name": ["out_l1", "out_cos", "hidden_rep_mse", "embedding_mse", "vit_kd"],
         "vit_kd_para": VIT_KD_PARA}, {"use_transform": False},
        add_counts(TAPPED_PLAIN_IMAGE_STEP_LAUNCHES, TAPPED_IMAGE_TEACHER_LAUNCHES)),
    "stage-1 attention-taps": (
        {"loss_name": ["out_l1", "out_cos", "attention_score_mse", "attention_probs_mse",
                       "attention_probs_kl"]}, {},
        add_counts(MATERIALISED_IMAGE_STEP_LAUNCHES, MATERIALISED_IMAGE_TEACHER_LAUNCHES)),
}
# Stage 3 live with the contrastive losses.  No per-layer loss here:
# DualDistillTask has one teacher_need_layers for both towers while the final
# students return six and four layers, and the text student is 768 wide against
# the teacher's 512 with no projection.  fine_grain makes the students project
# all their tokens (need_last_layer); the teacher is unchanged.
CONTRASTIVE_LOSSES = {
    "loss_name": ["out_l1", "out_cos", "cos_diff", "hard_label", "soft_label", "logits_mse",
                  "fine_grain", "smd_multi_model"],
    "loss_scale": {"cos_diff": 0.1, "smd_multi_model": 0.01}, "temperature": 0.5}


def tapped_image_phase(ops, card: str, label: str, steps: int, keep_state: bool,
                       spec: Optional[tuple] = None, teacher: Optional[str] = None) -> dict:
    """One stage-1 step with tap losses: (a) against the plain fp32 CPU path
    with the same vit_kd mask, then (b) and (c).  ``spec`` (losses, student
    and task arguments, launches) where the label is not in
    TAPPED_IMAGE_PHASES; ``teacher`` a checkpoint other than the config's."""
    losses, student_over, expected = spec or TAPPED_IMAGE_PHASES[label]
    kw = dict(teacher=teacher, **student_over)
    task = make_image_task("bfloat16", losses, SIX_TEACHER_LAYERS, TAPPED_LR, **kw)
    plain = make_image_task("float32", losses, SIX_TEACHER_LAYERS, TAPPED_LR, **kw)
    print(f"train {label}: lr {TAPPED_LR:g} instead of the config's (tuned for out_l1 + "
          f"out_cos; with per-layer losses the repeated batch diverges at it)", flush=True)
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    frozen = [k for k, m in (task._mask or {}).items() if not m]
    aux = sorted(k for k in state.params if k.startswith("loss_aux."))
    print(f"train {label}: flags {task.flags}, {len(state.params)} parameter leaves "
          f"({len(aux)} of the loss's own), {len(frozen)} frozen", flush=True)
    small = [torch.from_numpy(make_images(np.random.default_rng(SEED + 20), 16))]
    with seeded_vit_kd_masks(SEED):
        compare_with_plain(label, task, plain, "loss_fn", state.params, small)
    del plain
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 21), PAIRS)).to(DEVICE)]
    return run_steps(ops, card, label, task.make_train_step(tx), state, batch, expected,
                     steps, keep_state, frozen)


def value_map_phase(scorer, task) -> None:
    """The value-map tap, softmax(V·Vᵀ·scale) of the last layer, of both tower
    families on 16 pairs: kernel-path towers on the card against the plain
    fp32 CPU towers.  (last_value_map_kl softmaxes over the head axis and so
    needs equal head counts, which the final students and ViT-B/32 do not
    have; the CPU tests hold the loss.)"""
    from distillclip_tpu_torch.models import ControlFlags
    from distillclip_tpu_torch.serving import LCLIPScorer
    from distillclip_tpu_torch.serving.inputs import prepare_inputs

    rng = np.random.default_rng(SEED + 30)
    images, tokens = torch.from_numpy(make_images(rng, 16)), torch.from_numpy(make_tokens(rng, 16))
    cpu_state = lambda m: {k: v.float().cpu() for k, v in m.state_dict().items()}
    plain = LCLIPScorer.from_config(str(CONFIG), cpu_state(scorer.image_tower),
                                    cpu_state(scorer.text_tower), device="cpu",
                                    dtype=torch.float32)
    card_teacher, cpu_teacher = task.teacher.compute(DEVICE), task.teacher.module
    flags = ControlFlags(need_value_map=True)
    towers = (("image student", scorer.image_tower, plain.image_tower, images),
              ("text student", scorer.text_tower, plain.text_tower, tokens),
              ("image teacher", card_teacher.image_tower, cpu_teacher.image_tower, images),
              ("text teacher", card_teacher.text_tower, cpu_teacher.text_tower, tokens))
    with torch.no_grad():
        for name, on_card, on_cpu, x in towers:
            got = on_card(prepare_inputs(x.to(DEVICE), torch.bfloat16), flags).value_map
            ref = on_cpu(prepare_inputs(x, torch.float32), flags).value_map
            err = float((got.cpu() - ref).abs().max())
            print(f"taps: {name} value map {tuple(got.shape)} {got.dtype} vs plain fp32 CPU "
                  f"tower max_abs_err {err:.3e} (limit 2e-2); rows sum to "
                  f"{float(got.sum(-1).mean()):.6f}", flush=True)
            if got.dtype != torch.float32 or got.shape != ref.shape or not err <= 2e-2:
                fail(f"the {name}'s value-map tap disagrees with the plain path")


def dropout_phase(ops, card: str) -> dict:
    """Stage 1 with non-zero drop_rate, attn_drop_rate and drop_path_rate in
    training mode (deterministic=False): three steps each from seeds 7, 7 and
    8.  Losses finite, the two runs from one seed bit-equal in losses and
    parameters, the third different.  Attention dropout takes the materialised
    path, so the student launches no attention kernel."""
    rates = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 40), PAIRS)).to(DEVICE)]
    runs, counts = [], None
    for seed in (7, 7, 8):
        task = make_image_task("bfloat16", **rates)
        state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
        step = task.make_train_step(tx, deterministic=False, seed=seed)
        losses = []
        for _ in range(3):
            ops.reset_launch_counts()
            state, metrics = step(state, *batch)
            counts = ops.launch_counts()
            losses.append(float(metrics["loss"]))
        runs.append((losses, state.params))
    print(f"train dropout (rates {rates}): losses by seed 7 / 7 / 8: "
          + " / ".join(" ".join(f"{x:.6f}" for x in r[0]) for r in runs), flush=True)
    print(f"train dropout: launches of one step {counts}", flush=True)
    (a, pa), (b, pb), (c, _) = runs
    same = a == b and all(torch.equal(pa[k], pb[k]) for k in pa)
    if not all(np.isfinite(a + c)) or not same or a == c:
        fail("the stochastic steps are not finite, do not repeat from their seed, or do "
             "not depend on it")
    expected = add_counts(MATERIALISED_IMAGE_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES)
    if counts != {**dict.fromkeys(ops.KERNELS, 0), **expected}:
        fail(f"launch counts of one stochastic step differ from {expected}")
    print(f"train dropout: two runs from seed 7 are bit-equal in losses and parameters; "
          f"seed 8 differs [{card}]", flush=True)
    return {"counts": counts}


# -- phase 5d': iRPE and the ResNet teacher -------------------------------------

# stage 1 with relative position tables on q, k and v: 50 tokens (the cls and
# a 7 x 7 grid), 50 product buckets, a table per head (configs/final/image.yaml
# has rpe_config: null; this is the overlay)
RPE_CONFIG = {"method": "product", "mode": "contextual", "shared_head": False, "rpe_on": "qkv"}
RPE_TABLE_STD = 0.3     # the tables' seeded values: zero tables make iRPE an exact no-op
# The key tables' gradient is a near-cancelling sum (q_i against the score
# gradient summed per bucket, whose rows sum to 0) and, under the config's
# pooled losses, about 1e-7 of the global norm in fp32 (the last layer's cls
# row sees one bucket only): bf16 cannot resolve its direction, on the card
# or on the CPU.  Such leaves are held by their distance from the plain path.
RPE_NOISE_FLOOR = 1e-6
# the iRPE student takes the materialised attention (no attention kernel), its
# dense layers and norms are the stage-1 step's; the teacher is unchanged
RPE_IMAGE_STEP_LAUNCHES = add_counts(MATERIALISED_IMAGE_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES)
# a teacher of RN50's geometry: the image tower is convolutions and an
# attention pool (PyTorch's own calls: no TPU kernel in the JAX package), the
# text tower ViT-B/32's (width 512, 12 layers, 8 heads, causal)
RN50_ARGS = dict(width=64, layers=(3, 4, 6, 3), image_resolution=224, embed_dim=1024,
                 text_width=512, text_layers=12, context_length=77, vocab_size=49408)
RN50_IMAGE_LAUNCHES: dict = {}
# bf16 through 16 bottlenecks of seeded weights with no normalising layer:
# the JAX package's own bf16 encode of this checkpoint reaches cosine 0.99839
# of its fp32 encode (CPU), below the ViT's 0.999.  The card's rows are held
# to the plain bf16 CPU encode's lowest cosine (the same rounding points)
# less RN50_COSINE_MARGIN, and to 2e-2 on unit rows.
RN50_COSINE_MARGIN = 1e-3
RN50_SCORE_LAUNCHES = TEXT_TEACHER_LAUNCHES
# stage 1 against the RN50 teacher: what the JAX package needs to run one
# (out_dim = the teacher's 1024, no embedding copy from a ResNet, no teacher
# layers), the student's launches alone
RN50_TASK = {"freeze_embed": False, "teacher_need_layers": None}
RN50_LOSSES = {"loss_name": ["out_l1", "out_cos"]}
RN50_STEP_LAUNCHES = IMAGE_STEP_LAUNCHES


def rn50_checkpoint() -> str:
    """A seeded CLIP checkpoint of RN50's geometry, written once under build/."""
    from distillclip_tpu_torch.tools.fabricate_teacher import make_rn_state_dict

    path = ROOT / "build" / "chip_smoke" / f"clip_rn50_arch_seed{SEED}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(make_rn_state_dict(**RN50_ARGS, seed=SEED), str(path))
    return str(path)


def irpe_phase(ops, card: str) -> dict:
    """Stage 1 of configs/final/image.yaml with iRPE on q, k and v, every
    table seeded non-zero: (a) 16 pairs against the plain fp32 CPU path, (b)
    steps on one batch with the launch table met, (c) ms/step."""
    task = make_image_task("bfloat16", rpe_config=RPE_CONFIG)
    plain = make_image_task("float32", rpe_config=RPE_CONFIG)
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    rng = np.random.default_rng(SEED + 50)
    tables = sorted(k for k in state.params if ".rpe_" in k)
    with torch.no_grad():
        for k in tables:
            v = rng.standard_normal(tuple(state.params[k].shape), dtype=np.float32)
            state.params[k].copy_(torch.from_numpy(v * np.float32(RPE_TABLE_STD)))
    frozen = [k for k, m in (task._mask or {}).items() if not m]
    print(f"train stage-1 iRPE: rpe_config {RPE_CONFIG}, {len(tables)} tables "
          f"({sum(state.params[k].numel() for k in tables)} values, seeded N(0, "
          f"{RPE_TABLE_STD}^2)), shapes {sorted({tuple(state.params[k].shape) for k in tables})}, "
          f"{len(state.params)} parameter leaves, {len(frozen)} frozen", flush=True)
    small = [torch.from_numpy(make_images(np.random.default_rng(SEED + 51), 16))]
    compare_with_plain("stage-1 iRPE", task, plain, "loss_fn", state.params, small,
                       noise_floor=RPE_NOISE_FLOOR)
    del plain
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 52), PAIRS)).to(DEVICE)]
    return run_steps(ops, card, "stage-1 iRPE", task.make_train_step(tx), state, batch,
                     RPE_IMAGE_STEP_LAUNCHES, 8, False, frozen)


def rn50_teacher_phase(ops, card: str) -> dict:
    """The RN50-geometry teacher: its image encode of 256 rows in bf16 against
    the plain fp32 CPU encode of the first 16 (unit rows, cosines), rows/s and
    peak memory; the teacher scorer's score_tokens at 256 pairs (pairs/s, the
    text tower's launches)."""
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher
    from distillclip_tpu_torch.serving import LCLIPScorer

    path = rn50_checkpoint()
    rng = np.random.default_rng(SEED + 60)
    images = make_images(rng, PAIRS, RN50_ARGS["image_resolution"])
    tokens = make_tokens(rng, PAIRS, RN50_ARGS["context_length"])
    teacher = FrozenTeacher(path, None, "image", None, torch.bfloat16)
    t0 = time.perf_counter()
    encode = teacher.image_encode(DEVICE)
    tower = teacher.tower(DEVICE, "image")
    print(f"teacher RN50: {type(tower).__name__} layers {tower.layers}, "
          f"{sum(p.numel() for p in teacher.module.parameters()) / 1e6:.2f} M image-tower "
          f"parameters (seeded), loaded and cast in {time.perf_counter() - t0:.1f} s", flush=True)
    d_images = torch.from_numpy(images).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = encode(d_images)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts != {**dict.fromkeys(ops.KERNELS, 0), **RN50_IMAGE_LAUNCHES}:
        fail(f"teacher RN50: image encode launches {counts}, want {RN50_IMAGE_LAUNCHES}")
    if rep.shape != (PAIRS, RN50_ARGS["embed_dim"]) or not torch.isfinite(rep).all():
        fail(f"teacher RN50: representations of shape {tuple(rep.shape)} or not finite")
    ms = cuda_ms(lambda: encode(d_images), iters=5, warmup=1)
    ref = FrozenTeacher(path, None, "image", None, torch.float32).image_encode("cpu")(images[:16])
    # the same rounding points on the CPU: what bf16 itself costs on these weights
    ref16 = FrozenTeacher(path, None, "image", None, torch.bfloat16).image_encode("cpu")(
        images[:16])

    def against(x):
        unit = lambda y: y / y.norm(dim=1, keepdim=True)
        cos = torch.nn.functional.cosine_similarity(x, ref, dim=1)
        return float((unit(x) - unit(ref)).abs().max()), float(cos.min())

    (err, cos), (err16, cos16) = against(rep[:16].cpu()), against(ref16)
    limit = cos16 - RN50_COSINE_MARGIN
    print(f"teacher RN50: image encode of {PAIRS} rows (bf16) {ms:.2f} ms, {PAIRS / ms * 1e3:.1f} "
          f"rows/s, peak device memory {peak:.2f} GiB; rows[:16] vs the plain fp32 CPU encode: "
          f"unit rows max_abs_err {err:.3e} (limit 2e-2), lowest cosine {cos:.6f} (limit "
          f"{limit:.6f}: the plain bf16 CPU encode's {cos16:.6f} less {RN50_COSINE_MARGIN:g}; its "
          f"unit rows {err16:.3e}); launches of one encode "
          f"{({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    if err > 2e-2 or cos < limit:
        fail("teacher RN50: the kernel-path encode disagrees with the plain fp32 CPU encode")
    del teacher, encode, tower, d_images
    scorer = LCLIPScorer.from_teacher(path, device=DEVICE)
    ops.reset_launch_counts()
    scores = scorer.score_tokens(images, tokens)
    score_counts = ops.launch_counts()
    if score_counts != {**dict.fromkeys(ops.KERNELS, 0), **RN50_SCORE_LAUNCHES}:
        fail(f"teacher RN50: score_tokens launches {score_counts}, want {RN50_SCORE_LAUNCHES}")
    if not np.isfinite(scores).all() or np.abs(scores).max() > 1.0 + 1e-5:
        fail("teacher RN50: scores not finite or outside [-1, 1]")
    d_images, d_tokens = torch.from_numpy(images).to(DEVICE), torch.from_numpy(tokens).to(DEVICE)
    scorer.score_tokens(d_images, d_tokens)
    t0 = time.perf_counter()
    for _ in range(5):
        scorer.score_tokens(d_images, d_tokens)       # returns numpy: the readback fences
    dt = (time.perf_counter() - t0) / 5
    print(f"throughput teacher RN50 score_tokens batch {PAIRS} (device-resident): "
          f"{PAIRS / dt:.1f} pairs/s, {dt * 1e3:.2f} ms/call; launches of one call (the text "
          f"tower) {({k: v for k, v in score_counts.items() if v})} [{card}]", flush=True)
    return {"teacher_rn50_image_encode": counts, "score_tokens teacher RN50": score_counts}


def rn50_stage_phase(ops, card: str) -> dict:
    """Stage 1 of configs/final/image.yaml's student against the RN50 teacher,
    live: (a) 16 pairs against the plain fp32 CPU path, (b) and (c)."""
    kw = dict(losses=RN50_LOSSES, teacher=rn50_checkpoint(), task_over=RN50_TASK,
              out_dim=RN50_ARGS["embed_dim"])
    task, plain = make_image_task("bfloat16", **kw), make_image_task("float32", **kw)
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    print(f"train stage-1 RN50 teacher: overlay {RN50_TASK}, losses {RN50_LOSSES['loss_name']}, "
          f"out_dim {RN50_ARGS['embed_dim']}, {len(state.params)} parameter leaves", flush=True)
    small = [torch.from_numpy(make_images(np.random.default_rng(SEED + 61), 16))]
    compare_with_plain("stage-1 RN50 teacher", task, plain, "loss_fn", state.params, small,
                       relative_loss=True)
    del plain
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 62), PAIRS)).to(DEVICE)]
    return run_steps(ops, card, "stage-1 RN50 teacher", task.make_train_step(tx), state, batch,
                     RN50_STEP_LAUNCHES, 8, False)


# -- phase 5d'': past 256 tokens and at the widest heads -----------------------------

# the published geometries (tools/fabricate_teacher.py PRESETS), seeded: the
# vision tower's tokens and the launches of one image encode.  Past 256 tokens
# (ViT-L/14: 257, @336px: 577) the towers materialise the attention, as the
# JAX towers take XLA's there: no attention kernel, 24 layers of lean K1 and K2
LONG_TEACHERS = {
    "ViT-L/14": (257, {"dense_ln": 24, "dense_act_ln": 24, "layer_norm_rows": 2}),
    "ViT-L/14@336px": (577, {"dense_ln": 24, "dense_act_ln": 24, "layer_norm_rows": 2}),
    "ViT-B/16": (197, IMAGE_TEACHER_LAUNCHES),
}
# the L/14 teacher scorer: its image encode and its text tower (768 wide, 12
# layers, 12 heads of 64: #13)
L14_SCORE_LAUNCHES = add_counts(
    LONG_TEACHERS["ViT-L/14"][1],
    {"dense_ln": 12, "dense_act_ln": 12, "plain_attention_rows_qkv": 12, "layer_norm_rows": 1})
# stage 1 of configs/final/image.yaml against the live ViT-L/14 (its tapped
# layers the L/14 ones): the student 1024 wide with the final image student's
# 32-wide heads (32 of them: the tensor-core #5 / #6), patch 16 at 224 px
# (197 tokens), out_dim the teacher's 768; depth 6, repeated twice, head mixes
# and mlp_ratio 4 as the config says.  freeze_embed copies the teacher's
# patch-14 embeddings into the student, which needs the teacher's patch
# geometry: off at patch 16, on (the config's) at patch 14
L14_LAYERS = [0, 1, 22, 23]
L14_STUDENT = dict(embed_dim=1024, num_heads=32, patch_size=16, out_dim=768)
L14_STEP_LAUNCHES = add_counts(
    {"dense_ln": 6, "dense_act_ln_res": 6, "transform_attention_save_p": 6,
     "transform_attention_bwd": 6, "dense_ln_bwd": 12, "layer_norm_rows": 1,
     "layer_norm_rows_bwd": 1}, LONG_TEACHERS["ViT-L/14"][1])
# the same student at patch 14: 257 tokens, its attention materialised too
L14_P14_PAIRS = 64
L14_P14_STEP_LAUNCHES = add_counts(MATERIALISED_IMAGE_STEP_LAUNCHES,
                                   LONG_TEACHERS["ViT-L/14"][1])
STAGE_L14 = {
    "stage-1 L/14": (dict(L14_STUDENT), {"freeze_embed": False}, PAIRS, L14_STEP_LAUNCHES),
    "stage-1 L/14 patch-14 student": (dict(L14_STUDENT, patch_size=14), {}, L14_P14_PAIRS,
                                      L14_P14_STEP_LAUNCHES),
}


# stage 1 of configs/final/image.yaml with a tap-reading loss and a 32-head
# student: stage-1 L/14's student (1024 wide, 32 heads of 32, patch 16 at 224
# px: 197 tokens) with ViT-B/16's embedding width, against the seeded ViT-B/16
# (768 wide, 12 layers, 12 heads of 64, 197 tokens) at SIX_TEACHER_LAYERS.
# vit_kd reads both towers' hidden states (need_rep), which sends the
# student's six attention forwards to #17 at 32 heads of 32 and the teacher's
# twelve to #16's forward; its own projection takes the student's 1024 columns
# to the teacher's 768 (196 = 14 x 14 patch tokens).  hidden_rep_mse and
# embedding_mse subtract the two towers' states element by element, in the
# JAX package as here, so they need equal widths and are left out at 1024
# against 768.  ViT-L/14 (1024 wide) has 257 tokens, which a 197-token student
# cannot be held against.  freeze_embed off: the patch geometries differ.
B16_TAPPED = "stage-1 B/16 tapped"
B16_TAPPED_SPEC = (
    {"loss_name": ["out_l1", "out_cos", "vit_kd"],
     "vit_kd_para": {"student_dims": 1024, "teacher_dims": 768}},
    dict(L14_STUDENT, out_dim=512, task_over={"freeze_embed": False}),
    add_counts(TAPPED_IMAGE_STEP_LAUNCHES, TAPPED_IMAGE_TEACHER_LAUNCHES))


def b16_tapped_phase(ops, card: str, keep_state: bool = False) -> dict:
    """Stage 1 against the live ViT-B/16 with B16_TAPPED_SPEC: (a) 16 pairs
    against the plain fp32 CPU path, (b) steps on one batch with the launch
    table met (six of #17 and none of its CUDA-core route), (c) ms/step and
    peak memory; the phase's wall."""
    t0 = time.perf_counter()
    run = tapped_image_phase(ops, card, B16_TAPPED, 6, keep_state, B16_TAPPED_SPEC,
                             preset_checkpoint("ViT-B/16"))
    counts = run["counts"]
    print(f"train {B16_TAPPED}: #17 launches a step {counts['flash_transform_attention_fwd']}, "
          f"its CUDA-core route {counts['flash_transform_attention_fwd_wide']}; ok; wall of "
          f"the phase {time.perf_counter() - t0:.1f} s", flush=True)
    return run


def preset_checkpoint(name: str) -> str:
    """A seeded CLIP checkpoint of a published geometry, written once under
    build/ (no OpenAI weights are in the repository)."""
    from distillclip_tpu_torch.tools.fabricate_teacher import preset_state_dict

    slug = name.replace("/", "").replace("@", "_").lower()
    path = ROOT / "build" / "chip_smoke" / f"clip_{slug}_arch_seed{SEED}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(preset_state_dict(name, seed=SEED), str(path))
    return str(path)


def long_teacher_phase(ops, card: str) -> dict:
    """The image encode of 256 rows in bf16 through each geometry of
    LONG_TEACHERS: launches as the table says, representations finite of the
    embedding's width, the first 16 against the plain fp32 CPU encode (each
    row's cosine at least 0.999), rows/s and peak memory."""
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher

    counts = {}
    for name, (tokens, want) in LONG_TEACHERS.items():
        t0 = time.perf_counter()
        path = preset_checkpoint(name)
        teacher = FrozenTeacher(path, None, "image", None, torch.bfloat16)
        encode = teacher.image_encode(DEVICE)
        visual = teacher.tower(DEVICE, "image").visual
        res, embed = visual.input_resolution, visual.proj.shape[1]
        n_tokens = (res // visual.patch_size) ** 2 + 1
        print(f"teacher {name}: {visual.width} wide, {visual.transformer.layers} layers, "
              f"{visual.transformer.heads} heads, {n_tokens} tokens at {res} px, "
              f"{sum(p.numel() for p in teacher.module.parameters()) / 1e6:.2f} M image-tower "
              f"parameters (seeded), written, loaded and cast in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if n_tokens != tokens:
            fail(f"teacher {name}: {n_tokens} tokens, the geometry has {tokens}")
        images = make_images(np.random.default_rng(SEED + 70), PAIRS, res)
        d_images = torch.from_numpy(images).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rep = encode(d_images)
        torch.cuda.synchronize()
        counts[f"teacher_image_encode {name}"] = got = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if got != {**dict.fromkeys(ops.KERNELS, 0), **want}:
            fail(f"teacher {name}: image encode launches {got}, want {want}")
        if rep.shape != (PAIRS, embed) or rep.dtype != torch.float32 \
                or not torch.isfinite(rep).all():
            fail(f"teacher {name}: representations {tuple(rep.shape)} {rep.dtype} or not finite")
        ms = cuda_ms(lambda: encode(d_images), iters=5, warmup=1)
        ref = FrozenTeacher(path, None, "image", None, torch.float32).image_encode("cpu")(
            images[:16])
        cos = float(torch.nn.functional.cosine_similarity(rep[:16].cpu(), ref, dim=1).min())
        print(f"throughput teacher {name} image encode {PAIRS} rows ({n_tokens} tokens, bf16): "
              f"{ms:.2f} ms, {PAIRS / ms * 1e3:.1f} rows/s, peak device memory {peak:.2f} GiB; "
              f"launches {({k: v for k, v in got.items() if v})} [{card}]", flush=True)
        print(f"teacher {name}: representations[:16] vs plain fp32 CPU encode min row cosine "
              f"{cos:.6f} (limit 0.999): ok", flush=True)
        if cos < 0.999:
            fail(f"teacher {name}: the kernel-path encode disagrees with the plain path")
        del teacher, encode, visual, d_images, rep
    return counts


def l14_score_phase(ops, card: str) -> dict:
    """LCLIPScorer.from_teacher on the ViT-L/14 checkpoint: score_tokens at
    256 pairs, launches as the table says, scores finite in [-1, 1] and the
    first 16 within 2e-2 of the plain fp32 CPU scorer; pairs/s."""
    from distillclip_tpu_torch.serving import LCLIPScorer

    path = preset_checkpoint("ViT-L/14")
    scorer = LCLIPScorer.from_teacher(path, device=DEVICE)
    rng = np.random.default_rng(SEED + 71)
    images, tokens = make_images(rng, PAIRS, scorer.image_size), make_tokens(rng, PAIRS)
    ops.reset_launch_counts()
    scores = scorer.score_tokens(images, tokens)
    counts = ops.launch_counts()
    if counts != {**dict.fromkeys(ops.KERNELS, 0), **L14_SCORE_LAUNCHES}:
        fail(f"L/14 scorer: score_tokens launches {counts}, want {L14_SCORE_LAUNCHES}")
    if scores.shape != (PAIRS,) or not np.isfinite(scores).all() \
            or np.abs(scores).max() > 1.0 + 1e-5:
        fail("L/14 scorer: scores not finite or outside [-1, 1]")
    plain = LCLIPScorer.from_teacher(path, device="cpu", dtype=torch.float32)
    err = float(np.abs(scores[:16] - plain.score_tokens(images[:16], tokens[:16])).max())
    del plain
    d_images, d_tokens = torch.from_numpy(images).to(DEVICE), torch.from_numpy(tokens).to(DEVICE)
    scorer.score_tokens(d_images, d_tokens)
    t0 = time.perf_counter()
    for _ in range(5):
        scorer.score_tokens(d_images, d_tokens)       # returns numpy: the readback fences
    dt = (time.perf_counter() - t0) / 5
    print(f"throughput teacher ViT-L/14 score_tokens batch {PAIRS} (device-resident): "
          f"{PAIRS / dt:.1f} pairs/s, {dt * 1e3:.2f} ms/call; scores[:16] vs plain fp32 CPU "
          f"scorer max_abs_err {err:.3e} (limit 2e-2); launches of one call "
          f"{({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    if err > 2e-2:
        fail("L/14 scorer: kernel-path scores disagree with the plain path")
    print("L/14 scorer: ok", flush=True)
    return {"score_tokens teacher ViT-L/14": counts}


def l14_stage_phase(ops, card: str, label: str, keep_state: bool = False) -> dict:
    """Stage 1 of configs/final/image.yaml against the live ViT-L/14 with the
    student of STAGE_L14[label]: (a) 16 pairs against the plain fp32 CPU
    path, (b) steps on one batch with the launch table met, (c) ms/step."""
    student, task_over, pairs, expected = STAGE_L14[label]
    kw = dict(need_layers=L14_LAYERS, teacher=preset_checkpoint("ViT-L/14"),
              task_over=task_over, **student)
    task, plain = make_image_task("bfloat16", **kw), make_image_task("float32", **kw)
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    frozen = [k for k, m in (task._mask or {}).items() if not m]
    tokens = (task.student.img_size // task.student.patch_size) ** 2 + 1
    print(f"train {label}: student {student} ({tokens} tokens), task overlay {task_over}, "
          f"teacher ViT-L/14 (seeded) layers {L14_LAYERS}, losses "
          f"{task.loss_control_para['loss_name']}, {len(state.params)} parameter leaves "
          f"({sum(v.numel() for v in state.params.values()) / 1e6:.2f} M fp32 masters), "
          f"{len(frozen)} frozen", flush=True)
    small = [torch.from_numpy(make_images(np.random.default_rng(SEED + 72), 16))]
    compare_with_plain(label, task, plain, "loss_fn", state.params, small, relative_loss=True)
    del plain
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 73), pairs)).to(DEVICE)]
    run = run_steps(ops, card, label, task.make_train_step(tx), state, batch, expected, 6,
                    keep_state, frozen)
    print(f"train {label}: ok", flush=True)
    return run


# stage 1 of configs/final/image.yaml under configs/eva02_image.yaml: the
# config's student (out_dim 768, freeze_embed off) against a seeded
# EVA02-CLIP-L/14 vision tower (1024 wide, 24 blocks of 16 heads of 64, the
# SwiGLU width 2730 padded to 2752, 257 tokens: its attention the long-row
# kernel).  A block runs each of EVA-02's three modes once, K1 once (the
# sub-LN and proj) and #13L once; the class rows' final norm is K4
EVA_OVERLAY = ROOT / "configs" / "eva02_image.yaml"
EVA_LABEL = "stage-1 EVA02-L/14"
EVA_TEACHER_LAUNCHES = {"dense_ln_rope": 24, "dense_swiglu_ln": 24, "dense_ln_width": 24,
                        "dense_ln": 24, "plain_attention_long": 24, "layer_norm_rows": 1}
EVA_STEP_LAUNCHES = add_counts(IMAGE_STEP_LAUNCHES, EVA_TEACHER_LAUNCHES)


def eva_checkpoint() -> str:
    """A seeded EVA02-CLIP-L/14 vision tower in EVA-CLIP's key layout, written
    once under build/ (no EVA-02 weights are in the repository)."""
    from distillclip_tpu_torch.tools.fabricate_teacher import make_eva_state_dict

    path = ROOT / "build" / "chip_smoke" / f"eva02_clip_l14_arch_seed{SEED}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(make_eva_state_dict(width=1024, layers=24, patch_size=14,
                                       image_resolution=224, embed_dim=768, seed=SEED),
                   str(path))
    return str(path)


def eva_stage_phase(ops, card: str) -> dict:
    """Stage 1 against the live EVA02-CLIP-L/14 tower, the task built as the
    overlay sets it: (a) 16 pairs against the plain fp32 CPU path, (b) steps
    on one batch with the launch table met (each of EVA-02's modes 24 times a
    step), (c) ms/step; the phase's wall."""
    t0 = time.perf_counter()
    over = _config_args(EVA_OVERLAY)
    kw = dict(teacher=eva_checkpoint(),
              task_over={k: over[k] for k in ("freeze_embed", "teacher_need_layers")},
              **over["student_encoder"]["init_args"])
    task, plain = make_image_task("bfloat16", **kw), make_image_task("float32", **kw)
    state, tx = task.init_state(SEED, steps_per_epoch=1, device=DEVICE)
    visual = task.teacher.tower(DEVICE, "image").visual
    print(f"train {EVA_LABEL}: teacher {type(visual).__name__} (seeded) {visual.width} wide, "
          f"{len(visual.blocks)} blocks, SwiGLU {visual.blocks[0].hidden} padded to "
          f"{visual.blocks[0].ffn_ln.scale.numel()}; student {over['student_encoder']}, "
          f"{len(state.params)} parameter leaves "
          f"({sum(v.numel() for v in state.params.values()) / 1e6:.2f} M fp32 masters)",
          flush=True)
    small = [torch.from_numpy(make_images(np.random.default_rng(SEED + 74), 16))]
    compare_with_plain(EVA_LABEL, task, plain, "loss_fn", state.params, small,
                       relative_loss=True)
    del plain
    batch = [torch.from_numpy(make_images(np.random.default_rng(SEED + 75), PAIRS)).to(DEVICE)]
    run = run_steps(ops, card, EVA_LABEL, task.make_train_step(tx), state, batch,
                    EVA_STEP_LAUNCHES, 6, False)
    print(f"train {EVA_LABEL}: ok; wall of the phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return run


def long_seq_phases(ops, card: str, keep_state: bool = False) -> tuple:
    """Phase 5d'': the teachers past 256 tokens, the L/14 scorer, stage 1
    against the live ViT-L/14 with a 32-head student (#5 and #6 at 32 heads)
    and with a patch-14 student (its attention materialised), the 32-head
    student tapped against ViT-B/16 (#17 at 32 heads), and image.yaml's
    student against the live EVA02-CLIP-L/14 (EVA-02's three modes)."""
    counts = long_teacher_phase(ops, card)
    counts.update(l14_score_phase(ops, card))
    runs = {label: l14_stage_phase(ops, card, label, keep_state) for label in STAGE_L14}
    runs[B16_TAPPED] = b16_tapped_phase(ops, card, keep_state)
    runs[EVA_LABEL] = eva_stage_phase(ops, card)
    return counts, runs


def profile_long_encodes(card: str) -> None:
    """--profile: the image encode of 256 rows through each LONG_TEACHERS
    geometry (past 256 tokens the attention's products are cuBLAS batched
    products and its softmax an elementwise pass)."""
    from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher

    for name in LONG_TEACHERS:
        teacher = FrozenTeacher(preset_checkpoint(name), None, "image", None, torch.bfloat16)
        encode = teacher.image_encode(DEVICE)
        res = teacher.tower(DEVICE, "image").visual.input_resolution
        x = torch.from_numpy(make_images(np.random.default_rng(SEED + 70), PAIRS, res)).to(DEVICE)
        profile(f"teacher {name} image encode {PAIRS} rows", lambda: encode(x), 5, card)
        del teacher, encode, x


# -- phase 5e: the perf knobs ---------------------------------------------------

@contextlib.contextmanager
def perf_section(section: dict):
    """The process environment with only ``section``'s knobs set (through
    config.perf.apply_perf_config), restored afterwards."""
    from distillclip_tpu_torch.config import apply_perf_config

    saved = {k: v for k, v in os.environ.items() if k.startswith("DISTILLCLIP_")}
    for k in saved:
        del os.environ[k]
    try:
        yield apply_perf_config(section)
    finally:
        for k in [k for k in os.environ if k.startswith("DISTILLCLIP_")]:
            del os.environ[k]
        os.environ.update(saved)


def knob_phase(ops, card: str, label: str, default_run: dict, keep_state: bool) -> dict:
    """The serving call and the text-cached step built under one knob set:
    (a) 16 pairs against the plain fp32 CPU path built under the same knobs,
    (b) 256 pairs with the knob's launch table, (c) ms and pairs/s; the step's
    run (its state only with ``keep_state``)."""
    from distillclip_tpu_torch.serving import LCLIPScorer

    section, serving_want, step_want = KNOB_PHASES[label]
    with perf_section(section) as effective:
        print(f"knobs {label}: perf section {section}, effective {effective}", flush=True)
        rng = np.random.default_rng(SEED)
        scorer = LCLIPScorer.from_config(str(CONFIG), device=DEVICE, seed=SEED)
        images = make_images(rng, PAIRS, scorer.image_size)
        tokens = make_tokens(rng, PAIRS, scorer.context_length)
        ops.reset_launch_counts()
        scores = scorer.score_tokens(images, tokens)
        serving_counts = ops.launch_counts()
        print(f"knobs {label}: launches of one serving call {serving_counts}", flush=True)
        if serving_counts != {**dict.fromkeys(ops.KERNELS, 0), **serving_want}:
            fail(f"{label}: serving launches differ from {serving_want}")
        if not np.isfinite(scores).all() or np.abs(scores).max() > 1.0 + 1e-5:
            fail(f"{label}: scores not finite or outside [-1, 1]")
        cpu_state = lambda m: {k: v.float().cpu() for k, v in m.state_dict().items()}
        plain = LCLIPScorer.from_config(str(CONFIG), cpu_state(scorer.image_tower),
                                        cpu_state(scorer.text_tower), device="cpu",
                                        dtype=torch.float32)
        err = float(np.abs(scores[:16] - plain.score_tokens(images[:16], tokens[:16])).max())
        d_images, d_tokens = torch.from_numpy(images).to(DEVICE), torch.from_numpy(tokens).to(DEVICE)
        ms = cuda_ms(lambda: scorer.score_tokens(d_images, d_tokens), iters=5, warmup=1)
        print(f"knobs {label}: serving scores[:16] vs plain fp32 CPU path max_abs_err {err:.3e} "
              f"(limit 2e-2); throughput score_tokens batch {PAIRS} (device-resident) "
              f"{ms:.2f} ms/call, {PAIRS / ms * 1e3:.1f} pairs/s [{card}]", flush=True)
        if err > 2e-2:
            fail(f"{label}: kernel-path scores disagree with the plain path")
        del scorer, plain, d_images, d_tokens
        run = dual_phase(ops, card, f"text-cached {label}", "text-cached", make_task("bfloat16"),
                         make_task("float32"), step_want, 6, SEED + 10, keep_state)
    if label == "tf_impl=factored":
        same = run["losses"] == default_run["losses"][:len(run["losses"])]
        print(f"knobs {label}: losses bit-equal to the default text-cached step's: {same}",
              flush=True)
        if not same:
            fail(f"{label}: the factored route changed the text-cached step's losses")
    return {"serving": serving_counts, "step": run["counts"], "run": run}


# -- phase 5g: the trainer -------------------------------------------------------

# the trainer-overhead configuration: the final students at full width, 256
# pairs, uint8 images, the text teacher's representations cached
FIT_CONFIG = ROOT / "configs" / "bench_fit_lclip.yaml"
FIT_SEED = 2022          # the CLI's default seed
FIT_PAIRS = 1024         # 4 steps of 256 an epoch
FIT_VAL_BATCHES = 2
# the cached-text step (the image teacher live) and the eval step (both
# teachers live, every kernel lean: no gradient)
FIT_TRAIN_LAUNCHES = add_counts(TRAIN_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES)
FIT_EVAL_LAUNCHES = add_counts(SERVING_LAUNCHES, IMAGE_TEACHER_LAUNCHES, TEXT_TEACHER_LAUNCHES)
FIT_DIR = ROOT / "build" / "chip_smoke" / "fit"


def fit_overlay(max_epochs: int) -> str:
    """The overlay on FIT_CONFIG: the seeded teacher, a 1024-pair corpus,
    validation every epoch on two batches (the teacher's baseline at epoch
    0), a log line every step, results under build/."""
    import yaml

    overlay = {"model": {"init_args": {"teacher_name": teacher_checkpoint()}},
               "data": {"init_args": {"dataset_para": {"size": FIT_PAIRS}}},
               "trainer": {"max_epochs": max_epochs, "limit_val_batches": FIT_VAL_BATCHES,
                           "log_every_n_steps": 1, "check_val_every_n_epoch": 1,
                           "logger": {"init_args": {"dir": str(FIT_DIR / "result")}}}}
    path = FIT_DIR / f"overlay_{max_epochs}_epochs.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(overlay))
    return str(path)


def fit_cli(args: list) -> tuple:
    """(exit code, standard output) of ``cli.main(args)`` on DEVICE."""
    from distillclip_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args + ["--device", DEVICE])
    print(f"fit: cli.main {' '.join(a if '/' not in a else Path(a).name for a in args)}: rc "
          f"{rc} in {time.perf_counter() - t0:.1f} s", flush=True)
    return rc, buf.getvalue()


def fit_records(run_dir: Path) -> list:
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def fit_bare_step(ops, overlay: str) -> tuple:
    """One cached-text step and one eval step, built from the same config,
    seeded masters and first batches as the fit: (first loss, the step's
    launches, the eval step's launches)."""
    from distillclip_tpu_torch.config import instantiate, load_configs
    from distillclip_tpu_torch.training.trainer import fit_loaders, to_device

    cfg = load_configs([str(FIT_CONFIG), overlay])
    task = instantiate(cfg["model"])
    loader, val_loader = fit_loaders(instantiate(cfg["data"]), DEVICE)
    loader.set_epoch(0)
    batch = to_device(next(iter(loader)), DEVICE)
    state, tx = task.init_state(FIT_SEED, len(loader), device=DEVICE)
    step = task.make_train_step(tx, cached_text_teacher=True, seed=FIT_SEED)
    ops.reset_launch_counts()
    state, metrics = step(state, batch["tokens"], batch["images"], batch["tea_rep"])
    loss = float(metrics["loss"])
    train_counts = ops.launch_counts()
    val = to_device(next(iter(val_loader)), DEVICE)
    ops.reset_launch_counts()
    eval_metrics, reps = task.make_eval_step()(state, val["tokens"], val["images"])
    torch.cuda.synchronize()
    eval_counts = ops.launch_counts()
    if not all(np.isfinite(float(v)) for v in eval_metrics.values()) or \
            reps["stu_image_outs"].shape != tuple(val["tea_rep"].shape):
        fail("fit: the eval step's metrics are not finite or its representations misshapen")
    return loss, train_counts, eval_counts


# the trainer-overhead measurement: the config's own log interval and
# bench_fit_prestaged.yaml's 40-step epochs, the host loader against the
# prestaged one, each fit traced (torch.profiler) over its first steps
FIT_PRESTAGED_CONFIG = ROOT / "configs" / "bench_fit_prestaged.yaml"
FIT_MEASURE_PAIRS = 10240
FIT_MEASURE_EPOCHS = 3   # epoch 0 traced and cold; epochs 1 and 2 read
FIT_TRACE_SKIP = 1       # the traced steps read after the first


def fit_measure_overlay(name: str) -> str:
    """The overlay of a measured fit: the seeded teacher, FIT_MEASURE_PAIRS
    pairs, the config's log interval and validation (the last epoch only, on
    one batch), the trace profiler, results under build/."""
    import yaml

    overlay = {"model": {"init_args": {"teacher_name": teacher_checkpoint()}},
               "data": {"init_args": {"dataset_para": {"size": FIT_MEASURE_PAIRS}}},
               "trainer": {"max_epochs": FIT_MEASURE_EPOCHS, "limit_val_batches": 1,
                           "profiler": "trace",
                           "logger": {"init_args": {"dir": str(FIT_DIR / "result"),
                                                    "name": name}}}}
    path = FIT_DIR / f"overlay_{name}.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(overlay))
    return str(path)


def fit_overhead(card: str, text_cached_ms: float):
    """The trainer's rate beside the bare step's at the config's own log
    interval over 40-step epochs, with the host loader and with the
    prestaged one: items/s and input stall of each warm epoch and the
    trace's split of a step.  The two runs see the same permutations and
    masters, so their logged losses agree (the prestaged loader's batches
    are the host loader's, on the card)."""
    import shutil

    bare = PAIRS / text_cached_ms * 1e3
    losses = {}
    for name, configs in (("fit-measure-host", [FIT_CONFIG]),
                          ("fit-measure-prestaged", [FIT_CONFIG, FIT_PRESTAGED_CONFIG])):
        run_dir = FIT_DIR / "result" / name
        shutil.rmtree(run_dir, ignore_errors=True)
        args = [a for c in configs for a in ("-c", str(c))]
        rc, _ = fit_cli(["fit", *args, "-c", fit_measure_overlay(name)])
        if rc != 0:
            fail(f"{name}: rc {rc}")
        records = fit_records(run_dir)
        perf = [r for r in records if "perf/items_per_s" in r]
        losses[name] = [r["train_loss/loss"] for r in records if "train_loss/loss" in r]
        if len(perf) != FIT_MEASURE_EPOCHS or len(losses[name]) != FIT_MEASURE_EPOCHS or \
                not np.isfinite(losses[name]).all():
            fail(f"{name}: {len(perf)} epochs, logged losses {losses[name]}")
        split = trace_split(run_dir / "torch_trace" / "trace.json")
        warm = perf[1:]
        print(f"fit overhead {name}: {FIT_MEASURE_PAIRS // PAIRS} steps an epoch, a log line "
              f"an epoch (the config's every 100 steps); warm epochs "
              + "; ".join(f"{r['perf/items_per_s']:.1f} items/s ({r['perf/items_per_s'] / bare:.3f} "
                          f"of the bare step), stall {r['perf/input_stall_frac']:.4f} of "
                          f"{r['perf/epoch_time_s']:.3f} s" for r in warm)
              + f"; traced steps {FIT_TRACE_SKIP + 1}-{FIT_TRACE_SKIP + split['steps']} of epoch 0 "
              f"(under the profiler): host {split['host_step_ms']:.2f} ms a step "
              f"(to_device {split['to_device_ms']:.2f}, train_step launch "
              f"{split['train_step_ms']:.2f}), device busy {split['device_busy_ms']:.2f} of a "
              f"{split['device_window_ms']:.2f} ms window (idle share "
              f"{1 - split['device_busy_ms'] / split['device_window_ms']:.4f}); the bare "
              f"text-cached step {bare:.1f} pairs/s [{card}]", flush=True)
    host, staged = losses.values()
    rel = max(abs(a - b) / abs(a) for a, b in zip(host, staged))
    print(f"fit overhead: logged losses host {host}, prestaged {staged} (max rel diff "
          f"{rel:.3e}, limit 1e-5)", flush=True)
    if rel > 1e-5:
        fail("fit: the prestaged loader's run does not see the host loader's batches")


def fit_phase(ops, card: str, text_cached_ms: float) -> dict:
    """The trainer through the CLI at the final students' width: fit (two
    epochs), the first loss against the bare step on the same first batch,
    the launches of one train and one eval step, resume, validate, lr_find,
    and the trainer's items/s beside the bare step's pairs/s."""
    import shutil

    import yaml

    config = str(FIT_CONFIG)
    run_dir = FIT_DIR / "result" / yaml.safe_load(FIT_CONFIG.read_text())[
        "trainer"]["logger"]["init_args"]["name"]
    shutil.rmtree(run_dir, ignore_errors=True)
    overlay = fit_overlay(2)
    ops.reset_launch_counts()
    rc, out = fit_cli(["fit", "-c", config, "-c", overlay])
    fit_counts = ops.launch_counts()
    if rc != 0:
        fail(f"fit: rc {rc}")
    records = fit_records(run_dir)
    train = [r for r in records if "train_loss/loss" in r]
    val = [r for r in records if "val_loss/loss" in r]
    perf = [r for r in records if "perf/items_per_s" in r]
    print(f"fit: {len(train)} logged train steps, {len(val)} validations, summary "
          f"{out.strip().splitlines()[-1] if out.strip() else None}", flush=True)
    if len(train) != 2 * FIT_PAIRS // PAIRS or len(val) != 2 or len(perf) != 2:
        fail(f"fit: {len(train)} train steps, {len(val)} validations, {len(perf)} epochs")
    for r in train + val:
        bad = [k for k, v in r.items() if k.startswith(("train_loss/", "val_loss/", "val_stu_acc/"))
               and not np.isfinite(v)]
        if bad:
            fail(f"fit: values not finite at step {r['step']}: {bad}")
    if not all(any(k.startswith("val_stu_acc/") for k in r) for r in val):
        fail("fit: a validation without the retrieval accuracies")
    tea = [r["epoch"] for r in records if any(k.startswith("val_tea_acc/") for k in r)]
    if tea != [0.0]:
        fail(f"fit: the teacher's baseline at epochs {tea}, not at epoch 0 only")
    last, index = run_dir / "checkpoints" / "last", run_dir / "checkpoints" / "index.json"
    if not (last.exists() and index.exists()):
        fail("fit: checkpoints/last or index.json missing")
    kept = [e["name"] for e in json.loads(index.read_text())["entries"]]
    print("fit: losses " + " ".join(f"{r['train_loss/loss']:.6f}" for r in train)
          + f"; val_loss/loss {[round(r['val_loss/loss'], 6) for r in val]}; "
          f"val_stu_acc/stu_acc_top1 {[r['val_stu_acc/stu_acc_top1'] for r in val]}; "
          f"checkpoints kept {kept}", flush=True)

    loss, train_counts, eval_counts = fit_bare_step(ops, overlay)
    first = train[0]["train_loss/loss"]
    rel = abs(first - loss) / abs(loss)
    print(f"fit: first logged train_loss/loss {first:.6f} vs the bare cached-text step on the "
          f"same first batch and seeded masters {loss:.6f} (rel err {rel:.3e}, limit 1e-3)",
          flush=True)
    if rel > 1e-3:
        fail("fit: the trainer's first loss is not the bare step's")
    print(f"fit: launches of one train step {train_counts}; of one eval step {eval_counts}",
          flush=True)
    zero = dict.fromkeys(ops.KERNELS, 0)
    if train_counts != {**zero, **FIT_TRAIN_LAUNCHES}:
        fail(f"fit: train step launches differ from {FIT_TRAIN_LAUNCHES}")
    if eval_counts != {**zero, **FIT_EVAL_LAUNCHES}:
        fail(f"fit: eval step launches differ from {FIT_EVAL_LAUNCHES}")
    want = add_counts(*[FIT_TRAIN_LAUNCHES] * len(train),
                      *[FIT_EVAL_LAUNCHES] * (len(val) * FIT_VAL_BATCHES))
    if fit_counts != {**zero, **want}:
        fail(f"fit: the run's launches {fit_counts} are not {len(train)} train and "
             f"{len(val) * FIT_VAL_BATCHES} eval steps' {want}")

    rc, _ = fit_cli(["fit", "-c", config, "-c", fit_overlay(3), "--ckpt", str(last)])
    resumed = [r for r in fit_records(run_dir)[len(records):] if "train_loss/loss" in r]
    if rc != 0 or {r["epoch"] for r in resumed} != {2.0} or len(resumed) != len(train) // 2:
        fail(f"fit --ckpt: rc {rc}, epochs {sorted({r['epoch'] for r in resumed})}, "
             f"{len(resumed)} steps (want epoch 2 only, {len(train) // 2} steps)")
    print(f"fit --ckpt last: one more epoch, steps {[r['step'] for r in resumed]}, losses "
          + " ".join(f"{r['train_loss/loss']:.6f}" for r in resumed), flush=True)
    rc, out = fit_cli(["validate", "-c", config, "-c", overlay, "--ckpt", str(last)])
    metrics = json.loads(out) if rc == 0 else {}
    if rc != 0 or not np.isfinite(metrics.get("loss", np.nan)):
        fail(f"validate: rc {rc}")
    print(f"validate --ckpt last: loss {metrics['loss']:.6f}, val_stu_acc/stu_acc_top1 "
          f"{metrics['val_stu_acc/stu_acc_top1']}, val_tea_acc/tea_acc_top1 "
          f"{metrics['val_tea_acc/tea_acc_top1']}", flush=True)
    rc, out = fit_cli(["lr_find", "-c", config, "-c", overlay, "--steps", "16",
                       "--max-lr", "1e-2"])
    print(f"lr_find: {out.strip().splitlines()[-1] if out.strip() else None}", flush=True)
    if rc != 0:
        fail(f"lr_find: rc {rc} (no suggestion)")

    warm = perf[-1]
    bare = PAIRS / text_cached_ms * 1e3
    print(f"fit: warm epoch {warm['perf/items_per_s']:.1f} items/s, input stall "
          f"{warm['perf/input_stall_frac']:.4f} of {warm['perf/epoch_time_s']:.3f} s; the bare "
          f"text-cached step {bare:.1f} pairs/s ({text_cached_ms:.2f} ms/step, "
          f"device-resident) [{card}]", flush=True)
    fit_overhead(card, text_cached_ms)
    return {"fit train_step": train_counts, "fit eval_step": eval_counts}


# -- phase 5h: the final configs' own data, and data parallelism ------------------

DATA_DIR = ROOT / "build" / "chip_smoke" / "data"
CORPUS_TRAIN, CORPUS_VAL, CORPUS_CAPTIONS = 1024, 256, 4096
CORPUS_COCO_TRAIN = 2048     # l_clip's 4-step epochs leave the loader working
FINAL_PAIRS = 256        # items a step (the configs say 512 and 1024)
FINAL_EPOCHS, FINAL_STEPS, FINAL_VAL_BATCHES = 2, 4, 2
FINAL_VAL_BATCH = CORPUS_VAL // FINAL_VAL_BATCHES   # the configs say 1250
FINAL_CUTS = (f"{FINAL_PAIRS} items a step, {FINAL_EPOCHS} epochs of {FINAL_STEPS} steps, "
              f"validation on {FINAL_VAL_BATCHES} batches of {FINAL_VAL_BATCH}, the seeded "
              f"teacher, a log line every step")
# the students without a gradient (the eval steps' lean towers): the image
# student's 6 logical layers, the text student's 4, each with its final norm
IMAGE_STUDENT_LEAN = {"dense_ln": 6, "dense_act_ln": 6, "transform_attention_rows_qkv": 6,
                      "layer_norm_rows": 1}
TEXT_STUDENT_LEAN = {"dense_ln": 4, "dense_act_ln": 4, "transform_attention_rows_qkv": 4,
                     "layer_norm_rows": 1}
# stage 2: the text student alone (4 logical layers), its teacher cached
TEXT_STEP_LAUNCHES = {"dense_ln": 4, "dense_act_ln_res": 4, "transform_attention_save_p": 4,
                      "transform_attention_bwd": 4, "dense_ln_bwd": 8, "layer_norm_rows": 1,
                      "layer_norm_rows_bwd": 1}
# config -> (its file, the train step's launches, the eval step's)
FINAL_FITS = {
    "l_clip": (CONFIG, FIT_TRAIN_LAUNCHES, FIT_EVAL_LAUNCHES),
    "image": (IMAGE_CONFIG, add_counts(IMAGE_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES),
              add_counts(IMAGE_STUDENT_LEAN, IMAGE_TEACHER_LAUNCHES)),
    "text": (ROOT / "configs" / "final" / "text.yaml", TEXT_STEP_LAUNCHES,
             add_counts(TEXT_STUDENT_LEAN, TEXT_TEACHER_LAUNCHES)),
}
# the encoders of data/component/utils.py -> (the tower, its launches per chunk)
ENCODERS = {"encode_texts": ("text", TEXT_TEACHER_LAUNCHES),
            "encode_tokens": ("text", TEXT_TEACHER_LAUNCHES),
            "encode_images": ("image", IMAGE_TEACHER_LAUNCHES)}


def corpus_phase() -> None:
    """The final configs' layouts, written from a seed by the port's
    fabricator: COCO train2017 / val2017 with their captions, the combined
    folder of coco- and imagenet-prefixed JPEGs, and a CC3M tsv of captions."""
    import shutil

    from distillclip_tpu_torch.tools.fabricate_images import (
        WORDS,
        fabricate,
        fabricate_coco_train,
    )

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fabricate(str(DATA_DIR), n_train=CORPUS_TRAIN, n_val=CORPUS_VAL, seed=SEED)
        fabricate_coco_train(str(DATA_DIR), n_train=CORPUS_COCO_TRAIN, seed=SEED + 1)
    (DATA_DIR / "cc").mkdir()
    (DATA_DIR / "cc" / "train_cc3m.tsv").write_text("".join(
        f"{WORDS[i % len(WORDS)]} number {i}\thttp://cc.invalid/{i}.jpg\n"
        for i in range(CORPUS_CAPTIONS)))
    print(f"corpus: {CORPUS_TRAIN} combined train JPEGs (coco and imagenet prefixes), "
          f"{CORPUS_COCO_TRAIN} COCO train2017 and {CORPUS_VAL} val2017 JPEGs (224 px) with their "
          f"captions, {CORPUS_CAPTIONS} CC3M captions, under {DATA_DIR.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def final_overlay(name: str) -> dict:
    """What the final config's run changes: the corpus paths, the seeded
    teacher, the stage checkpoints as ``load_path`` and the cuts."""
    teacher = teacher_checkpoint()
    data = {"cache_dir": str(DATA_DIR / "cache"), "teacher_name": teacher}
    if name == "l_clip":
        data.update(root_path=str(DATA_DIR / "mscoco"),
                    annotation_path=str(DATA_DIR / "mscoco" / "annotations"))
    elif name == "image":
        data.update(combine_dataset_path=str(DATA_DIR / "combined"))
    model = {"teacher_name": teacher, "download_root": str(DATA_DIR / "cache")}
    if name == "l_clip":
        model["load_path"] = stage_checkpoints()
    return {"model": {"init_args": model},
            "data": {"init_args": {"train_batch_size": FINAL_PAIRS,
                                   "val_batch_size": FINAL_VAL_BATCH,
                                   "prepare_para": {"raw_data_dir": str(DATA_DIR)},
                                   "dataset_para": data}},
            "trainer": {"max_epochs": FINAL_EPOCHS, "limit_train_batches": FINAL_STEPS,
                        "limit_val_batches": FINAL_VAL_BATCHES, "log_every_n_steps": 1,
                        "check_val_every_n_epoch": 1,
                        "logger": {"init_args": {"dir": str(DATA_DIR / "result"),
                                                 "name": f"final-{name}"}}}}


def final_config(name: str) -> list:
    """[the final config, the overlay file]."""
    import yaml

    path = DATA_DIR / f"overlay_{name}.yaml"
    path.write_text(yaml.safe_dump(final_overlay(name)))
    return [str(FINAL_FITS[name][0]), str(path)]


UNIT_ROW_LIMIT = 5e-3    # the cached rows' readings: 1.6e-3 (text), 1.9e-3 (image)


@contextlib.contextmanager
def logged_encodes(records: list):
    """The teacher encodes of ``data/component/utils.py`` while the block
    runs, from their log records: encoder, rows, chunks, seconds."""
    import logging

    from distillclip_tpu_torch.data.component import utils

    class Records(logging.Handler):
        def emit(self, record):
            if hasattr(record, "encode"):
                records.append(record.encode)

    logger, handler, level = utils.log, Records(), utils.log.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def encode_launches(records: list) -> dict:
    """The launches of the encodes in ``records``: chunks x one encode's."""
    return add_counts(*[{k: v * r["chunks"] for k, v in ENCODERS[r["encoder"]][1].items()}
                        for r in records])


def written_caches(before: dict) -> list:
    """The cache files under DATA_DIR/cache written since ``before`` (path ->
    mtime)."""
    return sorted(p for p in (DATA_DIR / "cache").glob("*.npz")
                  if before.get(p) != p.stat().st_mtime_ns)


def cache_mtimes() -> dict:
    return {p: p.stat().st_mtime_ns for p in (DATA_DIR / "cache").glob("*.npz")}


def check_cache(path: Path, label: str, card: str) -> None:
    """A teacher cache as prepare wrote it: its first 16 rows against the
    plain fp32 CPU encode of the same inputs, and, as the control, against
    the plain encode of the next row's input."""
    from distillclip_tpu_torch.data.component import utils
    from distillclip_tpu_torch.data.component.ms_coco import load_coco_index

    with np.load(path) as f:
        cache = {k: f[k] for k in f.files}
    if "caption_rep" in cache:
        index = load_coco_index(str(DATA_DIR / "mscoco" / "annotations" /
                                    "captions_train2017.json"))
        key, encoder, inputs = "caption_rep", "encode_texts", [c[0] for _, c in index[:17]]
    elif "captions_rep" in cache:
        key, encoder = "captions_rep", "encode_texts"
        inputs = list(map(str, cache["captions"][:17]))
    elif "image_rep" in cache:
        key, encoder, inputs = "image_rep", "encode_images", list(map(str, cache["paths"][:17]))
    elif "train_rep" in cache:
        with np.load(path.with_name(path.name.replace("-reps-", "-"))) as f:
            key, encoder, inputs = "train_rep", "encode_tokens", f["tokens"][:17]
    else:
        return      # the token cache: no teacher
    got = cache[key][:len(inputs) - 1]
    plain = getattr(utils, encoder)(inputs, teacher_checkpoint(), device="cpu")     # fp32
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)

    def reading(ref):
        a, b = unit(got), unit(ref)
        return float(np.abs(a - b).max()), float((a * b).sum(1).min())

    (unit_err, cos), (control_err, control_cos) = reading(plain[:-1]), reading(plain[1:])
    err = float(np.abs(got - plain[:-1]).max())
    name = path.name.replace(teacher_checkpoint().replace("/", "-"), "<teacher>")
    print(f"prepare {label}: {name} {key} {cache[key].shape}, rows[:{len(got)}] vs the plain "
          f"fp32 CPU encode ({encoder}): unit rows max_abs_err {unit_err:.3e} (limit "
          f"{UNIT_ROW_LIMIT:g}), min row cosine {cos:.6f} (limit 0.999); raw max_abs_err "
          f"{err:.3e} of values up to {float(np.abs(plain).max()):.3f}; control, each row "
          f"against the next input's encode: unit max_abs_err {control_err:.3e}, min cosine "
          f"{control_cos:.6f} [{card}]",
          flush=True)
    if unit_err > UNIT_ROW_LIMIT or cos < 0.999 or not np.isfinite(got).all():
        fail(f"prepare {label}: the card's {key} cache disagrees with the plain encode")
    if control_err <= UNIT_ROW_LIMIT and control_cos >= 0.999:
        fail(f"prepare {label}: the limits do not tell one input's {key} row from another's")


def prepare_phase(ops, card: str) -> dict:
    """Each final config's prepare through MainDataModule.prepare_data on
    the card: its wall seconds and launches (the sum over its encodes of
    chunks x one encode's), per encode its rows, chunks and rows/s, and per
    cache its first 16 rows against the plain fp32 CPU encode."""
    from distillclip_tpu_torch.config import instantiate, load_configs

    counts = {}
    zero = dict.fromkeys(ops.KERNELS, 0)
    for name, label in (("l_clip", "ms_coco"), ("image", "combine_image"),
                        ("text", "combine_text")):
        dm = instantiate(load_configs(final_config(name))["data"])
        before, records = cache_mtimes(), []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with logged_encodes(records):
            dm.prepare_data(DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = ops.launch_counts(), encode_launches(records)
        for r in records:
            print(f"prepare {label}: {r['encoder']} ({ENCODERS[r['encoder']][0]} teacher) "
                  f"{r['rows']} rows in {r['chunks']} chunks of {r['batch_size']}: "
                  f"{r['seconds']:.3f} s, {r['rows'] / r['seconds']:.1f} rows/s [{card}]",
                  flush=True)
        print(f"prepare {label}: {wall:.2f} s wall (the teachers' loads, decode and tokenise "
              f"included); launches {({k: v for k, v in got.items() if v})} (want {want})",
              flush=True)
        if not records:
            fail(f"prepare {label}: no teacher encode ran")
        if got != {**zero, **want}:
            fail(f"prepare {label}: the launches differ from chunks x one encode's")
        for path in written_caches(before):
            check_cache(path, label, card)
        counts[f"prepare {label}"] = got
    return counts


# each final config's bare step, ms at FINAL_PAIRS (the roofline's yardsticks)
BARE_STEP_MS: dict = {}


def final_fit_phase(ops, card: str, name: str) -> dict:
    """``cli.main fit`` on one final config with its own dataset and the
    cuts; the first logged loss against the bare step on the trainer's first
    batch and seeded masters, the launches of one train and one eval step,
    finite validation metrics, items/s and input stall beside the bare
    step's pairs/s."""
    import shutil

    from distillclip_tpu_torch.config import instantiate, load_configs
    from distillclip_tpu_torch.training import trainer as trainer_mod
    from distillclip_tpu_torch.training.trainer import to_device

    configs = final_config(name)
    _, want_train, want_eval = FINAL_FITS[name]
    run_dir = DATA_DIR / "result" / f"final-{name}"
    shutil.rmtree(run_dir, ignore_errors=True)
    first: list = []

    def capture(batch, device):
        moved = to_device(batch, device)
        if not first:
            first.append(moved)
        return moved

    trainer_mod.to_device = capture
    encodes: list = []
    ops.reset_launch_counts()
    try:
        with logged_encodes(encodes):
            rc, out = fit_cli(["fit", "-c", configs[0], "-c", configs[1]])
    finally:
        trainer_mod.to_device = to_device
    run_counts = ops.launch_counts()
    if rc != 0:
        fail(f"fit {name}: rc {rc}")
    records = fit_records(run_dir)
    train = [r for r in records if "train_loss/loss" in r]
    val = [r for r in records if "val_loss/loss" in r]
    perf = [r for r in records if "perf/items_per_s" in r]
    if len(train) != FINAL_EPOCHS * FINAL_STEPS or len(val) != FINAL_EPOCHS or \
            len(perf) != FINAL_EPOCHS:
        fail(f"fit {name}: {len(train)} train steps, {len(val)} validations, {len(perf)} epochs")
    for r in train + val:
        bad = [k for k, v in r.items() if k.startswith(("train_loss/", "val_loss/", "val_stu_acc/"))
               and not np.isfinite(v)]
        if bad or (r in val and not any(k.startswith("val_stu_acc/") for k in r)):
            fail(f"fit {name}: values not finite or missing at step {r['step']}: {bad}")

    cfg = load_configs(configs)
    task = instantiate(cfg["model"])
    dm = instantiate(cfg["data"])
    dm.setup("fit")                 # the caches the fit prepared
    loader, val_loader = dm.train_dataloader(), dm.val_dataloader()
    batch = first[0]
    state, tx = task.init_state(FIT_SEED, min(len(loader), FINAL_STEPS), device=DEVICE)
    dual = hasattr(task, "image_student")
    if dual:
        step = task.make_train_step(tx, cached_text_teacher=True, seed=FIT_SEED)
        inputs = [batch["tokens"], batch["images"], batch["tea_rep"]]
    elif "tea_rep" in batch:
        step = task.make_train_step(tx, cached_teacher=True, seed=FIT_SEED)
        inputs = [batch["tea_rep"], batch["inputs"]]
    else:
        step = task.make_train_step(tx, seed=FIT_SEED)
        inputs = [batch["inputs"]]
    ops.reset_launch_counts()
    state, metrics = step(state, *inputs)
    loss = float(metrics["loss"])
    train_counts = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, metrics = step(state, *inputs)
    float(metrics["loss"])
    bare_ms = (time.perf_counter() - t0) / 5 * 1e3
    BARE_STEP_MS[name] = bare_ms
    val_batch = to_device(next(iter(val_loader)), DEVICE)
    eval_step = task.make_eval_step()
    ops.reset_launch_counts()
    eval_args = ([val_batch["tokens"], val_batch["images"]] if dual
                 else [val_batch["inputs"], val_batch["contrary"]])
    eval_metrics, _ = eval_step(state, *eval_args)
    torch.cuda.synchronize()
    eval_counts = ops.launch_counts()
    if not all(np.isfinite(float(v)) for v in eval_metrics.values()):
        fail(f"fit {name}: the bare eval step's metrics are not finite")

    rel = abs(train[0]["train_loss/loss"] - loss) / abs(loss)
    warm = perf[-1]
    bare = len(inputs[0]) / bare_ms * 1e3
    shapes = {k: f"{tuple(v.shape)} {str(v.dtype)[6:]}" for k, v in batch.items()}
    print(f"fit {Path(configs[0]).name}: {cfg['data']['init_args']['dataset']} on the "
          f"fabricated corpus, batch {shapes}"
          f"{', RandAugment(4) on the host' if dual or task.model_type == 'image' else ''}; "
          f"cuts: {FINAL_CUTS}; first logged train_loss/loss {train[0]['train_loss/loss']:.6f} "
          f"vs the bare step on the same batch and seeded masters {loss:.6f} (rel err "
          f"{rel:.3e}, limit 1e-3); val_loss/loss {[round(r['val_loss/loss'], 6) for r in val]}, "
          f"val_stu_acc/stu_acc_top1 {[r['val_stu_acc/stu_acc_top1'] for r in val]}; warm epoch "
          f"{warm['perf/items_per_s']:.1f} items/s, input stall {warm['perf/input_stall_frac']:.4f}"
          f" of {warm['perf/epoch_time_s']:.3f} s; the bare step {bare_ms:.2f} ms, {bare:.1f} "
          f"pairs/s (device-resident) [{card}]", flush=True)
    print(f"fit {name}: launches of one train step "
          f"{({k: v for k, v in train_counts.items() if v})}; of one eval step "
          f"{({k: v for k, v in eval_counts.items() if v})}", flush=True)
    if rel > 1e-3:
        fail(f"fit {name}: the trainer's first loss is not the bare step's")
    zero = dict.fromkeys(ops.KERNELS, 0)
    if train_counts != {**zero, **want_train}:
        fail(f"fit {name}: train step launches differ from {want_train}")
    if eval_counts != {**zero, **want_eval}:
        fail(f"fit {name}: eval step launches differ from {want_eval}")
    check_run_launches(f"fit {name}", run_counts, zero, want_train, len(train), want_eval,
                       len(val) * FINAL_VAL_BATCHES, encodes)
    del task, state, loader, val_loader, first
    return {f"fit {name} train_step": train_counts, f"fit {name} eval_step": eval_counts}


def check_run_launches(label: str, counts: dict, zero: dict, want_train: dict, steps: int,
                       want_eval: dict, eval_steps: int, encodes: list) -> None:
    """A fit's launches against its train and eval steps' tables and the
    teacher encodes its prepare ran."""
    want = add_counts(*[want_train] * steps, *[want_eval] * eval_steps, encode_launches(encodes))
    print(f"{label}: the run's launches {({k: v for k, v in counts.items() if v})} = {steps} "
          f"train steps, {eval_steps} eval steps and {sum(r['chunks'] for r in encodes)} "
          f"encode chunks of prepare: {counts == {**zero, **want}}", flush=True)
    if counts != {**zero, **want}:
        fail(f"{label}: the run's launches are not its steps' and encodes' {want}")


def traced_fit_phase(ops, card: str) -> None:
    """configs/final/l_clip.yaml's fit once more, for one epoch of 8 steps
    (the whole COCO corpus) under the trace profiler (its first 5 steps, so
    that the loader still works while steps 2-5 run): the host's split of a
    step (to_device, the train step's launch) and the device's busy share,
    past the first step."""
    import shutil

    import yaml

    configs = final_config("l_clip")
    run_name = "final-l_clip-traced"
    run_dir = DATA_DIR / "result" / run_name
    shutil.rmtree(run_dir, ignore_errors=True)
    overlay = DATA_DIR / "overlay_l_clip_traced.yaml"
    steps = CORPUS_COCO_TRAIN // FINAL_PAIRS
    overlay.write_text(yaml.safe_dump({"trainer": {
        "max_epochs": 1, "limit_train_batches": steps, "profiler": "trace",
        "logger": {"init_args": {"name": run_name}}}}))
    encodes: list = []
    ops.reset_launch_counts()
    with logged_encodes(encodes):
        rc, _ = fit_cli(["fit", "-c", configs[0], "-c", configs[1], "-c", str(overlay)])
    counts = ops.launch_counts()
    if rc != 0:
        fail(f"fit l_clip traced: rc {rc}")
    records = fit_records(run_dir)
    train = [r for r in records if "train_loss/loss" in r]
    perf = [r for r in records if "perf/items_per_s" in r]
    if len(train) != steps or len(perf) != 1:
        fail(f"fit l_clip traced: {len(train)} train steps, {len(perf)} epochs")
    _, want_train, want_eval = FINAL_FITS["l_clip"]
    check_run_launches("fit l_clip traced", counts, dict.fromkeys(ops.KERNELS, 0), want_train,
                       len(train), want_eval, FINAL_VAL_BATCHES, encodes)
    split = trace_split(run_dir / "torch_trace" / "trace.json")
    rest = split["host_step_ms"] - split["to_device_ms"] - split["train_step_ms"]
    epoch = perf[0]
    print(f"fit l_clip.yaml traced: one epoch of {steps} steps of {FINAL_PAIRS} (the COCO "
          f"corpus; cold, under the profiler) {epoch['perf/items_per_s']:.1f} items/s, input stall "
          f"{epoch['perf/input_stall_frac']:.4f} of {epoch['perf/epoch_time_s']:.3f} s; steps "
          f"{FIT_TRACE_SKIP + 1}-{FIT_TRACE_SKIP + split['steps']}: host "
          f"{split['host_step_ms']:.2f} ms a step (to_device {split['to_device_ms']:.2f}, "
          f"train_step launch {split['train_step_ms']:.2f}, the rest {rest:.2f}: waiting on the "
          f"loader, logging), device busy {split['device_busy_ms']:.2f} of a "
          f"{split['device_window_ms']:.2f} ms window (idle share "
          f"{1 - split['device_busy_ms'] / split['device_window_ms']:.4f}) [{card}]", flush=True)


DDP_PAIRS, DDP_STEPS = 256, 4


def ddp_phase(ops, card: str) -> dict:
    """tools/dryrun.py over NCCL on min(2, device_count) ranks: the
    text-cached step of configs/final/l_clip.yaml on each rank's rows of one
    seeded global batch against the single process on the whole batch."""
    procs = min(2, torch.cuda.device_count())
    cmd = [sys.executable, "-m", "distillclip_tpu_torch.tools.dryrun", "--procs", str(procs),
           "--device", DEVICE, "--config", str(CONFIG),
           "--teacher", teacher_checkpoint(), "--pairs", str(DDP_PAIRS), "--steps",
           str(DDP_STEPS), "--timeout", "400", "--work", str(ROOT / "build" / "dryrun" / "smoke")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=500)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"ddp: {line}", flush=True)
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    print(f"ddp: world size {procs} over {'NCCL' if DEVICE == 'cuda' else 'gloo'} "
          f"(tools/dryrun.py, the text-cached step of "
          f"l_clip.yaml, {DDP_PAIRS} pairs a rank, {DDP_STEPS} steps), rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s: each rank's losses {res.get('losses')}; masters "
          f"bitwise equal across ranks {res.get('masters_equal')}; against the single process "
          f"on the global batch: loss rel diff {res.get('loss_rel_diff')}, max |master diff| "
          f"{res.get('max_master_diff')}; {res.get('ms')} ms the last step, the single "
          f"process {res.get('single_ms')} ms [{card}]", flush=True)
    if proc.returncode != 0 or not res.get("ok"):
        print(proc.stderr[-4000:], flush=True)
        fail(f"ddp: the dry run failed (rc {proc.returncode})")
    if procs == 1 and res["loss_rel_diff"] > 1e-6:
        fail("ddp: at world size 1 the loss differs from the single process's")
    print(f"ddp: launches of the first rank's last step "
          f"{({k: v for k, v in res['launches'].items() if v})}", flush=True)
    if res["launches"] != {**dict.fromkeys(ops.KERNELS, 0), **FIT_TRAIN_LAUNCHES}:
        fail(f"ddp: the step's launches differ from {FIT_TRAIN_LAUNCHES}")
    return {"ddp train_step": res["launches"]}


def data_phases(ops, card: str) -> dict:
    """Phase 5h: the corpus, prepare, fit on the three final configs (and
    l_clip's traced), ddp."""
    corpus_phase()
    counts = prepare_phase(ops, card)
    for name in FINAL_FITS:
        counts.update(final_fit_phase(ops, card, name))
    traced_fit_phase(ops, card)
    counts.update(ddp_phase(ops, card))
    return counts


# -- phase 5i: the tools ----------------------------------------------------------

INPUT_BENCH_THREADS, INPUT_BENCH_ITEMS = (1, 4), 256
TRACED_STEPS = 5          # the trainer's trace profiler records the first 5 steps


def tools_phase(ops, card: str, text_cached_ms: float) -> None:
    """Each tool of distillclip_tpu_torch/tools on the card: the kernel oracle
    on the row LayerNorm's cases, the 50-step trajectory against its CPU legs,
    the roofline floors beside the measured steps, the digest of the traced
    l_clip fit's trace, the input bench on phase 5h's corpus, and one epoch of
    the cached-teacher A/B (a few seconds on the card)."""
    from distillclip_tpu_torch.tools import (
        cached_teacher_ab,
        hw_oracle,
        hw_trajectory,
        input_bench,
        roofline,
        trace_summary,
    )

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = hw_oracle.main(["--only", "layer_norm_rows"])
    lines = out.getvalue().splitlines()
    print(f"tools hw_oracle --only layer_norm_rows: rc {rc}, {lines[-1]} "
          f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    if rc != 0:
        print("\n".join(lines), flush=True)
        fail("tools: hw_oracle disagrees")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = hw_trajectory.main([])
    verdict = json.loads(out.getvalue().splitlines()[-1])
    first, last = verdict["loss_first_last"]
    print(f"tools hw_trajectory ({hw_trajectory.STEPS} steps of {hw_trajectory.BATCH} rows, card "
          f"against the CPU and its perturbed shadow): rc {rc}, verdict {json.dumps(verdict)}; "
          f"card loss {first:.6f} -> {last:.6f} ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    if rc != 0 or not verdict["ok"]:
        fail("tools: the card's trajectory disagrees with the CPU's")

    for stage, ms, what in (("joint", text_cached_ms, "the text-cached stage-3 step"),
                            ("text", BARE_STEP_MS.get("text"), "fit text.yaml's bare step")):
        r = roofline.roofline(stage, PAIRS)
        line = (f"tools roofline --stage {stage} --batch {PAIRS}: floor {r['floor_ms']:.4f} ms "
                f"({r['true_gflops']:.1f} true GFLOP, {r['issued_gflops']:.1f} issued)")
        if ms:
            line += f"; {what} {ms:.2f} ms = {ms / r['floor_ms']:.2f}x the floor"
        print(f"{line} [{card}]", flush=True)

    trace = DATA_DIR / "result" / "final-l_clip-traced"
    digest = trace_summary.summarize(trace, top=6, steps=TRACED_STEPS)
    print(f"tools trace_summary (fit l_clip.yaml traced, {TRACED_STEPS} steps): device "
          f"{digest['device_total_ms_per_step']} ms/step; top families "
          + "; ".join(f"{f['family']} {f['ms_per_step']} ms ({f['pct']}%)"
                      for f in digest["families"]) + f" [{card}]", flush=True)
    if not digest["families"]:
        fail("tools: the traced fit's trace holds no device events")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bench = input_bench.run(str(DATA_DIR), n=INPUT_BENCH_ITEMS,
                                threads_list=INPUT_BENCH_THREADS, n_captions=20000,
                                device=DEVICE, cache_dir=str(DATA_DIR / "input_bench"))
    rates = {k: {t: v and round(v, 1) for t, v in per.items()}
             for k, per in bench["images_per_s"].items()}
    captions = {k: round(v, 1) if isinstance(v, float) else v
                for k, v in bench["captions_per_s"].items()}
    print(f"tools input_bench ({INPUT_BENCH_ITEMS} items of phase 5h's combined corpus, 224 px, "
          f"batches of 64 normalised on the card; {bench['cpu_count']} host cores): items/s by "
          f"format and threads {rates}; captions/s {captions} ({time.perf_counter() - t0:.1f} s) "
          f"[{card}]", flush=True)
    if not all(v and v > 0 for per in bench["images_per_s"].values() for v in per.values()):
        fail("tools: input_bench measured no items")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cached_teacher_ab.main(["--epochs", "1", "--workdir",
                                     str(DATA_DIR / "cached_teacher_ab")])
    ab = json.loads(out.getvalue()[out.getvalue().index("{"):])
    losses = {name: r.get("val_loss/loss") for name, r in ab.items()}
    print(f"tools cached_teacher_ab --epochs 1 (the fabricated 32 px corpus, a 64-wide pair): "
          f"rc {rc}, val_loss/loss {losses}, val_stu_acc/stu_acc_top1 "
          f"{({n: r.get('val_stu_acc/stu_acc_top1') for n, r in ab.items()})} "
          f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    if rc != 0 or not all(v is not None and np.isfinite(v) for v in losses.values()):
        fail("tools: cached_teacher_ab did not finish with finite validation losses")


# -- phase 5f: the score entry point -------------------------------------------

CAPTION_WORDS = ("a", "the", "cat", "dog", "on", "grass", "red", "car", "two", "people",
                 "walking", "near", "sea", "under", "blue", "sky", "with", "an", "old",
                 "building", "bird", "tree", "sitting", "bench", "street")


def score_inputs(n: int):
    """``n`` seeded 320 x 240 images as JPEG files (PIL) and ``n`` captions in
    a file, under build/chip_smoke/score; (image dir or None without PIL, the
    captions file, the uint8 images)."""
    root = ROOT / "build" / "chip_smoke" / "score"
    (root / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 50)
    images = rng.integers(0, 256, size=(n, 240, 320, 3), dtype=np.uint8)
    captions = [" ".join(rng.choice(CAPTION_WORDS, size=int(rng.integers(3, 12))))
                for _ in range(n)]
    (root / "captions.txt").write_text("\n".join(captions) + "\n")
    try:
        from PIL import Image
    except ImportError:
        return None, str(root / "captions.txt"), images
    for i, img in enumerate(images):
        Image.fromarray(img).save(root / "images" / f"{i:04d}.jpg", quality=90)
    return str(root / "images"), str(root / "captions.txt"), images


def student_checkpoint() -> str:
    """The seeded students of configs/final/l_clip.yaml as one stage-3
    checkpoint in the port's format."""
    from distillclip_tpu_torch.serving import LCLIPScorer
    from distillclip_tpu_torch.training.checkpoints import nest, save_pytree

    path = ROOT / "build" / "chip_smoke" / f"l_clip_students_seed{SEED}.pt"
    if not path.exists():
        s = LCLIPScorer.from_config(str(CONFIG), device="cpu", dtype=torch.float32, seed=SEED)
        masters = {f"student.{tower}.{k}": v for tower, m in (("image_tower", s.image_tower),
                                                             ("text_tower", s.text_tower))
                   for k, v in m.state_dict().items()}
        save_pytree(str(path), {"params": nest(masters)})
    return str(path)


def score_phase(ops, card: str) -> dict:
    """cli.main score on the card with the teacher and with student
    checkpoints: one line per pair, finite scores in [-1, 1], equal to
    score_tokens on the same decoded and tokenised rows, and file scoring's
    pairs/s beside score_tokens'."""
    from distillclip_tpu_torch import cli
    from distillclip_tpu_torch.data import native_loader
    from distillclip_tpu_torch.serving import LCLIPScorer

    image_dir, captions_file, arrays = score_inputs(PAIRS)
    captions = [c for c in Path(captions_file).read_text().splitlines() if c.strip()]
    decoder = ("native/libdcloader.so" if native_loader.available()
               else "PIL" if image_dir else "none")
    print(f"score: image decoder: {decoder}", flush=True)
    teacher, students = teacher_checkpoint(), student_checkpoint()
    # kind -> (the CLI's arguments, the same scorer's, the launches of one call)
    kinds = {"teacher": (["--teacher", teacher], dict(teacher_name=teacher),
                         add_counts(IMAGE_TEACHER_LAUNCHES, TEXT_TEACHER_LAUNCHES)),
             "students": (["--image-ckpt", students, "--text-ckpt", students, "-c", str(CONFIG)],
                          dict(image_ckpt=students, text_ckpt=students, config=str(CONFIG)),
                          SERVING_LAUNCHES)}
    counts = {}
    for kind, (args, scorer_args, want) in kinds.items():
        scorer = LCLIPScorer.from_checkpoints(**scorer_args, device=DEVICE)
        if image_dir is None:
            print(f"score {kind}: no image decoder: cli.main is not run; score_arrays on the "
                  f"uint8 images with the same captions", flush=True)
            ops.reset_launch_counts()
            got = scorer.score_arrays(arrays, captions)
            counts[kind] = ops.launch_counts()
            paths, decoded = None, arrays
        else:
            buf = io.StringIO()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["score", "--images", image_dir, "--captions", captions_file,
                               "--device", DEVICE] + args)
            wall = time.perf_counter() - t0
            counts[kind] = ops.launch_counts()
            lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
            if rc != 0 or len(lines) != PAIRS or any(
                    set(x) != {"image", "caption", "l_clip_score"} for x in lines):
                fail(f"score {kind}: rc {rc}, {len(lines)} lines for {PAIRS} pairs")
            got = np.array([x["l_clip_score"] for x in lines], np.float32)
            paths = [x["image"] for x in lines]
            if [x["caption"] for x in lines] != captions:
                fail(f"score {kind}: the lines' captions are not the file's, in order")
            decoded = native_loader.decode_batch_files(paths, size=scorer.image_size)
            print(f"score {kind}: cli.main score over {PAIRS} files in {wall:.2f} s (the "
                  f"scorer's build and checkpoint reads included)", flush=True)
        print(f"score {kind}: launches {counts[kind]}", flush=True)
        if counts[kind] != {**dict.fromkeys(ops.KERNELS, 0), **want}:
            fail(f"score {kind}: launches differ from {want}")
        if got.shape != (PAIRS,) or not np.isfinite(got).all() or np.abs(got).max() > 1 + 1e-5:
            fail(f"score {kind}: scores not finite or outside [-1, 1]")
        tokens = scorer._tokenize(captions)
        ref = scorer.score_tokens(decoded, tokens)
        diff = float(np.abs(got - ref).max())
        print(f"score {kind}: tokenizer {type(scorer.tokenizer).__name__}; scores vs "
              f"score_tokens on the same rows max diff {diff:.3e} (limit 1e-6); range "
              f"[{got.min():.4f}, {got.max():.4f}]", flush=True)
        if diff > 1e-6:
            fail(f"score {kind}: the entry point's scores differ from score_tokens")
        if paths is not None:
            scorer.score_files(paths[:8], captions[:8])          # warm-up
            t0 = time.perf_counter()
            scorer.score_files(paths, captions)
            files_s = time.perf_counter() - t0
            scorer.score_tokens(decoded, tokens)
            t0 = time.perf_counter()
            scorer.score_tokens(decoded, tokens)
            tokens_s = time.perf_counter() - t0
            print(f"throughput score {kind} {PAIRS} pairs: score_files {PAIRS / files_s:.1f} "
                  f"pairs/s ({files_s * 1e3:.1f} ms, {decoder} decode and tokenise on the host); "
                  f"score_tokens on the decoded fp32 rows {PAIRS / tokens_s:.1f} pairs/s "
                  f"({tokens_s * 1e3:.1f} ms) [{card}]", flush=True)
        del scorer
    return counts


# -- phase 6b ---------------------------------------------------------------

def throughput(scorer, card: str) -> None:
    rng = np.random.default_rng(SEED + 1)
    for batch in (256, 1024):
        images, tokens = make_images(rng, batch), make_tokens(rng, batch)
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
    batches = [(make_images(rng, 256), make_tokens(rng, 256)) for _ in range(8)]
    list(scorer.score_tokens_stream(batches[:2]))  # warm-up
    t0 = time.perf_counter()
    n = sum(len(s) for s in scorer.score_tokens_stream(batches, depth=2))
    dt = time.perf_counter() - t0
    print(f"throughput score_tokens_stream 8 x 256 (host uint8 in, depth 2): "
          f"{n / dt:.1f} pairs/s [{card}]", flush=True)


# -- --profile --------------------------------------------------------------

def profile(label: str, fn, iters: int, card: str) -> None:
    """torch.profiler over ``iters`` calls of ``fn``: wall per call and the
    device time of each group of kernels as a share of the wall."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    groups = dict.fromkeys([g for g, _ in PROFILE_GROUPS] + [REST], 0.0)
    for name, dev_us in device_events(prof):
        groups[family_of(name)] += dev_us / 1e3 / iters
    total = sum(groups.values())
    print(f"profile {label}: wall {wall_ms:.3f} ms per call under the profiler, device kernels "
          f"{total:.3f} ms, busy share {total / wall_ms:.3f} [{card}]", flush=True)
    if total == 0.0:
        print(f"profile {label}: the profiler recorded no device time", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}:   {group}: {ms:.3f} ms/call, share of wall "
              f"{ms / wall_ms:.3f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from distillclip_tpu_torch import ops
    from distillclip_tpu_torch.ops import _build
    from distillclip_tpu_torch.serving import LCLIPScorer

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.1f} s "
          f"(log: {_build.BUILD_DIR / 'build.log'})", flush=True)
    if (_build.BUILD_DIR / "build.log").exists():
        ptxas_lines(_build.BUILD_DIR / "build.log")
    cluster_line(_build.lib(), card)

    try:
        results, case_ms = kernel_oracles(card)
    except Disagreement as err:
        fail(str(err))
    if missing := sorted(set(ops.KERNELS) - set(results)):
        fail(f"kernels without an oracle case: {missing}")
    scale_lines(card)
    scorer, serving_counts = serving_slice(ops, LCLIPScorer)
    throughput(scorer, card)

    profiling = "--profile" in sys.argv[1:]
    task, plain = make_task("bfloat16"), make_task("float32")
    check_warm_start(task)
    runs = {"all-cached": dual_phase(ops, card, "all-cached", "all-cached", task, plain,
                                     TRAIN_STEP_LAUNCHES, 8, SEED + 3, profiling)}
    teacher_counts = teacher_phase(ops, card, task, plain)
    runs["text-cached"] = dual_phase(
        ops, card, "text-cached", "text-cached", task, plain,
        add_counts(TRAIN_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES), 12, SEED + 10, profiling)
    runs["live"] = dual_phase(
        ops, card, "live", "live", task, None,
        add_counts(TRAIN_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES, TEXT_TEACHER_LAUNCHES), 6,
        SEED + 12, profiling)
    del plain
    runs["all-cached plain-attention"] = dual_phase(
        ops, card, "all-cached plain-attention", "all-cached",
        make_task("bfloat16", use_transform=False), make_task("float32", use_transform=False),
        PLAIN_STEP_LAUNCHES, 6, SEED + 14, profiling)
    runs["stage-1"] = image_stage_phase(ops, card)
    for label, steps in (("stage-1 tapped", 8), ("stage-1 tapped plain-attention", 6),
                         ("stage-1 attention-taps", 6)):
        runs[label] = tapped_image_phase(ops, card, label, steps, profiling)
    value_map_phase(scorer, task)
    runs["live contrastive"] = dual_phase(
        ops, card, "live contrastive", "live", make_task("bfloat16", losses=CONTRASTIVE_LOSSES),
        make_task("float32", losses=CONTRASTIVE_LOSSES),
        add_counts(TRAIN_STEP_LAUNCHES, IMAGE_TEACHER_LAUNCHES, TEXT_TEACHER_LAUNCHES), 6,
        SEED + 16, profiling, selecting=("fine_grain", "smd_multi_model"))
    runs["stage-1 dropout"] = dropout_phase(ops, card)
    t0 = time.perf_counter()
    runs["stage-1 iRPE"] = irpe_phase(ops, card)
    rn50_counts = rn50_teacher_phase(ops, card)
    runs["stage-1 RN50 teacher"] = rn50_stage_phase(ops, card)
    print(f"wall: the iRPE and RN50 phases {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    long_counts, long_runs = long_seq_phases(ops, card, profiling)
    runs.update(long_runs)
    print(f"wall: the ViT-L/14, ViT-B/16 and EVA02-L/14 phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    knob_runs = {label: knob_phase(ops, card, label, runs["text-cached"],
                                   profiling and label.startswith("fc1_ln=0"))
                 for label in KNOB_PHASES}
    fit_counts = fit_phase(ops, card, runs["text-cached"]["ms"])
    data_counts = data_phases(ops, card)
    score_counts = score_phase(ops, card)
    t0 = time.perf_counter()
    tools_phase(ops, card, runs["text-cached"]["ms"])
    print(f"wall: the tools phase {time.perf_counter() - t0:.1f} s", flush=True)

    if profiling:
        tokens, images = runs["all-cached"]["batch"][:2]
        profile("score_tokens 256 pairs (device-resident)",
                lambda: scorer.score_tokens(images, tokens), 5, card)
        for label in ("all-cached", "text-cached", "live", "all-cached plain-attention",
                      "stage-1 tapped",
                      "stage-1 tapped plain-attention", "stage-1 attention-taps",
                      "live contrastive", "stage-1 L/14", "stage-1 L/14 patch-14 student",
                      B16_TAPPED):
            run = runs[label]
            profile(f"train step {label} {int(run['batch'][0].shape[0])} pairs",
                    lambda r=run: r["step"](r["state"], *r["batch"]), 5, card)
        profile_long_encodes(card)
        for label in ("fc1_ln=0", "fc1_ln=0 fc1_res=u"):
            run = knob_runs[label]["run"]
            with perf_section(KNOB_PHASES[label][0]):
                profile(f"train step text-cached {label} 256 pairs",
                        lambda r=run: r["step"](r["state"], *r["batch"]), 5, card)
    library_device_times(results, case_ms, card)

    paths = {"serving_call": serving_counts,
             "teacher_image_encode": teacher_counts["image"],
             "teacher_text_encode": teacher_counts["text"],
             **{f"train_step {k}": v["counts"] for k, v in runs.items()},
             **{f"serving_call {k}": v["serving"] for k, v in knob_runs.items()},
             **{f"train_step text-cached {k}": v["step"] for k, v in knob_runs.items()},
             **{f"score_cli {k}": v for k, v in score_counts.items()},
             **rn50_counts, **long_counts, **fit_counts, **data_counts}
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": sum(c[name] for c in paths.values()),
                "launches_by_path": {k: c[name] for k, c in paths.items()},
                **results[name]} for name in ops.KERNELS]
    name, replaces, family = FACTORED
    factored = {k: c for k, c in paths.items() if "tf_impl=factored" in k}
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCES[family[0]][0], "replaces": replaces,
        "served_by": list(family),
        "launches": sum(c[f] for c in factored.values() for f in family),
        "launches_by_path": {k: {f: c[f] for f in family} for k, c in factored.items()},
        **results[family[0]],
        "max_abs_err": max(results[f]["max_abs_err"] for f in family)})
    if idle := [k["name"] for k in kernels
                if k["launches"] == 0 and k["name"] not in OFF_MAIN_PATH]:
        fail(f"kernels that no main-path run launched: {idle}")
    print(f"wall: the whole check {time.perf_counter() - started:.1f} s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
