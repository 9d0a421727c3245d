"""Data-parallel dry run: P ranks against the single-process step on the
global batch.

The port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` /
``dryrun_multihost``::

    python -m distillclip_tpu_torch.tools.dryrun --procs P [--device cpu]
        [--config configs/final/l_clip.yaml] [--teacher CKPT] [--pairs 256]
        [--steps 4] [--step text-cached|all-cached|live]

It spawns P processes (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets them; NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``).  Each builds the config's
task (its ``load_path`` dropped, the teacher ``--teacher``: by default a
seeded checkpoint of ViT-B/32's architecture written under ``build/dryrun/``)
from the same seed, in the config's compute dtype on the card and in fp32 on
the CPU (where the bounds below are met by float arithmetic), and runs
``--steps`` train steps on its rows of one seeded global batch of P ·
``--pairs`` pairs: uint8 images, token rows and, for the cached steps, the
teachers' representations.  Then the parent runs the same steps in one
process on the whole global batch.  Threads a process: torch's default
(``OMP_NUM_THREADS``).  It exits 1 unless

* every rank reports the same losses, and the masters are equal bit for bit
  across the ranks after the steps;
* the losses are within 1e-6 (relative), ``grad_norm`` within 1e-5 and the
  masters within ``--master-atol`` of the single-process run's.

``--batch`` (an ``.npz`` of ``tokens``, ``images``, ``tea_rep``,
``tea_img_rep``) and ``--init`` (masters by the port's names, ``torch.save``)
replace the seeded batch and masters; ``--out`` writes both runs' results
(``torch.save``: losses, gradient norms, the masters, the launches of the
last step).  The last line of the output is a JSON object of the results.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
LOSS_RTOL, NORM_RTOL = 1e-6, 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_teacher() -> str:
    """A seeded CLIP checkpoint of ViT-B/32's architecture, written once."""
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

    path = ROOT / "build" / "dryrun" / "clip_vit_b32_arch_seed0.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(make_clip_state_dict(
            vision_width=768, vision_layers=12, patch_size=32, image_resolution=224,
            text_width=512, text_layers=12, context_length=77, vocab_size=49408,
            embed_dim=512, seed=0), str(path))
    return str(path)


def _model_section(args) -> dict:
    from distillclip_tpu_torch.config import load_configs

    model = load_configs([args.config])["model"]
    init = dict(model["init_args"])
    init.update(teacher_name=args.teacher, load_path=None, log_grad_norm=True)
    if args.device == "cpu":
        init["compute_dtype"] = "float32"
    return {**model, "init_args": init}


def _student_args(model: dict, key: str) -> dict:
    init = model["init_args"]
    node = init.get(key) or init.get("student_encoder") or init.get("student")
    return node.get("init_args", {}) if isinstance(node, dict) else {}


def seeded_batch(model: dict, rows: int, seed: int) -> dict:
    """One global batch: token rows with the start and end ids (the end id is
    the vocabulary's largest, which the text towers pool at), uint8 images,
    and normal teacher representations of the students' output width."""
    text = _student_args(model, "text_student")
    image = _student_args(model, "image_student")
    ctx, vocab = text.get("context_length", 77), text.get("vocab_size", 49408)
    size, width = image.get("img_size", 224), image.get("out_dim", text.get("out_dim", 512))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab - 2, size=(rows, ctx), dtype=np.int64).astype(np.int32)
    tokens[:, 0] = vocab - 2
    for i, p in enumerate(rng.integers(2, ctx, size=rows)):
        tokens[i, p] = vocab - 1
        tokens[i, p + 1:] = 0
    return {"tokens": tokens,
            "images": rng.integers(0, 256, size=(rows, size, size, 3), dtype=np.uint8),
            "tea_rep": rng.normal(size=(rows, width)).astype(np.float32),
            "tea_img_rep": rng.normal(size=(rows, width)).astype(np.float32)}


def run_steps(model: dict, batch: dict, args, device, init: Optional[dict]) -> dict:
    """``args.steps`` steps of the task on ``batch`` (this process's rows):
    losses, gradient norms, the masters on the CPU, the last step's launches
    and its ms (host clock, fenced)."""
    from distillclip_tpu_torch import ops
    from distillclip_tpu_torch.config import instantiate
    from distillclip_tpu_torch.training.trainer import to_device

    task = instantiate(model)
    # one step an epoch: the schedule moves every step (the first has lr 0
    # under a warm-up)
    state, tx = task.init_state(SEED, 1, params=init, device=device)
    dual = hasattr(task, "image_student")
    if args.step == "live":
        kw = {}
    elif dual:
        kw = {"cached_teachers" if args.step == "all-cached" else "cached_text_teacher": True}
    else:
        kw = {"cached_teacher": True}
    step = task.make_train_step(tx, seed=SEED, **kw)
    b = to_device({k: torch.from_numpy(v) for k, v in batch.items()}, device)
    if dual:
        inputs = [b["tokens"], b["images"]] + {"live": [], "text-cached": [b["tea_rep"]],
                                               "all-cached": [b["tea_rep"], b["tea_img_rep"]]
                                               }[args.step]
    else:
        x = b["images"] if task.model_type == "image" else b["tokens"]
        inputs = [x] if args.step == "live" else [b["tea_rep"], x]
    losses, norms = [], []
    for i in range(args.steps):
        if i == args.steps - 1:
            ops.reset_launch_counts()
            sync(device)
            t0 = time.perf_counter()
        state, metrics = step(state, *inputs)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return {"losses": losses, "grad_norms": norms, "launches": ops.launch_counts(), "ms": ms,
            "masters": {k: v.detach().cpu() for k, v in state.params.items()}}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def child(args) -> int:
    """One rank: its rows of the global batch through the steps."""
    from distillclip_tpu_torch.parallel import (
        all_equal,
        initialize_distributed,
        local_rank,
        rank,
        world_size,
    )

    initialize_distributed(args.device, force=True)    # a group of one runs the collectives
    device = (torch.device("cuda", local_rank()) if args.device == "cuda"
              else torch.device(args.device))
    model = _model_section(args)
    batch = load_batch(args, model)
    r, w = rank(), world_size()
    rows = len(batch["tokens"]) // w
    mine = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
    init = torch.load(args.init, weights_only=True) if args.init else None
    res = run_steps(model, mine, args, device, init)
    flat = torch.cat([res["masters"][k].reshape(-1) for k in sorted(res["masters"])])
    res["masters_equal"] = all_equal(flat.to(device))
    if r != 0:
        res.pop("masters")
    torch.save(res, Path(args.work) / f"rank{r}.pt")
    return 0


def load_batch(args, model: dict) -> dict:
    if args.batch:
        with np.load(args.batch) as f:
            return {k: f[k] for k in f.files}
    return seeded_batch(model, args.procs * args.pairs, SEED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m distillclip_tpu_torch.tools.dryrun")
    p.add_argument("--procs", type=int, required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--config", default=str(ROOT / "configs" / "final" / "l_clip.yaml"))
    p.add_argument("--teacher", default=None, help="teacher checkpoint (default: seeded "
                   "ViT-B/32 architecture under build/dryrun/)")
    p.add_argument("--pairs", type=int, default=256, help="rows a rank")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--step", default="text-cached", choices=("text-cached", "all-cached", "live"))
    p.add_argument("--batch", default=None, help=".npz global batch")
    p.add_argument("--init", default=None, help="initial masters (torch.save)")
    p.add_argument("--out", default=None, help="write both runs' results (torch.save)")
    p.add_argument("--master-atol", type=float, default=1e-6)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds a rank may take")
    p.add_argument("--work", default=None, help=argparse.SUPPRESS)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.teacher is None:
        args.teacher = default_teacher()
    if args.child:
        return child(args)
    if args.device == "cuda" and torch.cuda.device_count() < args.procs:
        raise SystemExit(f"dryrun: {args.procs} ranks on CUDA need {args.procs} devices, "
                         f"have {torch.cuda.device_count()}")

    work = Path(args.work or ROOT / "build" / "dryrun" / f"run{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    port = free_port()
    cmd = [sys.executable, "-m", "distillclip_tpu_torch.tools.dryrun", "--child",
           "--work", str(work)] + [a for a in (argv if argv is not None else sys.argv[1:])
                                   if a != "--child"]
    if "--teacher" not in cmd:
        cmd += ["--teacher", args.teacher]
    procs = []
    for r in range(args.procs):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(args.procs), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    failed = False
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, failed = proc.communicate()[0], True
        if proc.returncode != 0:
            failed = True
            print(f"dryrun: rank {r} rc {proc.returncode}:\n{out[-4000:]}", flush=True)
    if failed:
        return 1
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(args.procs)]

    model = _model_section(args)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    init = torch.load(args.init, weights_only=True) if args.init else None
    single = run_steps(model, load_batch(args, model), args, device, init)

    same_losses = all(r["losses"] == ranks[0]["losses"] for r in ranks)
    masters_equal = all(r["masters_equal"] for r in ranks)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(ranks[0]["losses"], single["losses"]))
    norm_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(ranks[0]["grad_norms"], single["grad_norms"]))
    master_diff = max(float((ranks[0]["masters"][k] - v).abs().max())
                      for k, v in single["masters"].items())
    ok = (same_losses and masters_equal and loss_rel <= LOSS_RTOL
          and norm_rel <= NORM_RTOL and master_diff <= args.master_atol)
    for r, res in enumerate(ranks):
        print(f"dryrun: rank {r} of {args.procs} ({args.device}) losses {res['losses']} "
              f"grad_norms {res['grad_norms']} ({res['ms']:.2f} ms the last step)", flush=True)
    print(f"dryrun: single process on the global batch of {len(load_batch(args, model)['tokens'])} "
          f"rows: losses {single['losses']} grad_norms {single['grad_norms']} "
          f"({single['ms']:.2f} ms the last step)", flush=True)
    print(f"dryrun: world {args.procs}, step {args.step}: every rank the same losses "
          f"{same_losses}, masters bitwise equal across ranks {masters_equal}; against the "
          f"single process: loss rel diff {loss_rel:.3e} (limit {LOSS_RTOL:g}), grad_norm "
          f"rel diff {norm_rel:.3e} (limit {NORM_RTOL:g}), max |master diff| "
          f"{master_diff:.3e} (limit "
          f"{args.master_atol:g}): {'OK' if ok else 'MISMATCH'}", flush=True)
    if args.out:
        torch.save({"ranks": ranks, "single": single}, args.out)
    print(json.dumps({"ok": ok, "world": args.procs, "device": args.device, "step": args.step,
                      "losses": [r["losses"] for r in ranks], "single_losses": single["losses"],
                      "same_losses": same_losses, "masters_equal": masters_equal,
                      "loss_rel_diff": loss_rel, "grad_norm_rel_diff": norm_rel,
                      "max_master_diff": master_diff, "launches": ranks[0]["launches"],
                      "ms": ranks[0]["ms"], "single_ms": single["ms"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
