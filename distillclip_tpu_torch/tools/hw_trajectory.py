"""Multi-step training-trajectory agreement: the card against the CPU.

A kernel can be right on one call and wrong in training: the JAX package's
round-4 hazard (a write-after-read mis-schedule) showed only at larger
shapes, in a causal tower, as silently wrong training on the chip while the
CPU stayed right.  The class of fault is therefore "training on the card
diverges from training on the CPU".  This tool runs the same seeded
trajectory (the same fabricated teacher, init and fixed batches; the
reference's hot loop is distil_model.py:97) for N steps on the card and on
the CPU (the kernels' plain PyTorch versions) and holds the loss curves to
each other:

    python -m distillclip_tpu_torch.tools.hw_trajectory              # all legs
    python -m distillclip_tpu_torch.tools.hw_trajectory --device cpu --dump c.json
    python -m distillclip_tpu_torch.tools.hw_trajectory --compare dev.json c.json shadow.json

The workload is the JAX tool's: a 64-wide text student of 2 x 2 blocks with
head mixes, the live causal CLIP text teacher with per-layer taps
(``attention_score_mse`` and ``hidden_rep_mse`` on top of ``out_l1``), 16
seeded token rows a step, bf16 compute, and a real learning rate (3e-3, no
warm-up) so that the updates compound.  bf16 accumulation differs between
the card and the CPU and Adam amplifies the difference, so the verdict is a
self-calibrating envelope (:func:`compare`): a tight window before the
differences compound, a shadow envelope calibrated by a perturbed CPU leg,
and agreement at the end.

Run it after any kernel or step change, before trusting a training run on the
card.  The default run takes the card leg in this process and the CPU and
shadow legs in subprocesses (``--device cpu``) that run beside it; it exits 1
on disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# the JAX tool's defaults: every row-blocked kernel runs more than one block
STEPS = 50
BATCH = 16
ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / ".cache"


def run_trajectory(steps: int = STEPS, batch: int = BATCH, seed: int = 2022,
                   perturb: float = 0.0, device: str = "cuda"):
    """One seeded text-distill trajectory on ``device``; returns the losses
    of every step.

    ``perturb`` multiplies every initial parameter by (1 + perturb * n) with
    seeded unit normals n: the shadow leg, which measures how fast this
    trajectory amplifies bf16-scale differences (see :func:`compare`)."""
    import numpy as np
    import torch

    from distillclip_tpu_torch.models import RepeatTextTransformer
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict
    from distillclip_tpu_torch.training import DistillTask

    CACHE.mkdir(parents=True, exist_ok=True)
    teacher = CACHE / "traj_clip.pt"
    if not teacher.exists():
        torch.save(make_clip_state_dict(), str(teacher))

    task = DistillTask(
        student=RepeatTextTransformer(vocab_size=49408, context_length=77, out_dim=48,
                                      embed_dim=64, depth=2, num_heads=4, repeated_times=2,
                                      use_transform=True),
        # the taps make the teacher's text tower (causal) and the student's
        # attention run their instrumented paths
        loss_control_para={"loss_name": ["out_l1", "attention_score_mse", "hidden_rep_mse"]},
        teacher_name=str(teacher), download_root=str(CACHE), model_type="text",
        teacher_need_layers=[0, 1],
        # warm_steps=0: the schedule steps per epoch and the trajectory is ten
        # 5-step epochs of a real cosine lr; a warm-up would pin epoch 0's lr
        # at 0, and agreement must compare compounding updates
        lr=3e-3, warm_steps=0, total_steps=10)
    data = np.random.default_rng(seed)
    tokens = data.integers(1, 49407, size=(steps, batch, 77)).astype(np.int64)
    tokens[:, :, 0] = 49406
    tokens[:, :, -1] = 49407

    params = None
    if perturb:
        params = task.init_params(seed, "cpu")
        prng = np.random.default_rng(seed + 7)
        params = {k: v * torch.from_numpy(
            (1.0 + perturb * prng.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in params.items()}
    state, tx = task.init_state(seed, steps_per_epoch=5, params=params, device=device)
    step = task.make_train_step(tx)
    losses = []
    for i in range(steps):
        state, metrics = step(state, torch.from_numpy(tokens[i]).to(device))
        # a readback every step: the computed trajectory, not a queue of launches
        losses.append(float(metrics["loss"]))
    return losses


def _rel_curve(a, b):
    if len(a) != len(b):
        raise ValueError(f"curve lengths differ: {len(a)} vs {len(b)}")
    return [abs(x - y) / max(abs(x), abs(y), 1e-9) for x, y in zip(a, b)]


def compare(dev, cpu, shadow=None, early_tol: float = 0.01,
            early_steps: int = 3, margin: float = 4.0, floor: float = 0.02):
    """Trajectory-agreement verdict with a self-calibrating envelope.

    An Adam trajectory is chaotic: any bf16-scale difference (the card's
    accumulation order against the CPU's) grows step over step, so a fixed
    per-step tolerance either flakes late or is too loose early.  Three
    checks instead:

    1. EARLY WINDOW (before compounding): the first ``early_steps`` losses
       must agree within ``early_tol``: wrong forward or backward math shows
       at once (the round-4 hazard corrupted step-0 outputs at O(1) relative
       error), while accumulation drift has not compounded yet.
    2. SHADOW ENVELOPE: the CPU leg re-run with a 1e-3 init perturbation
       measures how fast THIS trajectory amplifies small differences; the
       card-vs-CPU divergence must stay within ``margin`` x the shadow
       divergence (cumulative max, per step), floored at ``floor``.
    3. ENDPOINT: final losses within ``floor`` x margin relative: both runs
       must land in the same basin.
    """
    rel_dc = _rel_curve(dev, cpu)
    early = max(rel_dc[:early_steps])
    checks = {"early_max_rel": early, "early_ok": early <= early_tol}
    if shadow is not None:
        rel_sh = _rel_curve(cpu, shadow)
        cum_dev, cum_sh = 0.0, 0.0
        envelope_ok = True
        worst_ratio_step = 0
        for i, (rd, rs) in enumerate(zip(rel_dc, rel_sh)):
            cum_dev = max(cum_dev, rd)
            cum_sh = max(cum_sh, rs)
            allowed = max(floor, margin * cum_sh)
            if cum_dev > allowed:
                envelope_ok = False
                worst_ratio_step = i
                break
        checks.update({
            "envelope_ok": envelope_ok,
            "max_rel_dev_vs_cpu": max(rel_dc),
            "max_rel_cpu_vs_shadow": max(rel_sh),
            "envelope_broken_at": None if envelope_ok else worst_ratio_step,
        })
    final_rel = rel_dc[-1]
    checks["final_rel"] = final_rel
    checks["final_ok"] = final_rel <= margin * floor
    ok = checks["early_ok"] and checks["final_ok"] and checks.get(
        "envelope_ok", True)
    return {"ok": ok, "steps": len(dev), **{
        k: (round(v, 6) if isinstance(v, float) else v)
        for k, v in checks.items()
    }}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seed", type=int, default=2022)
    ap.add_argument("--device", default="cuda",
                    help="the leg's device; the default run's legs are cuda and cpu")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="init-param relative perturbation (shadow leg)")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="write this leg's losses to PATH and exit")
    ap.add_argument("--compare", nargs="+", default=None, metavar="CURVE",
                    help="compare dumped curves (dev cpu [shadow]) instead of running")
    args = ap.parse_args(argv)

    if args.compare:
        curves = []
        for path in args.compare:
            with open(path) as f:
                curves.append(json.load(f)["losses"])
        verdict = compare(curves[0], curves[1], curves[2] if len(curves) > 2 else None)
        print(json.dumps(verdict))
        return 0 if verdict["ok"] else 1

    if args.dump:
        losses = run_trajectory(args.steps, args.batch, args.seed, args.perturb, args.device)
        with open(args.dump, "w") as f:
            json.dump({"device": args.device, "perturb": args.perturb, "losses": losses}, f)
        print(f"{args.device} (perturb={args.perturb}): {args.steps} steps, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}", file=sys.stderr)
        return 0

    # the CPU leg and its perturbed shadow in subprocesses, started first and
    # run while this process takes the device leg
    CACHE.mkdir(parents=True, exist_ok=True)
    # the host's cores shared out, so that the legs do not oversubscribe them
    share = max(1, (os.cpu_count() or 2) // (3 if args.device == "cpu" else 2))
    if args.device == "cpu":
        import torch

        torch.set_num_threads(share)
    env = {**os.environ, "OMP_NUM_THREADS": str(share)}
    legs = {}
    for name, perturb in (("cpu", 0.0), ("shadow", 1e-3)):
        dump = CACHE / f"traj_{name}.json"
        dump.unlink(missing_ok=True)
        legs[name] = dump, subprocess.Popen(
            [sys.executable, "-m", "distillclip_tpu_torch.tools.hw_trajectory",
             "--device", "cpu", "--dump", str(dump), "--steps", str(args.steps),
             "--batch", str(args.batch), "--seed", str(args.seed), "--perturb", str(perturb)],
            cwd=ROOT, env=env)
    try:
        losses_dev = run_trajectory(args.steps, args.batch, args.seed, device=args.device)
    finally:
        codes = {name: proc.wait() for name, (_, proc) in legs.items()}
    print(f"{args.device}: loss {losses_dev[0]:.4f} -> {losses_dev[-1]:.4f}", file=sys.stderr)
    curves = {}
    for name, (dump, _) in legs.items():
        if codes[name]:
            print(f"{name} leg failed", file=sys.stderr)
            return 2
        with open(dump) as f:
            curves[name] = json.load(f)["losses"]
    verdict = compare(losses_dev, curves["cpu"], curves["shadow"])
    verdict["device"] = args.device
    verdict["loss_first_last"] = [losses_dev[0], losses_dev[-1]]
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
