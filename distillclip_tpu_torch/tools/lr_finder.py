"""LR range test (Lightning's ``auto_lr_find``).

Port of ``distillclip_tpu/tools/lr_finder.py``: sweep the learning rate
exponentially from ``min_lr`` to ``max_lr`` over ``num_steps`` train steps of
the task's live step, record the loss, stop once it diverges (not finite, or
above ``early_stop_threshold`` times the best), and suggest the rate at the
steepest descent of the smoothed curve.  The sweep is the optimizer's
schedule: AdamW with the task's weight decay and clipping.

CLI: ``distillclip-torch lr_find -c config.yaml [--min-lr --max-lr --steps]``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np


def exponential_sweep(min_lr: float, max_lr: float, num_steps: int):
    """lr(step) = min_lr * (max_lr/min_lr) ** (step / (num_steps - 1)), in
    float32 as the JAX package computes it."""
    f32 = np.float32
    ratio = f32(max_lr / min_lr)

    def schedule(count) -> float:
        frac = f32(min(count, num_steps - 1)) / f32(max(num_steps - 1, 1))
        return float(f32(min_lr) * ratio ** frac)

    return schedule


def suggest_from_history(lrs, losses, skip_begin: int = 10, skip_end: int = 1,
                         smooth: float = 0.05) -> Optional[float]:
    """Lightning's suggestion rule: lr at the minimum gradient of the
    EWMA-smoothed loss, ignoring the sweep's edges."""
    # drop non-finite tail entries (diverged sweep): NaN would propagate
    # through the EWMA/gradient and argmin would land AT the divergence lr
    finite = [(lr, l) for lr, l in zip(lrs, losses) if math.isfinite(l)]
    if not finite:
        return None
    lrs, losses = zip(*finite)
    if len(losses) < skip_begin + skip_end + 2:
        skip_begin, skip_end = 1, 1
    if len(losses) < skip_begin + skip_end + 2:
        return None
    smoothed = []
    avg = 0.0
    for i, l in enumerate(losses):
        avg = smooth * l + (1 - smooth) * avg
        smoothed.append(avg / (1 - (1 - smooth) ** (i + 1)))  # bias-corrected
    seg = np.array(smoothed[skip_begin: len(smoothed) - skip_end])
    if len(seg) < 2:
        return None
    idx = int(np.argmin(np.gradient(seg))) + skip_begin
    return float(lrs[idx])


def lr_find(task, datamodule, min_lr: float = 1e-7, max_lr: float = 1.0,
            num_steps: int = 100, seed: int = 2022, early_stop_threshold: float = 4.0,
            device: str = "cuda") -> Dict[str, Any]:
    """Run the range test on ``device``; returns {suggestion, lrs, losses,
    diverged_at}."""
    from distillclip_tpu_torch.training.train_state import make_optimizer
    from distillclip_tpu_torch.training.trainer import fit_loaders, run_device, to_device

    device = run_device(device)
    train_loader, _ = fit_loaders(datamodule, device)
    dual = hasattr(task, "image_student")

    state, _ = task.init_state(seed, num_steps, device=device)
    sched = exponential_sweep(min_lr, max_lr, num_steps)
    sweep_tx = make_optimizer(sched, weight_decay=task.weight_decay,
                              grad_clip_norm=task.grad_clip_norm)
    state.opt_state = sweep_tx.init(state.params)
    step_fn = task.make_train_step(sweep_tx, seed=seed)

    lrs, losses = [], []
    best = math.inf
    diverged_at = None
    step = 0
    while step < num_steps:
        for batch in train_loader:
            if step >= num_steps:
                break
            batch = to_device(batch, device)
            if dual:
                state, metrics = step_fn(state, batch["tokens"], batch["images"])
            else:
                state, metrics = step_fn(state, batch["inputs"])
            loss = metrics["loss"].item()
            lrs.append(sched(step))
            losses.append(loss)
            step += 1
            if math.isfinite(loss):
                best = min(best, loss)
            if not math.isfinite(loss) or (
                    early_stop_threshold and loss > early_stop_threshold * best):
                diverged_at = lrs[-1]
                step = num_steps  # past the useful range (Lightning's rule)
                break
        else:
            # single-shot loaders: a fresh pass
            train_loader = datamodule.train_dataloader()

    return {"suggestion": suggest_from_history(lrs, losses), "lrs": lrs, "losses": losses,
            "diverged_at": diverged_at}
