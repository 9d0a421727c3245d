"""Trainer: epoch loop, validation, checkpointing, early stopping.

Port of ``distillclip_tpu/training/trainer.py``, one process a device:

* the epoch loop over the task's train step, chosen from the first batch
  (``tea_rep`` in the batch: the cached-text step of stage 3 or the cached
  step of stages 1/2; ``tea_img_rep`` too: the all-cached step);
* validation every ``check_val_every_n_epoch`` with the task's eval step (the
  live teacher, whichever step trains) and, at the epoch's end, retrieval over
  the whole validation corpus from the gathered representations, in fp32 on
  the host;
* the teacher's retrieval baseline at the first epoch of a run only;
* two-metric top-k checkpoints plus ``last`` (``CheckpointManager``), resume
  from a checkpoint at the epoch after it, an autosave every
  ``save_every_n_steps``;
* early stopping on a monitored value, ``unfreeze_epoch`` (the train step
  rebuilt unmasked), the logged learning rate read from the optimizer's
  schedule, a provisional schedule length for loaders without ``__len__``.

The host reads the device once per logged step (every logged scalar in one
stacked copy) and once per epoch (the last loss, which fences the epoch's
time), never per step.  Batches reach the device through :func:`to_device`:
pinned host memory, then a non-blocking copy; uint8 images and integer
tokens cross as they are and the tasks normalise them on the device.  A
datamodule with ``prestage_device`` keeps its items on the device instead
(:func:`fit_loaders`).

Under data parallelism (``torchrun``: ``parallel.distributed``, the sum
rule) every process runs the loop on its shard of each epoch and the steps
see the global batch, with the JAX trainer's rank-zero semantics: the first
rank alone prepares the data (the others wait for it, however long it takes:
``parallel.on_first_rank``), logs, profiles and writes checkpoints; every
rank restores a checkpoint; ``hparams.json`` records the world size, and
``perf/items_per_s`` counts the global batch.  The caller joins the
launcher's process group first (``parallel.initialize_distributed``; the CLI
does); a ``WORLD_SIZE`` > 1 without one is an error.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from distillclip_tpu_torch.data.datamodule import DevicePrestagedLoader
from distillclip_tpu_torch.parallel import is_main, on_first_rank, process_device, world_size
from distillclip_tpu_torch.training import metrics as M
from distillclip_tpu_torch.training.checkpoints import (
    CheckpointManager,
    restore_state,
    save_pytree,
    state_tree,
)
from distillclip_tpu_torch.training.logging import MetricLogger, NullLogger
from distillclip_tpu_torch.training.profiling import build_profiler
from distillclip_tpu_torch.training.schedules import hf_cosine_with_warmup


def run_device(name) -> torch.device:
    """``name`` as this process's device (``cuda`` is ``cuda:LOCAL_RANK``
    under data parallelism); a CUDA device where there is none is an error,
    never a quiet fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return process_device(device)


def to_device(batch, device):
    """A batch (nested dicts of numpy arrays or tensors; other leaves, such as
    lists of strings, pass through) on ``device``.  To a card, host arrays go
    through pinned memory and a non-blocking copy; dtypes are kept.  The
    pinning is a host copy on the caller's thread, which the step waits
    for; only the transfer itself runs while the host queues the step."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        if pin and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(device, non_blocking=pin)

    return move(batch)


def fit_loaders(datamodule, device):
    """(train loader, validation loader) of ``datamodule``, prepared and set
    up for fitting.  The one place that gives the data the run's device: the
    teacher's pre-encoding in ``prepare`` runs there (on the first rank; the
    others wait), and a datamodule with ``prestage_device`` keeps its training
    items there (:class:`DevicePrestagedLoader`)."""
    on_first_rank(lambda: datamodule.prepare_data(device))
    datamodule.setup("fit")
    train = datamodule.train_dataloader()
    if getattr(datamodule, "prestage_device", False):
        train = DevicePrestagedLoader(train, device)
    return train, datamodule.val_dataloader()


def _batch_size(batch) -> int:
    while isinstance(batch, dict):
        batch = batch[sorted(batch)[0]]
    return len(batch)


def _epoch_end_retrieval(reps_list: List[Dict[str, np.ndarray]], dual: bool):
    """(student metrics, teacher baseline metrics, student logits): retrieval
    over every validation batch's representations, in fp32 on the host."""
    cat = lambda key: np.concatenate([np.asarray(r[key]) for r in reps_list], axis=0)
    acc = lambda logits: M.topk_accuracy(torch.from_numpy(np.asarray(logits))).items()
    out: Dict[str, float] = {}
    if dual:
        stu_img, stu_txt = cat("stu_image_outs"), cat("stu_text_outs")
        tea_img, tea_txt = cat("tea_image_outs"), cat("tea_text_outs")
        norm = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
        stu_logits = norm(stu_img) @ norm(stu_txt).T
        tea_logits = norm(tea_img) @ norm(tea_txt).T
        sit = norm(stu_img) @ norm(tea_txt).T
        sti = norm(tea_img) @ norm(stu_txt).T
        for k, v in acc(stu_logits):
            out[f"val_stu_acc/stu_acc_top{k}"] = float(v)
        for k, v in acc(sit):
            out[f"val_stu_image_tea_text/stu_image_tea_text_top{k}"] = float(v)
        for k, v in acc(sti):
            out[f"val_stu_text_tea_image/stu_text_tea_image_top{k}"] = float(v)
        tea = {f"val_tea_acc/tea_acc_top{k}": float(v) for k, v in acc(tea_logits)}
        return out, tea, stu_logits
    stu_logits, tea_logits = M.norm_and_logits(
        torch.from_numpy(cat("contrary_rep")), torch.from_numpy(cat("student")),
        torch.from_numpy(cat("teacher")))[:2]
    for k, v in M.topk_accuracy(stu_logits).items():
        out[f"val_stu_acc/stu_acc_top{k}"] = float(v)
    mean_score, softmax_score = M.diag_scores(stu_logits)
    out["val_stu_score/stu_mean_score"] = float(mean_score)
    out["val_stu_score/stu_softmax_mean_score"] = float(softmax_score)
    tea_out = {f"val_tea_acc/tea_acc_top{k}": float(v)
               for k, v in M.topk_accuracy(tea_logits).items()}
    ms, ss = M.diag_scores(tea_logits)
    tea_out["val_tea_score/tea_mean_score"] = float(ms)
    tea_out["val_tea_score/tea_softmax_mean_score"] = float(ss)
    return out, tea_out, stu_logits.numpy()


@dataclasses.dataclass
class EarlyStopper:
    """Stop when the monitored value has not improved for ``patience``
    updates: ``mode='min'`` for losses, ``'max'`` for accuracies."""

    patience: int
    mode: str = "min"
    best: float = float("inf")
    count: int = 0

    def update(self, value: float) -> bool:
        """Record one monitored value; True when training should stop."""
        signed = value if self.mode == "min" else -value
        if signed < self.best - 1e-12:
            self.best, self.count = signed, 0
            return False
        self.count += 1
        return self.count >= self.patience


def _validation_pass(eval_step, state, val_loader, dual: bool, device,
                     limit: Optional[int]):
    """({metric: per-batch values}, per-batch representations on the host):
    one readback of the stacked scalars and one of the representations per
    batch."""
    acc: Dict[str, list] = {}
    reps_list = []
    for i, batch in enumerate(val_loader):
        if limit and i >= limit:
            break
        batch = to_device(batch, device)
        if dual:
            metrics, reps = eval_step(state, batch["tokens"], batch["images"])
        else:
            metrics, reps = eval_step(state, batch["inputs"], batch["contrary"])
        keys = list(metrics)
        for k, v in zip(keys, torch.stack([metrics[k].float() for k in keys]).cpu().tolist()):
            acc.setdefault(k, []).append(v)
        reps_list.append({k: v.cpu().numpy() for k, v in reps.items()})
    return acc, reps_list


@dataclasses.dataclass
class Trainer:
    max_epochs: int = 200
    check_val_every_n_epoch: int = 1
    log_every_n_steps: int = 100
    result_dir: str = "./result"
    run_name: str = "run"
    seed: int = 2022
    early_stopping_monitor: Optional[str] = "val_loss/loss"
    early_stopping_patience: Optional[int] = None
    early_stopping_mode: str = "min"  # 'min' (losses) | 'max' (accuracies)
    deterministic_forward: bool = True
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    profiler: Optional[str] = None  # None | 'simple' | 'trace'
    save_every_n_steps: Optional[int] = None
    accumulate_grad_batches: Optional[int] = None
    device: str = "cuda"

    def fit(self, task, datamodule, ckpt_path: Optional[str] = None) -> Dict[str, Any]:
        device = run_device(self.device)
        run_dir = f"{self.result_dir}/{self.run_name}"
        logger = MetricLogger(self.result_dir, self.run_name) if is_main() else NullLogger()
        ckpts = CheckpointManager(f"{run_dir}/checkpoints")
        prof = build_profiler(self.profiler if is_main() else None, run_dir)

        train_loader, val_loader = fit_loaders(datamodule, device)
        # schedule length: the loader's, else the datamodule's declared one;
        # unknown -> a provisional 100, recalibrated after the first epoch
        steps_per_epoch = None
        if hasattr(train_loader, "__len__"):
            steps_per_epoch = len(train_loader)
        elif hasattr(datamodule, "steps_per_epoch"):
            steps_per_epoch = datamodule.steps_per_epoch()
        schedule_provisional = steps_per_epoch is None
        if schedule_provisional:
            steps_per_epoch = 100
        if self.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, self.limit_train_batches)
            schedule_provisional = False

        dual = hasattr(task, "image_student")
        if self.accumulate_grad_batches and self.accumulate_grad_batches > 1:
            task.accumulate_grad_batches = int(self.accumulate_grad_batches)

        sample = next(iter(train_loader))
        cached_teacher = "tea_rep" in sample
        all_cached = dual and cached_teacher and "tea_img_rep" in sample
        del sample
        state, tx = task.init_state(self.seed, steps_per_epoch, device=device)
        start_epoch = restore_state(ckpt_path, state) + 1 if ckpt_path else 0
        host_step = state.step

        groups: Dict[str, int] = {}
        for name, v in state.params.items():
            top = name.split(".", 1)[0]
            groups[top] = groups.get(top, 0) + v.numel()
        param_summary = {f"params/{k}": n for k, n in sorted(groups.items())}
        param_summary["params/total"] = sum(groups.values())
        trainable_mask = getattr(task, "_mask", None)
        if trainable_mask is not None:
            param_summary["params/trainable"] = sum(
                v.numel() for k, v in state.params.items() if trainable_mask[k])
        logger.log_hyperparams({
            "task": type(task).__name__, "loss": task.loss_control_para, "lr": task.lr,
            "weight_decay": task.weight_decay, "max_epochs": self.max_epochs,
            "steps_per_epoch": steps_per_epoch, "devices": world_size(), **param_summary})

        def build_train_step(tx_, trainable_mask=None):
            kw = {}
            if all_cached:
                kw["cached_teachers"] = True
            elif cached_teacher:
                kw["cached_text_teacher" if dual else "cached_teacher"] = True
            return task.make_train_step(tx_, deterministic=self.deterministic_forward,
                                        trainable_mask=trainable_mask, seed=self.seed, **kw)

        def run_train_step(state, batch):
            if dual:
                extra = ([batch["tea_rep"], batch["tea_img_rep"]] if all_cached
                         else [batch["tea_rep"]] if cached_teacher else [])
                return train_step(state, batch["tokens"], batch["images"], *extra)
            if cached_teacher:
                return train_step(state, batch["tea_rep"], batch["inputs"])
            return train_step(state, batch["inputs"])

        train_step = build_train_step(tx)
        eval_step = task.make_eval_step()
        unfrozen = False

        def current_lr(step: int, epoch: int) -> float:
            sched = getattr(task, "_lr_schedule", None)
            if sched is not None:
                # the schedule counts optimizer updates, the step micro-batches
                k = max(1, int(getattr(task, "accumulate_grad_batches", 1) or 1))
                return float(sched(step // k))
            return float(hf_cosine_with_warmup(task.lr, task.warm_steps,
                                               task.total_steps)(epoch))

        stopper = EarlyStopper(patience=self.early_stopping_patience or 0,
                               mode=self.early_stopping_mode)
        stop = False
        for epoch in range(start_epoch, self.max_epochs):
            if not unfrozen and task.unfreeze_epoch and epoch >= task.unfreeze_epoch:
                train_step = build_train_step(tx, trainable_mask=False)
                unfrozen = True

            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            elif not hasattr(train_loader, "__len__"):
                # single-shot (generator) loaders: a fresh iterator per epoch
                try:
                    train_loader = datamodule.train_dataloader(epoch=epoch)
                except TypeError:
                    train_loader = datamodule.train_dataloader()

            t_epoch = time.time()
            n_items = 0
            t_wait = 0.0  # time spent waiting on the host input pipeline
            it = iter(train_loader)
            i = -1
            while True:
                i += 1
                t0 = time.perf_counter()
                batch = next(it, None)
                t_wait += time.perf_counter() - t0
                if batch is None:
                    break
                if self.limit_train_batches and i >= self.limit_train_batches:
                    break
                prof.maybe_start()
                with prof.profile("host_to_device"):
                    batch = to_device(batch, device)
                with prof.profile("train_step"):
                    state, metrics = run_train_step(state, batch)
                prof.step()
                host_step += 1
                n_items += _batch_size(batch) * world_size()
                if self.save_every_n_steps and host_step % self.save_every_n_steps == 0 \
                        and is_main():
                    save_pytree(f"{run_dir}/checkpoints/autosave",
                                {"state": state_tree(state), "epoch": epoch})
                if i % self.log_every_n_steps == 0:
                    keys = list(metrics)
                    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
                    logged = {f"train_loss/{k}": v for k, v in zip(keys, vals)}
                    logged["epoch"] = epoch
                    logged["lr"] = current_lr(host_step, epoch)
                    logger.log_metrics(logged, host_step)
            if n_items:
                metrics["loss"].item()   # fences the epoch's time
            epoch_time = time.time() - t_epoch
            # a loader of unknown length: the first epoch's count replaces the
            # provisional schedule length (AdamW's state does not depend on it)
            if schedule_provisional and epoch == start_epoch and i > 0:
                if i != steps_per_epoch:
                    steps_per_epoch = i
                    tx = task.make_optimizer(steps_per_epoch)
                    train_step = build_train_step(tx, trainable_mask=False if unfrozen else None)
                    logger.log_metrics({"perf/steps_per_epoch_recalibrated": i}, host_step)
                schedule_provisional = False
            logger.log_metrics({
                "perf/epoch_time_s": epoch_time,
                "perf/items_per_s": n_items / max(epoch_time, 1e-9),
                "perf/input_stall_frac": t_wait / max(epoch_time, 1e-9),
            }, host_step)

            # --- validation ---
            if (epoch + 1) % self.check_val_every_n_epoch and epoch != self.max_epochs - 1:
                continue
            if not hasattr(val_loader, "__len__"):
                val_loader = datamodule.val_dataloader()  # a fresh generator
            val_acc, reps_list = _validation_pass(eval_step, state, val_loader, dual, device,
                                                  self.limit_val_batches)
            if not reps_list:
                continue
            val_logged = {
                f"val_loss/{k}" if "acc" not in k and "score" not in k else f"val_step/{k}":
                    float(np.mean(v)) for k, v in val_acc.items()}
            epoch_metrics, tea_metrics, _ = _epoch_end_retrieval(reps_list, dual)
            val_logged.update(epoch_metrics)
            if epoch == start_epoch:  # the teacher's baseline, once a run
                val_logged.update(tea_metrics)
            val_logged["epoch"] = epoch
            logger.log_metrics(val_logged, host_step)

            # --- checkpoint: a missing metric does not compete ---
            ckpts.save_epoch(epoch, {"state": state_tree(state), "epoch": epoch},
                             {"stu_acc_top1": val_logged.get("val_stu_acc/stu_acc_top1"),
                              "loss": val_logged.get("val_loss/loss")})

            if self.early_stopping_patience and self.early_stopping_monitor:
                monitored = val_logged.get(self.early_stopping_monitor)
                if monitored is None:
                    monitored = val_logged.get("val_loss/loss")
                if monitored is not None:
                    stop = stopper.update(monitored)
            if stop:
                break

        prof.write()
        logger.close()
        return {"state": state, "summary": logger.summary, "checkpoints": ckpts}

    def validate(self, task, datamodule, state) -> Dict[str, float]:
        """The validation pass and the full-corpus retrieval, teacher
        baseline included, for ``state``."""
        device = run_device(self.device)
        _, val_loader = fit_loaders(datamodule, device)
        dual = hasattr(task, "image_student")
        val_acc, reps_list = _validation_pass(task.make_eval_step(), state, val_loader, dual,
                                              device, self.limit_val_batches)
        out = {k: float(np.mean(v)) for k, v in val_acc.items()}
        if reps_list:
            epoch_metrics, tea_metrics, _ = _epoch_end_retrieval(reps_list, dual)
            out.update(epoch_metrics)
            out.update(tea_metrics)
        return out
