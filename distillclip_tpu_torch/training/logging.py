"""Metric logging: pluggable writers (JSONL, TensorBoard, offline W&B).

Port of ``distillclip_tpu/training/logging.py`` (framework-free, so a copy).
``MetricLogger`` fans every record out to its writers:

* :class:`JsonlWriter`: ``metrics.jsonl`` and ``hparams.json``, always on;
* :class:`TensorBoardWriter`: attached when tensorboardX is importable;
* :class:`WandbWriter`: W&B in ``offline`` mode (the run is written under
  ``wandb/`` for a later ``wandb sync``), attached when the wandb package is
  importable and ``DISTILLCLIP_WANDB`` is set (``offline`` / ``1``;
  ``online`` only where the machine has egress).

The headline accuracies (``MAX_SUMMARY_KEYS``) keep a running maximum in the
process, which ``Trainer.fit`` returns as its summary.  Under data
parallelism the ranks after the first log to a :class:`NullLogger`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

MAX_SUMMARY_KEYS = (
    "val_stu_acc/stu_acc_top1",
    "val_stu_acc/stu_acc_top10",
    "val_stu_acc/stu_acc_top50",
)


class JsonlWriter:
    """Append-only metrics.jsonl + hparams.json — the primary record."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_hyperparams(self, params: Dict[str, Any]):
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def log_metrics(self, record: Dict[str, float], step: int):
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class TensorBoardWriter:
    """tensorboardX scalars (reference TensorBoardLogger, image.yaml:80-82)."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter  # ImportError gates attach

        self._tb = SummaryWriter(logdir=os.path.join(log_dir, "tb"))

    def log_hyperparams(self, params: Dict[str, Any]):
        pass

    def log_metrics(self, record: Dict[str, float], step: int):
        for k, v in record.items():
            if k in ("step", "time"):
                continue
            self._tb.add_scalar(k, v, step)

    def close(self):
        self._tb.close()


class WandbWriter:
    """W&B writer, offline by default (reference distil_model.py:70-79).

    ``mode='offline'`` writes the full W&B run format to local files — the
    zero-egress equivalent of the reference's logger; ``wandb sync`` uploads
    later.  ``define_metric(summary='max')`` is applied to the headline
    accuracy metrics exactly as the reference does.
    """

    def __init__(self, log_dir: str, name: str = "run", mode: str = "offline"):
        import wandb  # ImportError gates attach

        self._run = wandb.init(
            project=os.environ.get("DISTILLCLIP_WANDB_PROJECT", "distillclip_tpu_torch"),
            name=name,
            dir=log_dir,
            mode=mode,
        )
        for key in MAX_SUMMARY_KEYS:
            try:
                self._run.define_metric(key, summary="max")
            except Exception:
                pass  # older wandb without define_metric
        self.log_code()

    def log_code(self):
        """Snapshot the framework source into the run
        (reference distil_model.py:74 / dual_distill_model.py:96
        ``logger.experiment.log_code()``)."""
        try:
            import distillclip_tpu_torch

            root = os.path.dirname(os.path.abspath(distillclip_tpu_torch.__file__))
            self._run.log_code(root=root)
        except Exception:
            pass  # code capture is best-effort (older wandb / no source dir)

    def log_hyperparams(self, params: Dict[str, Any]):
        self._run.config.update(
            {k: str(v) if not isinstance(v, (int, float, bool, str)) else v
             for k, v in params.items()},
            allow_val_change=True,
        )

    def log_metrics(self, record: Dict[str, float], step: int):
        payload = {k: v for k, v in record.items() if k not in ("step", "time")}
        self._run.log(payload, step=step)

    def close(self):
        self._run.finish()


def default_writers(log_dir: str, name: str = "run",
                    use_tensorboard: bool = True) -> List[Any]:
    """JSONL always; TensorBoard / offline-W&B when importable+enabled."""
    writers: List[Any] = [JsonlWriter(log_dir)]
    if use_tensorboard:
        try:
            writers.append(TensorBoardWriter(log_dir))
        except ImportError:
            pass
    wandb_mode = os.environ.get("DISTILLCLIP_WANDB", "").strip().lower()
    if wandb_mode and wandb_mode != "0":
        try:
            writers.append(
                WandbWriter(
                    log_dir, name,
                    mode="offline" if wandb_mode in ("1", "true", "offline") else wandb_mode,
                )
            )
        except ImportError:
            pass
    return writers


class MetricLogger:
    def __init__(self, log_dir: str = "./result", name: str = "run",
                 use_tensorboard: bool = True,
                 writers: Optional[List[Any]] = None):
        self.log_dir = os.path.join(log_dir, name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.writers = (
            writers if writers is not None
            else default_writers(self.log_dir, name, use_tensorboard)
        )
        self._summary_max: Dict[str, float] = {}
        self._t0 = time.time()

    def log_hyperparams(self, params: Dict[str, Any]):
        for w in self.writers:
            w.log_hyperparams(params)

    def log_metrics(self, metrics: Dict[str, float], step: int):
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            v = float(v)
            record[k] = v
            if k in MAX_SUMMARY_KEYS:
                self._summary_max[k] = max(self._summary_max.get(k, -1e30), v)
        for w in self.writers:
            w.log_metrics(record, int(step))

    @property
    def summary(self) -> Dict[str, float]:
        return dict(self._summary_max)

    def close(self):
        for w in self.writers:
            w.close()


class NullLogger:
    """The logger of the ranks after the first under data parallelism: it
    writes nothing (the reference relied on Lightning's rank-zero logging)."""

    def log_hyperparams(self, params):
        pass

    def log_metrics(self, metrics, step):
        pass

    @property
    def summary(self) -> Dict[str, float]:
        return {}

    def close(self):
        pass
