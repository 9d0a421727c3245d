"""YAML configs: multi-file deep merge, class-path injection, the trainer
section and the resolved-config snapshot.

Port of ``distillclip_tpu/config/loader.py``: the schema is ``{model, data,
trainer, perf}``, repeated ``-c`` files merge in order (a later file wins;
lists are replaced whole), ``{class_path, init_args}`` nodes build objects
(the reference's class paths are aliases of the port's classes; the student
towers come from ``serving.lclip_score``'s table), the Lightning trainer
section maps onto :class:`training.trainer.Trainer`, and a run writes the
merged config beside its results.
"""

from __future__ import annotations

import copy
import importlib
import inspect
from typing import Any, Dict, List, Optional

import yaml

# reference class_path -> the port's (constructor-argument renames below); the
# student towers are added from the scorer's table by class_aliases()
_ALIASES = {
    "DistillModel": "distillclip_tpu_torch.training.distill.DistillTask",
    "DualDistillModel": "distillclip_tpu_torch.training.dual.DualDistillTask",
    "MainDataModule": "distillclip_tpu_torch.data.datamodule.MainDataModule",
    "model.distil_model.DistillModel": "distillclip_tpu_torch.training.distill.DistillTask",
    "model.dual_distill_model.DualDistillModel":
        "distillclip_tpu_torch.training.dual.DualDistillTask",
    "data.main_datamodule.MainDataModule": "distillclip_tpu_torch.data.datamodule.MainDataModule",
    "data.text_image_datamodule.TextImageDataModule":
        "distillclip_tpu_torch.data.component.text_image_webdataset.TextImageDataModule",
    # the plain CLIP encoders, as students of stages 1 and 2 (not served)
    "model.component.image_encoder.ImageEncoder": "distillclip_tpu_torch.models.encoders.ImageEncoder",
    "model.component.text_encoder.TextEncoder": "distillclip_tpu_torch.models.encoders.TextEncoder",
}

_ARG_RENAMES = {
    "distillclip_tpu_torch.training.distill.DistillTask": {"student_encoder": "student"},
}

# constructor args accepted by the reference but meaningless here; dropped
# silently when their value is null
_DROPPABLE_IF_NONE = {"hybrid_backbone", "qk_scale"}


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; ``override`` wins; lists replace wholesale."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_configs(paths: List[str]) -> Dict:
    """The YAML files merged in order."""
    merged: Dict = {}
    for path in paths:
        with open(path) as f:
            merged = deep_merge(merged, yaml.safe_load(f) or {})
    return merged


def class_aliases() -> Dict[str, str]:
    """Every reference class path the configs may name -> the port's class.
    The towers come from ``serving.lclip_score.TOWERS``, imported here and not
    at module import (the models import ``config.perf``)."""
    from distillclip_tpu_torch.serving.lclip_score import TOWERS

    return {**_ALIASES,
            **{path: f"{cls.__module__}.{cls.__qualname__}" for path, cls in TOWERS.items()}}


def resolve_class(class_path: str):
    """(class, canonical path) of a config's ``class_path``."""
    class_path = class_aliases().get(class_path, class_path)
    module_name, _, cls_name = class_path.rpartition(".")
    if not module_name:
        raise ValueError(f"cannot resolve bare class name {class_path!r}")
    return getattr(importlib.import_module(module_name), cls_name), class_path


def instantiate(node: Any) -> Any:
    """Recursively build objects from ``{class_path, init_args}`` nodes."""
    if isinstance(node, dict):
        if "class_path" not in node:
            return {k: instantiate(v) for k, v in node.items()}
        cls, canonical = resolve_class(node["class_path"])
        renames = _ARG_RENAMES.get(canonical, {})
        kwargs = {}
        for k, v in (node.get("init_args") or {}).items():
            k = renames.get(k, k)
            v = instantiate(v)
            if k in _DROPPABLE_IF_NONE and v is None:
                continue
            kwargs[k] = v
        if isinstance(kwargs.get("rpe_config"), dict):
            from distillclip_tpu_torch.models.irpe import rpe_config_from_dict

            kwargs["rpe_config"] = rpe_config_from_dict(kwargs["rpe_config"])
        params = inspect.signature(cls.__init__).parameters
        if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            for k in [k for k in kwargs if k not in params]:
                if kwargs[k] is not None:
                    raise TypeError(f"{canonical} got unexpected config argument {k!r}")
                kwargs.pop(k)
        return cls(**kwargs)
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


# Lightning trainer keys -> Trainer fields
_TRAINER_KEYS = {
    "max_epochs": "max_epochs",
    "check_val_every_n_epoch": "check_val_every_n_epoch",
    "log_every_n_steps": "log_every_n_steps",
    "limit_train_batches": "limit_train_batches",
    "limit_val_batches": "limit_val_batches",
    "default_root_dir": "result_dir",
    "profiler": "profiler",
    "save_every_n_steps": "save_every_n_steps",
    "accumulate_grad_batches": "accumulate_grad_batches",
}


def build_trainer(trainer_cfg: Optional[Dict], seed: int = 2022, device: str = "cuda"):
    """The trainer section as a :class:`Trainer` on ``device``.  Lightning-only
    keys (accelerator, strategy, precision, ...) are ignored: the device is the
    caller's and the precision the task's ``compute_dtype``."""
    from distillclip_tpu_torch.training.trainer import Trainer

    trainer_cfg = dict(trainer_cfg or {})
    kwargs: Dict[str, Any] = {"seed": seed, "device": device}
    for src, dst in _TRAINER_KEYS.items():
        if trainer_cfg.get(src) is not None:
            kwargs[dst] = trainer_cfg[src]

    run_name = "run"
    logger_cfg = trainer_cfg.get("logger")
    if isinstance(logger_cfg, dict):
        init = logger_cfg.get("init_args", {}) or {}
        run_name = init.get("name", run_name) or run_name
        if init.get("dir"):
            kwargs.setdefault("result_dir", init["dir"])
    kwargs["run_name"] = str(run_name).replace("/", "_").replace(" ", "_")

    for cb in trainer_cfg.get("callbacks", []) or []:
        if isinstance(cb, dict) and cb.get("class_path", "").endswith("EarlyStopping"):
            init = cb.get("init_args", {}) or {}
            kwargs["early_stopping_monitor"] = init.get("monitor", "val_loss/loss")
            kwargs["early_stopping_patience"] = init.get("patience", 10)
    return Trainer(**kwargs)


def save_resolved_config(cfg: Dict, out_path: str) -> None:
    with open(out_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
