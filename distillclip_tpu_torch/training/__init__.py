from distillclip_tpu_torch.training.distill import DistillTask
from distillclip_tpu_torch.training.dual import DualDistillTask, norm_last_representation
from distillclip_tpu_torch.training.schedules import hf_cosine_with_warmup, per_epoch
from distillclip_tpu_torch.training.train_state import (
    AdamW,
    TrainState,
    cast_to_compute,
    freeze_mask,
    make_optimizer,
)

__all__ = [
    "AdamW",
    "DistillTask",
    "DualDistillTask",
    "TrainState",
    "cast_to_compute",
    "freeze_mask",
    "hf_cosine_with_warmup",
    "make_optimizer",
    "norm_last_representation",
    "per_epoch",
]
