from distillclip_tpu_torch.losses import functional
from distillclip_tpu_torch.losses.calculator import IMAGE_TEXT_LOSS, LOSS_NAMES, LossCalculator

__all__ = ["IMAGE_TEXT_LOSS", "LOSS_NAMES", "LossCalculator", "functional"]
