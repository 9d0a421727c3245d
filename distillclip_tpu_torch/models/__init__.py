from distillclip_tpu_torch.models.clip import l2_normalize
from distillclip_tpu_torch.models.outputs import ControlFlags
from distillclip_tpu_torch.models.repeat_vit import (
    RepeatTextTransformer,
    RepeatVisionTransformer,
)

__all__ = [
    "ControlFlags",
    "RepeatTextTransformer",
    "RepeatVisionTransformer",
    "l2_normalize",
]
