from distillclip_tpu_torch.models.clip import CLIPModel, l2_normalize
from distillclip_tpu_torch.models.outputs import (
    CLIPOutput,
    ControlFlags,
    TextOutput,
    VisionOutput,
)
from distillclip_tpu_torch.models.repeat_vit import (
    RepeatTextTransformer,
    RepeatVisionTransformer,
)

__all__ = [
    "CLIPModel",
    "CLIPOutput",
    "ControlFlags",
    "RepeatTextTransformer",
    "RepeatVisionTransformer",
    "TextOutput",
    "VisionOutput",
    "l2_normalize",
]
