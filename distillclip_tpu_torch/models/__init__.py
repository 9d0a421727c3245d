from distillclip_tpu_torch.models.clip import CLIPModel, l2_normalize
from distillclip_tpu_torch.models.encoders import ImageEncoder, TextEncoder
from distillclip_tpu_torch.models.irpe import RpeConfig, rpe_config_from_dict
from distillclip_tpu_torch.models.outputs import (
    AttentionOutput,
    CLIPOutput,
    ControlFlags,
    TextOutput,
    TransformerOutput,
    VisionOutput,
)
from distillclip_tpu_torch.models.repeat_vit import (
    RepeatTextTransformer,
    RepeatVisionTransformer,
)
from distillclip_tpu_torch.models.resnet import ModifiedResNet
from distillclip_tpu_torch.models.teacher import teacher_load
from distillclip_tpu_torch.models.text import TextTransformer
from distillclip_tpu_torch.models.vit import VisionTransformer

__all__ = [
    "AttentionOutput",
    "CLIPModel",
    "CLIPOutput",
    "ControlFlags",
    "ImageEncoder",
    "ModifiedResNet",
    "RepeatTextTransformer",
    "RepeatVisionTransformer",
    "RpeConfig",
    "TextEncoder",
    "TextOutput",
    "TextTransformer",
    "TransformerOutput",
    "VisionOutput",
    "VisionTransformer",
    "l2_normalize",
    "rpe_config_from_dict",
    "teacher_load",
]
