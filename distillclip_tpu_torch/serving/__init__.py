from distillclip_tpu_torch.serving.inputs import cast_to_compute, prepare_inputs
from distillclip_tpu_torch.serving.lclip_score import LCLIPScorer

__all__ = ["LCLIPScorer", "cast_to_compute", "prepare_inputs"]
