"""Static switches for what a forward returns, and the output containers.

Port of ``distillclip_tpu/models/outputs.py``.  :class:`ControlFlags` is the
counterpart of the reference's ControlOutput.  The port runs only the default
flags (no tap): the students return their pooled, projected representation,
and :class:`VisionOutput`, :class:`TextOutput` and :class:`CLIPOutput` carry
the fields the no-tap losses read.  The taps (embedding, attention scores and
probabilities, value map, hidden representations, the full last layer) are
ROADMAP queue 1, item 2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_TAPS_ITEM = "ROADMAP queue 1, item 2 (taps and dropout)"


@dataclasses.dataclass(frozen=True)
class ControlFlags:
    need_emb: bool = False
    need_attn_score: bool = False
    need_value_map: bool = False
    need_attn_prob: bool = False
    need_rep: bool = False
    # full projected sequence; without it the towers pool first and run the
    # final norm + head on one row per sample
    need_last_layer: bool = False

    def any_tap(self) -> bool:
        """True if any per-layer instrumentation is requested."""
        return (self.need_emb or self.need_attn_score or self.need_value_map
                or self.need_attn_prob or self.need_rep)

    def require_default(self) -> None:
        """Raise for any flag the port does not run yet (all of them)."""
        on = [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]
        if on:
            raise NotImplementedError(
                f"ControlFlags {on}: the towers' taps are not ported yet; they come "
                f"with {_TAPS_ITEM}")


@dataclasses.dataclass(frozen=True)
class VisionOutput:
    """Vision tower output: the cls representation ``[B, out_dim]``; the
    tapped fields of the JAX container stay None until the taps are ported."""

    last_representation: torch.Tensor
    last_layer_output: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class TextOutput:
    """Text tower output: the EOT representation ``[B, out_dim]``."""

    last_representation: torch.Tensor
    last_layer_output: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class CLIPOutput:
    """Both towers' outputs and the raw cosine logits (no logit scale)."""

    visual_output: VisionOutput
    text_output: TextOutput
    i2t_logits: torch.Tensor  # [B_img, B_txt] fp32
    t2i_logits: torch.Tensor  # [B_txt, B_img] fp32
