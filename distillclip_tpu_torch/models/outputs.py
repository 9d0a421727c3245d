"""Static switches for what a forward returns.

Port of ``ControlFlags`` (``distillclip_tpu/models/outputs.py:36-72``), the
counterpart of the reference's ControlOutput.  The serving slice runs only
the default flags: the students return their pooled, projected
representation and nothing else.  The taps arrive with the train step.
"""

from __future__ import annotations

import dataclasses

_TAPS_ITEM = "ROADMAP queue 1, item 2 (the train-step slice)"


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

    def require_default(self) -> None:
        """Raise for any flag the port does not serve yet (all of them)."""
        on = [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]
        if on:
            raise NotImplementedError(
                f"ControlFlags {on}: the towers' taps are not ported yet; they come "
                f"with {_TAPS_ITEM}")
