"""LossCalculator: registry and weighted combiner of distillation losses.

Port of ``distillclip_tpu/losses/calculator.py`` with the same semantics:

* per-loss ``loss_scale`` (default 1);
* ``percent`` weights that sum to 1; names missing from a partial ``percent``
  share the leftover mass equally;
* one-tower total = Σ scale_i · loss_i · percent_i over the losses that are
  not image-text losses;
* two-tower total = 0.5 · (image + text one-tower totals) + the weighted
  image-text losses, with parts named ``image_*``, ``text_*`` and by the
  image-text loss's own name.

Ported losses: ``out_l1``, ``out_cos`` and ``cos_diff``.  Every other name of
the JAX package raises ``NotImplementedError`` (ROADMAP queue 1, item 4); an
unknown name raises the JAX package's ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from distillclip_tpu_torch.losses import functional as F
from distillclip_tpu_torch.models.outputs import CLIPOutput, ControlFlags

LOSS_NAMES = (
    "out_l1", "out_ce", "out_kl", "out_cos", "embedding_mse",
    "attention_score_mse", "attention_probs_mse", "hidden_rep_mse",
    "attention_probs_kl", "last_value_map_kl", "vit_kd", "smd",
    "hard_label", "soft_label", "fine_grain", "logits_mse", "cos_diff",
    "smd_multi_model",
)

# losses computed on the contrastive logits / cross-tower features
IMAGE_TEXT_LOSS = ("hard_label", "soft_label", "logits_mse", "fine_grain",
                   "cos_diff", "smd_multi_model")

PORTED = ("out_l1", "out_cos", "cos_diff")


class LossCalculator:
    """Static loss configuration and combiner."""

    def __init__(
        self,
        loss_name: List[str],
        loss_scale: Optional[Dict[str, float]] = None,
        temperature: Optional[float] = None,
        percent: Optional[Dict[str, float]] = None,
        smd_tau: float = 0.04,
        vit_kd_para: Optional[Dict[str, Any]] = None,
    ):
        for n in loss_name:
            if n not in LOSS_NAMES:
                raise ValueError(f"Invalid Loss Type: {n}")
        unported = [n for n in loss_name if n not in PORTED]
        if unported:
            raise NotImplementedError(
                f"losses {unported} are not ported yet (ROADMAP queue 1, item 4: the "
                f"remaining losses); the port computes {list(PORTED)}")
        self.loss_name = list(loss_name)

        self.loss_scale: Dict[str, float] = {}
        if loss_scale is None:
            loss_scale = {n: 1 for n in self.loss_name}
        for n in self.loss_name:
            self.loss_scale[n] = loss_scale.get(n, 1)

        if percent is None:
            percent = {n: 1.0 / len(self.loss_name) for n in self.loss_name}
        self.percent = dict(percent)
        missing = [n for n in self.loss_name if n not in self.percent]
        if missing:
            # the leftover mass is spread over the missing losses
            default_value = (1 - sum(self.percent.values())) / len(missing)
            if default_value <= 0:
                raise ValueError(
                    f"there are some loss default percent is negative. "
                    f"Please check the sum of the percent {percent}; "
                    f"default_value={default_value}"
                )
            for n in missing:
                self.percent[n] = default_value
        if abs(sum(self.percent.values()) - 1) > 1e-5:
            raise ValueError(f"percent must sum to 1, got {self.percent}")

        # kept for the losses that will read them
        self.temperature = temperature
        self.smd_tau = smd_tau
        self.vit_kd_para = vit_kd_para

    def control_flags(self) -> ControlFlags:
        """Which encoder taps the selected losses need: none of the ported
        losses needs any."""
        names = set(self.loss_name)
        return ControlFlags(
            need_emb="embedding_mse" in names,
            need_attn_score="attention_score_mse" in names,
            need_attn_prob=bool(names & {"attention_probs_mse", "attention_probs_kl"}),
            need_rep=bool(names & {"hidden_rep_mse", "vit_kd"}),
            need_value_map="last_value_map_kl" in names,
            need_last_layer="fine_grain" in names,
        )

    @property
    def has_params(self) -> bool:
        """True when a loss carries parameters of its own (only ``vit_kd``)."""
        return False

    def one_tower(self, stu_out, tea_out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Single-tower distillation losses on the last representations."""
        res: Dict[str, torch.Tensor] = {}
        for name in self.loss_name:
            if name == "out_l1":
                res[name] = F.out_l1(stu_out.last_representation, tea_out.last_representation)
            elif name == "out_cos":
                res[name] = F.out_cos(stu_out.last_representation, tea_out.last_representation)

        total = torch.zeros((), dtype=torch.float32,
                            device=stu_out.last_representation.device)
        for name, scale in self.loss_scale.items():
            if name in IMAGE_TEXT_LOSS:
                continue
            res[name] = res[name] * scale
            total = total + res[name] * self.percent[name]
        return total, res

    def two_tower(self, stu_out: CLIPOutput,
                  tea_out: CLIPOutput) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """0.5 · (image + text one-tower) + the weighted image-text losses."""
        res: Dict[str, torch.Tensor] = {}
        image_loss, image_res = self.one_tower(stu_out.visual_output, tea_out.visual_output)
        text_loss, text_res = self.one_tower(stu_out.text_output, tea_out.text_output)
        for k, v in image_res.items():
            res["image_" + k] = v
        for k, v in text_res.items():
            res["text_" + k] = v

        for name in self.loss_name:
            if name == "cos_diff":
                res[name] = 0.5 * (
                    F.cos_diff(stu_out.i2t_logits, tea_out.i2t_logits)
                    + F.cos_diff(stu_out.t2i_logits, tea_out.t2i_logits)
                )

        total = 0.5 * (image_loss + text_loss)
        for name, scale in self.loss_scale.items():
            if name in IMAGE_TEXT_LOSS:
                res[name] = res[name] * scale
                total = total + res[name] * self.percent[name]
        return total, res

    def __call__(self, stu_out, tea_out,
                 model_type: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Dispatch per model_type ('image' | 'text' | 'all')."""
        if model_type == "all":
            return self.two_tower(stu_out, tea_out)
        return self.one_tower(stu_out, tea_out)
