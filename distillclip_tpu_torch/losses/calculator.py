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

All 18 loss names of the JAX package are computed; an unknown name raises its
``ValueError``.  ``vit_kd`` is the one loss with parameters: its module is
``vit_kd_module`` and its variables travel beside the student's as
``loss_aux`` (:meth:`LossCalculator.init_vit_kd` makes them).  Its random
token mask is drawn from the ``torch.Generator`` the call is given.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distillclip_tpu_torch.losses import functional as F
from distillclip_tpu_torch.losses.vit_kd import ViTKDLoss
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

        self.temperature = temperature
        self.smd_tau = smd_tau
        if vit_kd_para is not None:
            vit_kd_para = dict(vit_kd_para)
            vit_kd_para.setdefault("low_layers_num", 2)
            vit_kd_para.setdefault("high_layers_num", 1)
        self.vit_kd_para = vit_kd_para

        self.vit_kd_module: Optional[ViTKDLoss] = None
        if "vit_kd" in self.loss_name:
            if vit_kd_para is None:
                raise ValueError("vit_kd loss requires vit_kd_para")
            self.vit_kd_module = ViTKDLoss(**vit_kd_para)

        if any(n in ("out_kl", "soft_label") for n in self.loss_name) and not self.temperature:
            raise ValueError("temperature required for out_kl / soft_label")

    def control_flags(self) -> ControlFlags:
        """Which encoder taps the selected losses need."""
        names = set(self.loss_name)
        return ControlFlags(
            need_emb="embedding_mse" in names,
            need_attn_score="attention_score_mse" in names,
            need_attn_prob=bool(names & {"attention_probs_mse", "attention_probs_kl"}),
            need_rep=bool(names & {"hidden_rep_mse", "vit_kd"}),
            need_value_map="last_value_map_kl" in names,
            need_last_layer="fine_grain" in names,
        )

    # -- vit_kd variables ------------------------------------------------------

    @property
    def has_params(self) -> bool:
        """True when a loss carries parameters of its own (only ``vit_kd``)."""
        return self.vit_kd_module is not None

    def init_vit_kd(self, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """Fresh ViTKD variables ``{name: fp32 tensor}`` from a numpy
        generator, by the JAX module's scheme: Dense and Conv2d weights normal
        with std fan_in ** -0.5, biases and the mask token zero.  The module's
        shapes follow from ``vit_kd_para`` alone, so no example outputs are
        needed."""
        out = {}
        for name, p in self.vit_kd_module.named_parameters():
            if name.endswith(("weight", "kernel")):
                # Conv2d weight [out, in, 3, 3]; Dense kernel [in, out]
                fan_in = p[0].numel() if name.endswith("weight") else p.shape[0]
                w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * fan_in ** -0.5
                out[name] = torch.from_numpy(w.astype(np.float32))
            else:
                out[name] = torch.zeros_like(p)
        return out

    def _vit_kd_inputs(self, stu_out, tea_out):
        """The low and the high slices of the stacked representations:
        ``[L, B, N, D] -> [B, k, N, D]``."""
        low = self.vit_kd_para["low_layers_num"]
        high = self.vit_kd_para["high_layers_num"]
        sr, tr = stu_out.representations, tea_out.representations
        if sr is None or tr is None:
            raise ValueError("vit_kd needs both towers' hidden representations (need_rep)")
        if low + high > sr.shape[0]:
            raise ValueError("vit_kd needs low+high <= collected layers")
        b_first = lambda x: x.transpose(0, 1)
        return ([b_first(sr[:low]), b_first(sr[-high:])],
                [b_first(tr[:low]), b_first(tr[-high:])])

    # -- loss paths --------------------------------------------------------------

    def one_tower(self, stu_out, tea_out, vit_kd_variables=None,
                  generator: Optional[torch.Generator] = None,
                  skip_vit_kd: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Single-tower distillation losses.  ``skip_vit_kd`` zeroes the vit_kd
        term and keeps the weighting: the two-tower path passes it for the
        text tower, whose token grid is not square (ViTKD's generation head is
        an image-feature-map loss)."""
        device = stu_out.last_representation.device
        s_rep, t_rep = stu_out.last_representation, tea_out.last_representation
        res: Dict[str, torch.Tensor] = {}
        for name in self.loss_name:
            if name in IMAGE_TEXT_LOSS:
                continue
            if name == "out_l1":
                res[name] = F.out_l1(s_rep, t_rep)
            elif name == "out_ce":
                res[name] = F.out_ce(s_rep, t_rep)
            elif name == "out_kl":
                res[name] = F.out_kl(s_rep, t_rep, self.temperature)
            elif name == "out_cos":
                res[name] = F.out_cos(s_rep, t_rep)
            elif name == "embedding_mse":
                res[name] = F.embedding_mse(stu_out.embedding, tea_out.embedding)
            elif name == "attention_score_mse":
                res[name] = F.attention_score_mse(stu_out.attention_scores,
                                                  tea_out.attention_scores)
            elif name == "attention_probs_mse":
                res[name] = F.attention_probs_mse(stu_out.attention_probs,
                                                  tea_out.attention_probs)
            elif name == "attention_probs_kl":
                res[name] = F.attention_probs_kl(stu_out.attention_probs,
                                                 tea_out.attention_probs)
            elif name == "hidden_rep_mse":
                res[name] = F.hidden_rep_mse(stu_out.representations, tea_out.representations)
            elif name == "last_value_map_kl":
                res[name] = F.last_value_map_kl(stu_out.value_map, tea_out.value_map)
            elif name == "smd":
                res[name] = F.smd(t_rep, s_rep, tau=self.smd_tau)
            elif name == "vit_kd":
                if skip_vit_kd:
                    res[name] = torch.zeros((), dtype=torch.float32, device=device)
                    continue
                if vit_kd_variables is None:
                    raise ValueError("vit_kd requires vit_kd_variables")
                pred_s, pred_t = self._vit_kd_inputs(stu_out, tea_out)
                res[name] = torch.func.functional_call(
                    self.vit_kd_module, vit_kd_variables, (pred_s, pred_t, generator))

        total = torch.zeros((), dtype=torch.float32, device=device)
        for name, scale in self.loss_scale.items():
            if name in IMAGE_TEXT_LOSS:
                continue
            res[name] = res[name] * scale
            total = total + res[name] * self.percent[name]
        return total, res

    def two_tower(self, stu_out: CLIPOutput, tea_out: CLIPOutput, vit_kd_variables=None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """0.5 · (image + text one-tower) + the weighted image-text losses."""
        res: Dict[str, torch.Tensor] = {}
        image_loss, image_res = self.one_tower(stu_out.visual_output, tea_out.visual_output,
                                               vit_kd_variables, generator)
        text_loss, text_res = self.one_tower(stu_out.text_output, tea_out.text_output,
                                             vit_kd_variables, generator, skip_vit_kd=True)
        for k, v in image_res.items():
            res["image_" + k] = v
        for k, v in text_res.items():
            res["text_" + k] = v

        s_i2t, s_t2i, t_i2t, t_t2i = (stu_out.i2t_logits, stu_out.t2i_logits,
                                      tea_out.i2t_logits, tea_out.t2i_logits)
        for name in self.loss_name:
            if name == "hard_label":
                res[name] = 0.5 * (F.hard_label(s_i2t) + F.hard_label(s_t2i))
            elif name == "soft_label":
                res[name] = 0.5 * (F.soft_label(s_i2t, t_i2t, self.temperature)
                                   + F.soft_label(s_t2i, t_t2i, self.temperature))
            elif name == "logits_mse":
                res[name] = 0.5 * (F.logits_mse(s_i2t, t_i2t) + F.logits_mse(s_t2i, t_t2i))
            elif name == "fine_grain":
                res[name] = F.fine_grain(stu_out.visual_output.last_layer_output,
                                         stu_out.text_output.last_layer_output)
            elif name == "cos_diff":
                res[name] = 0.5 * (F.cos_diff(s_i2t, t_i2t) + F.cos_diff(s_t2i, t_t2i))
            elif name == "smd_multi_model":
                res[name] = F.smd_multi_model(
                    tea_out.visual_output.last_representation,
                    stu_out.visual_output.last_representation,
                    stu_out.text_output.last_representation, tau=self.smd_tau)

        total = 0.5 * (image_loss + text_loss)
        for name, scale in self.loss_scale.items():
            if name in IMAGE_TEXT_LOSS:
                res[name] = res[name] * scale
                total = total + res[name] * self.percent[name]
        return total, res

    def __call__(self, stu_out, tea_out, model_type: str, vit_kd_variables=None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Dispatch per model_type ('image' | 'text' | 'all')."""
        if model_type == "all":
            return self.two_tower(stu_out, tea_out, vit_kd_variables, generator)
        return self.one_tower(stu_out, tea_out, vit_kd_variables, generator)
