"""Dual-tower joint distillation task (stage 3: L-CLIP).

Port of ``distillclip_tpu/training/dual.py::DualDistillTask``: both students
in a :class:`CLIPModel`, the two-tower loss path, prefix freezing.  This
slice ports the train step whose teachers are both cached
(``make_train_step(cached_teachers=True)``): the frozen teacher's image and
text representations arrive as per-sample constants, so the step runs the two
students forward and backward, the losses, and AdamW on the fp32 masters.

The port's task builds no teacher.  What needs one is refused by name: the
live step and ``cached_text_teacher`` (ROADMAP queue 1, item 3), and with them
``load_path`` (stage-1/2 checkpoints, item 7) and ``freeze_embed`` (which
copies the teacher's embeddings).

On one device the contrastive negatives are the batch's own; the JAX package
gathers them over its data mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distillclip_tpu_torch.convert import torch_name_to_jax_path
from distillclip_tpu_torch.losses import LossCalculator
from distillclip_tpu_torch.models import CLIPModel, CLIPOutput, ControlFlags
from distillclip_tpu_torch.models.clip import cosine_logits
from distillclip_tpu_torch.models.outputs import TextOutput, VisionOutput
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.training.schedules import hf_cosine_with_warmup, per_epoch
from distillclip_tpu_torch.training.train_state import (
    AdamW,
    TrainState,
    cast_to_compute,
    freeze_mask,
    global_norm,
    make_optimizer,
    prepare_inputs,
)

_TEACHER_ITEM = "ROADMAP queue 1, item 3 (the teacher towers)"


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def norm_last_representation(out: CLIPOutput) -> CLIPOutput:
    """L2-normalise both towers' last representations."""
    return dataclasses.replace(
        out,
        visual_output=dataclasses.replace(
            out.visual_output,
            last_representation=_unit(out.visual_output.last_representation)),
        text_output=dataclasses.replace(
            out.text_output, last_representation=_unit(out.text_output.last_representation)),
    )


@dataclasses.dataclass
class DualDistillTask:
    """The constructor's fields are the JAX task's."""

    image_student: Any
    text_student: Any
    loss_control_para: Dict[str, Any]
    warm_steps: int = 15
    total_steps: int = 300
    weight_decay: float = 1e-3
    lr: float = 1e-4
    download_root: str = "./.cache"
    norm: bool = False
    teacher_name: str = "ViT-B/32"
    freeze_embed: bool = False
    unfreeze_epoch: Optional[int] = None
    load_path: Optional[Dict[str, str]] = None
    teacher_need_layers: Optional[Sequence[int]] = None
    freeze_prefix: Optional[List[str]] = None
    compute_dtype: str = "bfloat16"
    grad_clip_norm: Optional[float] = None
    log_grad_norm: bool = False
    accumulate_grad_batches: int = 1

    def __post_init__(self):
        if self.load_path:
            raise NotImplementedError(
                "load_path (warm start from stage-1/2 checkpoints) is not ported yet "
                "(ROADMAP queue 1, item 7: checkpoints); pass params to init_state")
        if self.freeze_embed:
            raise NotImplementedError(
                f"freeze_embed copies the teacher's embeddings; the port builds no "
                f"teacher yet ({_TEACHER_ITEM})")
        self.student = CLIPModel(image_tower=self.image_student, text_tower=self.text_student)
        self.loss_control = LossCalculator(**self.loss_control_para)
        self.flags: ControlFlags = self.loss_control.control_flags()
        self._dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        self._mask = None

    # ------------------------------------------------------------------

    def init_params(self, rng, device="cuda") -> Dict[str, torch.Tensor]:
        """Seeded fp32 masters ``{"student.<module path>": tensor}`` on
        ``device``; ``rng`` is a numpy Generator or a seed."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        for tower in (self.student.image_tower, self.student.text_tower):
            seeded_init(tower, rng)
        return {f"student.{k}": v.detach().clone().float().to(device)
                for k, v in self.student.named_parameters()}

    def _frozen_paths(self) -> List[str]:
        return []  # only freeze_embed names exact paths, and it is refused above

    def _frozen_prefixes(self) -> List[str]:
        """``freeze_prefix`` entries as the JAX package's path prefixes."""
        if not self.freeze_prefix:
            return []
        return [f"student/{p.replace('.', '/')}" for p in self.freeze_prefix]

    def make_optimizer(self, steps_per_epoch: int) -> AdamW:
        k = max(1, int(self.accumulate_grad_batches or 1))
        # with accumulation the optimizer counts updates, of which there are
        # steps_per_epoch // k per epoch
        schedule = per_epoch(
            hf_cosine_with_warmup(self.lr, self.warm_steps, self.total_steps),
            max(1, steps_per_epoch // k))
        self._lr_schedule = schedule
        return make_optimizer(schedule, weight_decay=self.weight_decay,
                              grad_clip_norm=self.grad_clip_norm, accumulate_steps=k)

    def trainable_mask(self, params, frozen_embed: bool = False):
        frozen = self._frozen_paths() if frozen_embed else []
        prefixes = self._frozen_prefixes()
        if not (frozen or prefixes):
            return None
        return freeze_mask(params, frozen_paths=frozen, frozen_prefixes=prefixes,
                           path_of=torch_name_to_jax_path)

    def init_state(self, rng, steps_per_epoch: int, params: Optional[dict] = None,
                   device="cuda") -> Tuple[TrainState, AdamW]:
        """(state, optimizer).  ``params`` are fp32 masters by the port's
        names (``convert.jax_dual_params_to_torch`` makes them from a JAX
        tree); without them the towers get seeded random weights.  The torch
        modules know their shapes, so no sample batch is needed."""
        if params is None:
            params = self.init_params(rng, device)
        else:
            want = {f"student.{k}" for k, _ in self.student.named_parameters()}
            if set(params) != want:
                raise ValueError(f"params do not match the students: missing "
                                 f"{sorted(want - set(params))}, unexpected "
                                 f"{sorted(set(params) - want)}")
            params = {k: torch.as_tensor(v).detach().clone().float().to(device)
                      for k, v in params.items()}
        tx = self.make_optimizer(steps_per_epoch)
        self._mask = self.trainable_mask(params)
        return TrainState(step=0, params=params, opt_state=tx.init(params)), tx

    # ------------------------------------------------------------------

    def _student_forward(self, params, tokens, images) -> CLIPOutput:
        compute = {k[len("student."):]: v
                   for k, v in cast_to_compute(params, self._dtype).items()}
        imgs = prepare_inputs(images, self._dtype)
        return torch.func.functional_call(self.student, compute,
                                          (tokens.long(), imgs, self.flags))

    def loss_fn_cached_all(self, params, tokens, images, tea_text_rep, tea_image_rep,
                           deterministic: bool = True):
        """(loss, (parts, stu_out, tea_out)) with both teachers' last
        representations given; the teacher's logits are their cosines."""
        if not deterministic:
            raise NotImplementedError(
                "dropout in the train step is not ported yet (ROADMAP queue 1, item 2: "
                "taps and dropout)")
        stu_out = self._student_forward(params, tokens, images)
        text_rep = tea_text_rep.detach().to(self._dtype)
        image_rep = tea_image_rep.detach().to(self._dtype)
        logits = cosine_logits(image_rep, text_rep)
        tea_out = CLIPOutput(
            visual_output=VisionOutput(last_representation=image_rep),
            text_output=TextOutput(last_representation=text_rep),
            i2t_logits=logits, t2i_logits=logits.t())
        if self.norm:
            stu_out = norm_last_representation(stu_out)
            tea_out = norm_last_representation(tea_out)
        loss, parts = self.loss_control(stu_out, tea_out, "all")
        return loss, (parts, stu_out, tea_out)

    def make_train_step(self, tx: AdamW, deterministic: bool = True, trainable_mask=None,
                        cached_text_teacher: bool = False,
                        cached_teachers: bool = False) -> Callable:
        """``step(state, tokens, images, tea_text_rep, tea_image_rep) ->
        (state, metrics)`` for ``cached_teachers=True``; the metrics are 0-dim
        tensors on the state's device (``loss``, the loss parts, and
        ``grad_norm`` under ``log_grad_norm``).  ``trainable_mask=False`` means
        explicitly unfrozen; None takes the mask ``init_state`` made."""
        if trainable_mask is None:
            trainable_mask = self._mask
        elif trainable_mask is False:
            trainable_mask = None
        if not cached_teachers:
            which = "cached_text_teacher" if cached_text_teacher else "the live step"
            raise NotImplementedError(
                f"{which} runs a teacher tower, which is not ported yet ({_TEACHER_ITEM}); "
                f"the port trains with cached_teachers=True")
        if self.flags.any_tap():
            raise ValueError("cached_teachers requires a loss config without teacher "
                             f"taps (per-layer losses); got flags {self.flags}.")
        self.student.train()

        def step_all_cached(state: TrainState, tokens, images, tea_text_rep, tea_image_rep):
            names = list(state.params)
            leaves = [state.params[k].requires_grad_() for k in names]
            loss, (parts, _, _) = self.loss_fn_cached_all(
                dict(zip(names, leaves)), tokens, images, tea_text_rep, tea_image_rep,
                deterministic)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for k, p, g in zip(names, leaves, grads)}
            for p in leaves:
                p.requires_grad_(False)
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
            if self.log_grad_norm:
                metrics["grad_norm"] = global_norm(grads)
            return state.apply_gradients(grads, tx, trainable_mask), metrics

        return step_all_cached
