"""Dual-tower joint distillation task (stage 3: L-CLIP).

Port of ``distillclip_tpu/training/dual.py::DualDistillTask``: both students
in a :class:`CLIPModel`, the frozen CLIP teacher, the two-tower loss path,
prefix freezing and the embedding copy of ``freeze_embed``.  Three train
steps, as in the JAX package:

* the live step, ``make_train_step(tx)``: both teacher towers run in the step;
* ``cached_text_teacher=True``: captions are fixed token rows, so the text
  teacher's representations arrive as per-sample constants and only the image
  teacher runs (stage-3 images are augmented).  This is the step the final
  config trains with;
* ``cached_teachers=True``: both teachers' representations are constants
  (train images not augmented) and no teacher runs.

The teacher is built at first use, from ``teacher_name`` (a model name or a
checkpoint path): a task that only runs the all-cached step never loads one.
It runs under ``torch.no_grad()`` in the compute dtype, from a copy cast once.

Tap losses run in the live step only: the teacher runs with the task's flags,
one ``teacher_need_layers`` for both towers; ``vit_kd`` acts on the image tower
(its variables are masters beside the students', as ``loss_aux.<name>``).
``deterministic=False`` switches the students' dropout and drop-path on, drawn
from a generator the step seeds once.

``load_path={"image": ..., "text": ...}`` warm-starts the towers from stage-1
and stage-2 checkpoints (``training.checkpoints``), after the seeded init and
before ``vit_kd``'s parameters and ``freeze_embed``'s copy, as in the JAX
package.  :meth:`DualDistillTask.make_eval_step` is the validation step the
trainer runs: the live loss under ``torch.no_grad()``, retrieval accuracies on
the batch and the four representations for the epoch's full-corpus retrieval.

Under data parallelism every loss sees the global batch: both towers'
outputs, the students' and the teachers' (live or cached), are gathered over
the ranks before the loss, and the eval step's representations are the whole
validation batch's, in rank order (``parallel.distributed``, the sum rule).
The JAX package gets the same global negatives from its data mesh.

Under ``torch.profiler`` a step marks its phases as ``DistillTask``'s do
(``profiling.span``): ``step.student``, ``step.teacher`` (the live teacher, or
the cached representations' cast and logits), ``step.loss``,
``step.backward``, ``step.optimizer``.
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
from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher
from distillclip_tpu_torch.models.outputs import TextOutput, VisionOutput
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.training import metrics as M
from distillclip_tpu_torch.training.checkpoints import restore_tower_params
from distillclip_tpu_torch.training.profiling import span
from distillclip_tpu_torch.training.task_common import (
    adopt_params,
    build_optimizer,
    copy_teacher_embeddings,
    device_of,
    embedding_leaves,
    check_projections,
    gather_clip_output,
    make_step,
    split_params,
    step_generator,
)
from distillclip_tpu_torch.training.train_state import (
    AdamW,
    TrainState,
    cast_to_compute,
    freeze_mask,
    prepare_inputs,
)


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
        self.student = CLIPModel(image_tower=self.image_student, text_tower=self.text_student)
        self.loss_control = LossCalculator(**self.loss_control_para)
        self.flags: ControlFlags = self.loss_control.control_flags()
        for tower in (self.image_student, self.text_student):
            check_projections(tower, self.flags)
        self._dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        self.teacher = FrozenTeacher(self.teacher_name, self.download_root, "all",
                                     self.teacher_need_layers, self._dtype)
        self._mask = None

    # ------------------------------------------------------------------

    def init_params(self, rng, device="cuda") -> Dict[str, torch.Tensor]:
        """Seeded fp32 masters ``{"student.<module path>": tensor}`` on
        ``device``; ``rng`` is a numpy Generator or a seed.  With
        ``load_path`` the towers then take their stage checkpoints' weights.
        Under ``freeze_embed`` the image student starts from the teacher's
        patch, class and positional embeddings."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        for tower in (self.student.image_tower, self.student.text_tower):
            seeded_init(tower, rng)
        if self.load_path:
            self._load_stage_checkpoints()
        params = {f"student.{k}": v.detach().clone().float()
                  for k, v in self.student.named_parameters()}
        if self.loss_control.has_params:
            params.update({f"loss_aux.{k}": v
                           for k, v in self.loss_control.init_vit_kd(rng).items()})
        if self.freeze_embed:
            params = self._copy_teacher_embeddings(params)
        return {k: v.to(device) for k, v in params.items()}

    def _load_stage_checkpoints(self) -> None:
        """Warm-start both towers from their stage-1/2 checkpoints (the
        reference's load_weight strips the 'student.' key prefix, as
        ``restore_tower_params`` does)."""
        if self.load_path.get("image") is None or self.load_path.get("text") is None:
            raise ValueError(
                "the cpk is None! if you set the load_path parameter you "
                "should give the image and text checkpoint path")
        for key, tower in (("image", self.student.image_tower),
                           ("text", self.student.text_tower)):
            tower.load_state_dict(restore_tower_params(self.load_path[key], tower.state_dict()))

    def _frozen_paths(self) -> List[str]:
        if not self.freeze_embed:
            return []
        return [f"student/image_tower/{k.replace('.', '/')}"
                for k, _ in embedding_leaves(self.image_student)]

    def _frozen_prefixes(self) -> List[str]:
        """``freeze_prefix`` entries as the JAX package's path prefixes."""
        if not self.freeze_prefix:
            return []
        return [f"student/{p.replace('.', '/')}" for p in self.freeze_prefix]

    def _copy_teacher_embeddings(self, params: Dict[str, torch.Tensor]):
        return copy_teacher_embeddings(params, "student.image_tower.", self.image_student,
                                       self.teacher.state("image_tower.visual"))

    def make_optimizer(self, steps_per_epoch: int) -> AdamW:
        return build_optimizer(self, steps_per_epoch)

    def trainable_mask(self, params, frozen_embed: bool = False):
        frozen = self._frozen_paths() if frozen_embed else []
        prefixes = self._frozen_prefixes()
        if not (frozen or prefixes):
            return None
        return freeze_mask(params, frozen_paths=frozen, frozen_prefixes=prefixes,
                           path_of=torch_name_to_jax_path)

    def init_state(self, rng, steps_per_epoch: int, params: Optional[dict] = None,
                   device="cuda", frozen_embed: Optional[bool] = None
                   ) -> Tuple[TrainState, AdamW]:
        """(state, optimizer).  ``params`` are fp32 masters by the port's
        names (``convert.jax_dual_params_to_torch`` makes them from a JAX
        tree); without them the towers get seeded random weights.  The torch
        modules know their shapes, so no sample batch is needed."""
        if params is None:
            params = self.init_params(rng, device)
        else:
            params = adopt_params(self.student, params, device, "the students",
                                  self.loss_control.vit_kd_module)
        if frozen_embed is None:
            frozen_embed = self.freeze_embed
        tx = self.make_optimizer(steps_per_epoch)
        self._mask = self.trainable_mask(params, frozen_embed)
        return TrainState(step=0, params=params, opt_state=tx.init(params)), tx

    # ------------------------------------------------------------------

    def _student_forward(self, params, tokens, images, deterministic: bool, generator):
        """(students' output, the loss's own variables).  The students are
        stochastic (training mode) exactly when not deterministic."""
        with span("step.student"):
            student, aux = split_params(params)
            imgs = prepare_inputs(images, self._dtype)
            self.student.train(not deterministic)
            out = torch.func.functional_call(self.student, cast_to_compute(student, self._dtype),
                                             (tokens.long(), imgs, self.flags, generator))
            return out, aux

    def _finish(self, stu_out: CLIPOutput, tea_out: CLIPOutput, aux=None, generator=None):
        with span("step.loss"):
            stu_out, tea_out = gather_clip_output(stu_out, True), gather_clip_output(tea_out, False)
            if self.norm:
                stu_out = norm_last_representation(stu_out)
                tea_out = norm_last_representation(tea_out)
            loss, parts = self.loss_control(stu_out, tea_out, "all", vit_kd_variables=aux,
                                            generator=generator)
            return loss, (parts, stu_out, tea_out)

    def loss_fn(self, params, tokens, images, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """(loss, (parts, stu_out, tea_out)) with both teacher towers live, run
        with the task's flags.  ``generator`` feeds the students' dropout and
        drop-path when not deterministic, then ``vit_kd``'s token mask."""
        stu_out, aux = self._student_forward(params, tokens, images, deterministic, generator)
        with span("step.teacher"), torch.no_grad():
            tea_out = self.teacher.compute(device_of(params))(
                tokens.long(), prepare_inputs(images, self._dtype), self.flags)
        return self._finish(stu_out, tea_out, aux, generator)

    def loss_fn_cached_text(self, params, tokens, images, tea_text_rep,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None):
        """The text teacher's last representations given, the image teacher
        live; the teacher's logits by the arithmetic of ``CLIPModel.forward``."""
        stu_out, aux = self._student_forward(params, tokens, images, deterministic, generator)
        with span("step.teacher"), torch.no_grad():
            tea_vis = self.teacher.compute(device_of(params)).encode_image(
                prepare_inputs(images, self._dtype), self.flags)
            text_rep = tea_text_rep.to(self._dtype)
            logits = cosine_logits(tea_vis.last_representation, text_rep)
            tea_out = CLIPOutput(
                visual_output=tea_vis, text_output=TextOutput(last_representation=text_rep),
                i2t_logits=logits, t2i_logits=logits.t())
        return self._finish(stu_out, tea_out, aux, generator)

    def loss_fn_cached_all(self, params, tokens, images, tea_text_rep, tea_image_rep,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None):
        """Both teachers' last representations given; the teacher's logits are
        their cosines."""
        stu_out, aux = self._student_forward(params, tokens, images, deterministic, generator)
        with span("step.teacher"):
            text_rep = tea_text_rep.detach().to(self._dtype)
            image_rep = tea_image_rep.detach().to(self._dtype)
            logits = cosine_logits(image_rep, text_rep)
            tea_out = CLIPOutput(
                visual_output=VisionOutput(last_representation=image_rep),
                text_output=TextOutput(last_representation=text_rep),
                i2t_logits=logits, t2i_logits=logits.t())
        return self._finish(stu_out, tea_out, aux, generator)

    def make_teacher_image_encode(self, device="cuda") -> Callable:
        """``encode(images) -> fp32 last representations`` of the image
        teacher, for the all-cached path (only valid when the train images are
        not augmented)."""
        return self.teacher.image_encode(device)

    def make_teacher_text_encode(self, device="cuda") -> Callable:
        """``encode(tokens) -> fp32 last representations`` of the text
        teacher, for building the caption caches."""
        return self.teacher.text_encode(device)

    def make_train_step(self, tx: AdamW, deterministic: bool = True, trainable_mask=None,
                        cached_text_teacher: bool = False,
                        cached_teachers: bool = False, seed: int = 0) -> Callable:
        """``step(state, tokens, images[, tea_text_rep[, tea_image_rep]]) ->
        (state, metrics)``: the live step takes no teacher representation,
        ``cached_text_teacher`` the text teacher's, ``cached_teachers`` both.
        The metrics are 0-dim tensors on the state's device (``loss``, the loss
        parts, and ``grad_norm`` under ``log_grad_norm``).
        ``deterministic=False`` switches the students' dropout and drop-path
        on; their draws and ``vit_kd``'s masks come from one generator per
        step function, seeded with ``seed``.  ``trainable_mask=False`` means explicitly unfrozen; None takes the mask
        ``init_state`` made."""
        if trainable_mask is None:
            trainable_mask = self._mask
        elif trainable_mask is False:
            trainable_mask = None
        if cached_teachers or cached_text_teacher:
            which = "cached_teachers" if cached_teachers else "cached_text_teacher"
            if self.flags.any_tap():
                raise ValueError(f"{which} requires a loss config without teacher "
                                 f"taps (per-layer losses); got flags {self.flags}.")
        if cached_teachers:
            loss = self.loss_fn_cached_all
        elif cached_text_teacher:
            loss = self.loss_fn_cached_text
        else:
            loss = self.loss_fn
        random = not deterministic or self.loss_control.has_params
        generator_for = step_generator(seed)
        return make_step(
            lambda params, *batch: loss(params, *batch, deterministic,
                                        generator_for(params) if random else None),
            tx, trainable_mask, self.log_grad_norm)

    def make_eval_step(self) -> Callable:
        """``step(state, tokens, images) -> (metrics, reps)``: the live loss
        (both teacher towers run, whichever step trained) under
        ``torch.no_grad()`` with the students in eval mode, so every kernel
        takes its lean route.  The metrics are 0-dim tensors on the state's
        device: ``loss``, the loss parts, ``stu_acc_top{k}`` /
        ``tea_acc_top{k}`` on the batch and the student's diagonal scores;
        ``reps`` the four last representations in fp32."""
        random = self.loss_control.has_params

        @torch.no_grad()
        def step(state: TrainState, tokens, images):
            device = device_of(state.params)
            generator = torch.Generator(device=device).manual_seed(0) if random else None
            loss, (parts, stu_out, tea_out) = self.loss_fn(state.params, tokens, images, True,
                                                           generator)
            stu_img = stu_out.visual_output.last_representation
            stu_txt = stu_out.text_output.last_representation
            tea_img = tea_out.visual_output.last_representation
            tea_txt = tea_out.text_output.last_representation
            stu_logits = M.l2_normalize_f32(stu_img) @ M.l2_normalize_f32(stu_txt).t()
            tea_logits = M.l2_normalize_f32(tea_img) @ M.l2_normalize_f32(tea_txt).t()
            metrics = {"loss": loss, **parts}
            for k, v in M.topk_accuracy(stu_logits).items():
                metrics[f"stu_acc_top{k}"] = v
            for k, v in M.topk_accuracy(tea_logits).items():
                metrics[f"tea_acc_top{k}"] = v
            metrics["stu_mean_score"], metrics["stu_softmax_mean_score"] = \
                M.diag_scores(stu_logits)
            reps = {"stu_image_outs": stu_img.float(), "stu_text_outs": stu_txt.float(),
                    "tea_image_outs": tea_img.float(), "tea_text_outs": tea_txt.float()}
            return metrics, reps

        return step
