"""Single-tower distillation task (stage 1: image, stage 2: text).

Port of ``distillclip_tpu/training/distill.py::DistillTask``: one student (a
weight-share tower or a plain CLIP encoder) against the frozen teacher tower
of the same modality, with

* the live step, ``make_train_step(tx)``: the teacher runs in the step under
  ``torch.no_grad()``;
* ``cached_teacher=True``: the teacher's last representations arrive as
  per-sample constants (stage-2 captions are fixed token rows) and no teacher
  runs; :meth:`DistillTask.make_teacher_encode` builds them;
* ``teacher_init_type``: a plain encoder student warm-started from the
  teacher's blocks; ``freeze_embed`` (image): the teacher's patch, class and
  positional embeddings copied into the student and frozen (the weight-share
  student's patch bias stays trainable, as in the reference);
* tap losses (per-layer losses, ``vit_kd``): the teacher runs with the task's
  flags and returns the taps of ``teacher_need_layers``; ``vit_kd``'s own
  variables are masters beside the student's, as ``loss_aux.<name>``, trained
  and decayed like any other leaf;
* ``deterministic=False``: dropout and drop-path act in the student, drawing
  from a generator that the step seeds once and every draw advances.

The teacher is built at first use.  :meth:`DistillTask.make_eval_step` is the
validation step the trainer runs (the live loss, retrieval against the
batch's contrary representations).  Under data parallelism the loss reads
both towers' outputs gathered over the ranks, and the eval step's
representations are the global batch's (``parallel.distributed``, the sum
rule).

Under ``torch.profiler`` a step marks its phases (``profiling.span``): the
student's forward ``step.student``, the teacher's ``step.teacher``, the loss
``step.loss``, then :func:`task_common.make_step`'s ``step.backward`` and
``step.optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distillclip_tpu_torch.convert import torch_name_to_jax_path
from distillclip_tpu_torch.losses import LossCalculator
from distillclip_tpu_torch.models import ControlFlags, ImageEncoder, TextEncoder, l2_normalize
from distillclip_tpu_torch.models.frozen_teacher import FrozenTeacher
from distillclip_tpu_torch.models.outputs import TextOutput, VisionOutput
from distillclip_tpu_torch.models.teacher_init import init_layers_with_teacher
from distillclip_tpu_torch.parallel import all_gather
from distillclip_tpu_torch.serving.lclip_score import seeded_init
from distillclip_tpu_torch.training import metrics as M
from distillclip_tpu_torch.training.profiling import span
from distillclip_tpu_torch.training.task_common import (
    adopt_params,
    build_optimizer,
    copy_teacher_embeddings,
    device_of,
    embedding_leaves,
    check_projections,
    gather_output,
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


@dataclasses.dataclass
class DistillTask:
    """The constructor's fields are the JAX task's."""

    student: Any  # Repeat{Vision,Text}Transformer or Image/TextEncoder
    loss_control_para: Dict[str, Any]
    download_root: str = "./.cache"
    teacher_name: str = "ViT-B/32"
    freeze_embed: bool = False
    teacher_need_layers: Optional[Sequence[int]] = None
    model_type: str = "image"
    warm_steps: int = 10
    total_steps: int = 200
    weight_decay: float = 1e-3
    lr: float = 1e-3
    norm: bool = False
    unfreeze_epoch: Optional[int] = None
    teacher_init_type: Optional[str] = None
    teacher_init_step: Optional[int] = None
    compute_dtype: str = "bfloat16"
    grad_clip_norm: Optional[float] = None
    log_grad_norm: bool = False
    accumulate_grad_batches: int = 1

    def __post_init__(self):
        if self.model_type not in ("text", "image"):
            raise ValueError(
                f"the model_type should in ['text', 'image'], but got {self.model_type}")
        self.loss_control = LossCalculator(**self.loss_control_para)
        self.flags: ControlFlags = self.loss_control.control_flags()
        check_projections(self.student, self.flags)
        self._dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        self.teacher = FrozenTeacher(self.teacher_name, self.download_root, self.model_type,
                                     self.teacher_need_layers, self._dtype)
        self._scope = "visual" if self.model_type == "image" else "text"
        self._out_cls = VisionOutput if self.model_type == "image" else TextOutput
        self._mask = None

    # -- state -----------------------------------------------------------------

    def init_params(self, rng, device="cuda") -> Dict[str, torch.Tensor]:
        """Seeded fp32 masters ``{"student.<module path>": tensor}`` on
        ``device``, after the teacher warm start and the embedding copy where
        they are asked for; ``rng`` is a numpy Generator or a seed."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        seeded_init(self.student, rng)
        params = {f"student.{k}": v.detach().clone().float()
                  for k, v in self.student.named_parameters()}
        if self.loss_control.has_params:
            params.update({f"loss_aux.{k}": v
                           for k, v in self.loss_control.init_vit_kd(rng).items()})
        if self.teacher_init_type is not None:
            params = self._warm_start_from_teacher(params)
        if self.model_type == "image" and self.freeze_embed:
            params = self._copy_teacher_embeddings(params)
        return {k: v.to(device) for k, v in params.items()}

    def _warm_start_from_teacher(self, params: Dict[str, torch.Tensor]):
        prefix = f"student.{self._scope}."
        if not isinstance(self.student, (ImageEncoder, TextEncoder)):
            raise ValueError(
                "teacher_init_type requires a plain CLIP-architecture student "
                f"(ImageEncoder/TextEncoder with a '{self._scope}' tower); got "
                f"{type(self.student).__name__}")
        tower = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        warm = init_layers_with_teacher(tower, self.teacher.state(self._scope),
                                        self.teacher_init_type, self.teacher_init_step)
        return {**params, **{prefix + k: v for k, v in warm.items()}}

    def _frozen_paths(self) -> List[str]:
        if not (self.model_type == "image" and self.freeze_embed):
            return []
        return [f"student/{k.replace('.', '/')}" for k, _ in embedding_leaves(self.student)]

    def _copy_teacher_embeddings(self, params: Dict[str, torch.Tensor]):
        return copy_teacher_embeddings(params, "student.", self.student,
                                       self.teacher.state("visual"))

    def make_optimizer(self, steps_per_epoch: int) -> AdamW:
        return build_optimizer(self, steps_per_epoch)

    def trainable_mask(self, params, frozen_embed: bool = False):
        frozen = self._frozen_paths() if frozen_embed else []
        if not frozen:
            return None
        return freeze_mask(params, frozen_paths=frozen, path_of=torch_name_to_jax_path)

    def init_state(self, rng, steps_per_epoch: int, params: Optional[dict] = None,
                   device="cuda", frozen_embed: Optional[bool] = None
                   ) -> Tuple[TrainState, AdamW]:
        """(state, optimizer).  ``params`` are fp32 masters by the port's names
        (``convert.jax_distill_params_to_torch`` makes them from a JAX tree);
        without them the student gets seeded random weights."""
        if params is None:
            params = self.init_params(rng, device)
        else:
            params = adopt_params(self.student, params, device,
                                  loss_aux=self.loss_control.vit_kd_module)
        if frozen_embed is None:
            frozen_embed = self.freeze_embed
        tx = self.make_optimizer(steps_per_epoch)
        self._mask = self.trainable_mask(params, frozen_embed)
        return TrainState(step=0, params=params, opt_state=tx.init(params)), tx

    # -- forward and loss --------------------------------------------------------

    def _prepare_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        x = prepare_inputs(inputs, self._dtype)
        return x if x.is_floating_point() else x.long()

    def _student_forward(self, params, inputs, deterministic: bool, generator):
        """(student output, prepared inputs, the loss's own variables).  The
        student is stochastic (training mode) exactly when not deterministic."""
        with span("step.student"):
            student, aux = split_params(params)
            x = self._prepare_inputs(inputs)
            self.student.train(not deterministic)
            out = torch.func.functional_call(self.student, cast_to_compute(student, self._dtype),
                                             (x, self.flags, generator))
            if isinstance(out, torch.Tensor):        # a weight-share student's pooled rows
                out = self._out_cls(last_representation=out)
            return out, x, aux

    def _finish(self, stu_out, tea_out, aux=None, generator=None):
        with span("step.loss"):
            stu_out, tea_out = gather_output(stu_out, True), gather_output(tea_out, False)
            if self.norm:
                stu_out = dataclasses.replace(
                    stu_out, last_representation=l2_normalize(stu_out.last_representation))
                tea_out = dataclasses.replace(
                    tea_out, last_representation=l2_normalize(tea_out.last_representation))
            loss, parts = self.loss_control(stu_out, tea_out, self.model_type,
                                            vit_kd_variables=aux, generator=generator)
            return loss, (parts, stu_out, tea_out)

    def loss_fn(self, params, inputs, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """(loss, (parts, stu_out, tea_out)) with the teacher live, run with
        the task's flags.  ``generator`` feeds the student's dropout and
        drop-path when not deterministic, then ``vit_kd``'s token mask."""
        stu_out, x, aux = self._student_forward(params, inputs, deterministic, generator)
        with span("step.teacher"), torch.no_grad():
            tea_out = self.teacher.compute(device_of(params))(x, self.flags)
        return self._finish(stu_out, tea_out, aux, generator)

    def _require_cacheable(self) -> None:
        if self.flags.any_tap():
            raise ValueError(
                "cached_teacher requires a loss config without teacher taps "
                f"(per-layer losses); got flags {self.flags}. Run the live "
                "teacher for tap-dependent losses.")

    def loss_fn_cached(self, params, tea_rep, inputs, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None):
        """The teacher's last representations given."""
        stu_out, _, aux = self._student_forward(params, inputs, deterministic, generator)
        with span("step.teacher"):
            tea_out = self._out_cls(last_representation=tea_rep.detach().to(self._dtype))
        return self._finish(stu_out, tea_out, aux, generator)

    def make_teacher_encode(self, device="cuda") -> Callable:
        """``encode(inputs) -> fp32 last representations`` of the teacher, for
        building the train caches."""
        return (self.teacher.image_encode(device) if self.model_type == "image"
                else self.teacher.text_encode(device))

    # -- steps ---------------------------------------------------------------------

    def make_train_step(self, tx: AdamW, deterministic: bool = True, trainable_mask=None,
                        cached_teacher: bool = False, seed: int = 0) -> Callable:
        """``step(state, inputs) -> (state, metrics)``, or with
        ``cached_teacher=True`` ``step(state, tea_rep, inputs)``.
        ``deterministic=False`` switches the student's dropout and drop-path
        on; their draws and ``vit_kd``'s masks come from one generator per
        step function, seeded with ``seed``.  ``trainable_mask=False`` means
        explicitly unfrozen (after ``unfreeze_epoch``); None takes the mask
        ``init_state`` made."""
        if trainable_mask is None:
            trainable_mask = self._mask
        elif trainable_mask is False:
            trainable_mask = None
        if cached_teacher:
            self._require_cacheable()
        elif isinstance(self.student, ImageEncoder):
            # student/teacher selected-layer alignment, checked where the
            # teacher is first needed
            tea, stu = self.teacher.module.selected_layers, self.student.selected_layers
            if len(tea) != len(stu):
                raise ValueError(
                    f"teacher need_layers {tea} length != student need_layers {stu}")
        loss = self.loss_fn_cached if cached_teacher else self.loss_fn
        random = not deterministic or self.loss_control.has_params
        generator_for = step_generator(seed)
        return make_step(
            lambda params, *batch: loss(params, *batch, deterministic,
                                        generator_for(params) if random else None),
            tx, trainable_mask, self.log_grad_norm)

    def make_eval_step(self) -> Callable:
        """``step(state, inputs, contrary_rep) -> (metrics, reps)``: the live
        loss under ``torch.no_grad()`` with the student in eval mode, and
        retrieval of the student's and the teacher's representations against
        ``contrary_rep`` (the other modality's teacher representations).
        The metrics are 0-dim tensors on the state's device (``loss``, the
        parts, ``stu_acc_top{k}`` / ``tea_acc_top{k}``, the student's
        diagonal scores); ``reps`` are ``student``, ``teacher`` and
        ``contrary_rep`` in fp32."""
        random = self.loss_control.has_params

        @torch.no_grad()
        def step(state: TrainState, inputs, contrary_rep):
            device = device_of(state.params)
            generator = torch.Generator(device=device).manual_seed(0) if random else None
            loss, (parts, stu_out, tea_out) = self.loss_fn(state.params, inputs, True, generator)
            contrary_rep = all_gather(contrary_rep)
            stu_logits, tea_logits = M.norm_and_logits(
                contrary_rep, stu_out.last_representation, tea_out.last_representation)[:2]
            metrics = {"loss": loss, **parts}
            for k, v in M.topk_accuracy(stu_logits).items():
                metrics[f"stu_acc_top{k}"] = v
            for k, v in M.topk_accuracy(tea_logits).items():
                metrics[f"tea_acc_top{k}"] = v
            metrics["stu_mean_score"], metrics["stu_softmax_mean_score"] = \
                M.diag_scores(stu_logits)
            return metrics, {"student": stu_out.last_representation.float(),
                             "teacher": tea_out.last_representation.float(),
                             "contrary_rep": contrary_rep.float()}

        return step
