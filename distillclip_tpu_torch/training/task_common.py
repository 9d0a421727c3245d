"""What the one-tower and the two-tower distillation tasks share beside the
frozen teacher (``models.frozen_teacher``): the embedding copy of
``freeze_embed``, the optimizer's schedule, the train step around a loss
function, and the gathers of data parallelism.

Under data parallelism (``parallel.distributed``: the sum rule) the tasks
hand the loss the outputs of every rank, gathered along their batch axis in
rank order (:func:`gather_output`, :func:`gather_clip_output`; the students'
with their gradient), so every rank evaluates the loss of the global batch;
:func:`make_step` sums the ranks' gradients before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from distillclip_tpu_torch.models.clip import cosine_logits
from distillclip_tpu_torch.models.encoders import ImageEncoder, TextEncoder, projections_for
from distillclip_tpu_torch.models.repeat_vit import RepeatVisionTransformer
from distillclip_tpu_torch.models.outputs import CLIPOutput
from distillclip_tpu_torch.parallel import (
    active,
    all_gather,
    all_reduce_gradients,
    gather_with_grad,
)
from distillclip_tpu_torch.training.profiling import span
from distillclip_tpu_torch.training.schedules import hf_cosine_with_warmup, per_epoch
from distillclip_tpu_torch.training.train_state import (
    AdamW,
    TrainState,
    global_norm,
    make_optimizer,
)


def embedding_leaves(image_student) -> List[Tuple[str, str]]:
    """(student leaf, teacher leaf) of the embeddings ``freeze_embed`` copies
    from the teacher's ``visual`` tower and freezes.  The weight-share
    student's patch bias is not among them and stays trainable, as in the
    reference."""
    if isinstance(image_student, RepeatVisionTransformer):
        return [("patch_kernel", "patch_kernel"), ("cls_token", "class_embedding"),
                ("pos_embed", "positional_embedding")]
    if isinstance(image_student, ImageEncoder):
        return [(f"visual.{k}", k)
                for k in ("patch_kernel", "class_embedding", "positional_embedding")]
    return []


def copy_teacher_embeddings(params: Dict[str, torch.Tensor], prefix: str, image_student,
                            tea: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` with the leaves of :func:`embedding_leaves` under ``prefix``
    replaced by fresh copies of the teacher's (``tea`` is its ``visual`` state):
    cls_token ``[1, 1, D]`` and pos_embed ``[1, N, D]`` take the teacher's
    ``[D]`` and ``[N, D]``."""
    out = dict(params)
    for stu_leaf, tea_leaf in embedding_leaves(image_student):
        name = prefix + stu_leaf
        if params[name].numel() != tea[tea_leaf].numel():
            raise ValueError(
                "freeze_image_embedding copies the teacher's patch/cls/pos embeddings "
                "into the student, which requires matching patch geometry: teacher "
                f"{tea_leaf} {tuple(tea[tea_leaf].shape)} vs student "
                f"{tuple(params[name].shape)}. Match the student's img_size/patch_size/"
                "embed_dim to the teacher or disable freeze_embed.")
        out[name] = tea[tea_leaf].detach().clone().reshape(params[name].shape)
    return out


LOSS_AUX = "loss_aux."


def adopt_params(student: nn.Module, params: dict, device, what: str = "the student",
                 loss_aux: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Given masters as fresh fp32 tensors on ``device``, after checking that
    their names are those of ``student`` (``what`` in the complaint) and, for
    a loss with parameters, of its module ``loss_aux``."""
    want = {f"student.{k}" for k, _ in student.named_parameters()}
    if loss_aux is not None:
        want |= {LOSS_AUX + k for k, _ in loss_aux.named_parameters()}
    if set(params) != want:
        raise ValueError(f"params do not match {what}: missing "
                         f"{sorted(want - set(params))}, unexpected "
                         f"{sorted(set(params) - want)}")
    return {k: torch.as_tensor(v).detach().clone().float().to(device)
            for k, v in params.items()}


def split_params(params: Dict[str, torch.Tensor]):
    """(the student's masters without their ``student.`` prefix, the loss's
    own variables without ``loss_aux.``, or None when there are none)."""
    student = {k[len("student."):]: v for k, v in params.items() if k.startswith("student.")}
    aux = {k[len(LOSS_AUX):]: v for k, v in params.items() if k.startswith(LOSS_AUX)}
    return student, aux or None


def check_projections(tower, flags) -> None:
    """A plain-encoder student narrower or wider than the teacher needs the
    projection leaves the flags call for, no more and no less (the JAX package
    creates them under exactly those flags)."""
    if not isinstance(tower, (ImageEncoder, TextEncoder)) or not tower.is_student:
        return
    width = (tower.visual if isinstance(tower, ImageEncoder) else tower.text).width
    if tower.teacher_width is None or tower.teacher_width == width:
        return
    want = projections_for(flags)
    have = {"project_hidden": hasattr(tower, "hidden_projection"),
            "project_embedding": hasattr(tower, "embedding_projection")}
    if want != have:
        raise ValueError(
            f"{type(tower).__name__} student of width {width} against a teacher of width "
            f"{tower.teacher_width}: the task's losses need {want}, the student was built "
            f"with {have}; construct it with **projections_for(flags)")


def step_generator(seed: int) -> Callable:
    """``generator_for(params)``: one ``torch.Generator`` per device, seeded
    once with ``seed`` and advanced by every draw, so a sequence of steps
    repeats from its seed (the JAX step folds the step count into its key)."""
    made: Dict[torch.device, torch.Generator] = {}

    def generator_for(params: Dict[str, torch.Tensor]) -> torch.Generator:
        device = device_of(params)
        if device not in made:
            made[device] = torch.Generator(device=device).manual_seed(seed)
        return made[device]

    return generator_for


def device_of(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def build_optimizer(task, steps_per_epoch: int) -> AdamW:
    """Cosine-warmup AdamW, the schedule stepped per epoch.  With accumulation
    the optimizer counts updates, of which there are steps_per_epoch // k per
    epoch.  The schedule is kept on the task as ``_lr_schedule``."""
    k = max(1, int(task.accumulate_grad_batches or 1))
    schedule = per_epoch(hf_cosine_with_warmup(task.lr, task.warm_steps, task.total_steps),
                         max(1, steps_per_epoch // k))
    task._lr_schedule = schedule
    return make_optimizer(schedule, weight_decay=task.weight_decay,
                          grad_clip_norm=task.grad_clip_norm, accumulate_steps=k)


# taps stacked over layers, [L, B, ...]: their batch axis is 1
_LAYER_STACKED = ("attention_scores", "attention_probs", "representations")


def gather_output(out, with_grad: bool):
    """A tower's output container with every tensor it holds gathered over
    the ranks along its batch axis; ``with_grad`` for a student's.  The same
    container outside a process group."""
    if not active():
        return out
    gather = gather_with_grad if with_grad else all_gather
    return dataclasses.replace(out, **{
        f.name: gather(getattr(out, f.name), 1 if f.name in _LAYER_STACKED else 0)
        for f in dataclasses.fields(out) if getattr(out, f.name) is not None})


def gather_clip_output(out: CLIPOutput, with_grad: bool) -> CLIPOutput:
    """Both towers' outputs gathered (:func:`gather_output`) and the cosine
    logits of the global batch, by the arithmetic of ``CLIPModel.forward``."""
    if not active():
        return out
    vis = gather_output(out.visual_output, with_grad)
    txt = gather_output(out.text_output, with_grad)
    logits = cosine_logits(vis.last_representation, txt.last_representation)
    return CLIPOutput(visual_output=vis, text_output=txt, i2t_logits=logits,
                      t2i_logits=logits.t())


def make_step(loss_fn: Callable, tx: AdamW, trainable_mask, log_grad_norm: bool) -> Callable:
    """``step(state, *batch) -> (state, metrics)`` around ``loss_fn(params,
    *batch) -> (loss, (parts, student out, teacher out))``.  The metrics are
    0-dim tensors on the state's device: ``loss``, the loss parts, and
    ``grad_norm`` under ``log_grad_norm``.  Under data parallelism the loss
    is the global batch's and the students' gradients are summed over the
    ranks before the norm and the update; the loss's own variables
    (``loss_aux``) are not summed: they act after the gather, so each rank's
    gradient of them is already the whole one.  The gradients and their sum
    run in the span ``step.backward``, the norm and the update in
    ``step.optimizer`` (``profiling.span``)."""

    def step(state: TrainState, *batch):
        names = list(state.params)
        leaves = [state.params[k].requires_grad_() for k in names]
        loss, (parts, _, _) = loss_fn(dict(zip(names, leaves)), *batch)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for k, p, g in zip(names, leaves, grads)}
            # the students' shares are summed; the loss's own variables act on
            # the gathered outputs, so every rank already holds their whole gradient
            all_reduce_gradients({k: g for k, g in grads.items() if not k.startswith(LOSS_AUX)})
            for p in leaves:
                p.requires_grad_(False)
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        with span("step.optimizer"):
            if log_grad_norm:
                metrics["grad_norm"] = global_norm(grads)
            return state.apply_gradients(grads, tx, trainable_mask), metrics

    return step
