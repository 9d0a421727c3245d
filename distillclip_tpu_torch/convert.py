"""JAX parameters -> state dicts of the port's towers (students, plain CLIP
encoders and the teacher), and the tasks' parameter trees -> the port's fp32
masters.

The port's module tree mirrors the JAX parameter tree name for name, so the
mapping is a renaming and no value changes:

=====================================  =====================================
JAX (``params`` of a student tower)    port state dict
=====================================  =====================================
``patch_kernel`` [P·P·3, D]            ``patch_kernel`` (image)
``patch_bias``, ``cls_token`` [1,1,D]  same names (image)
``pos_embed`` [1,N,D] / [ctx,D]        ``pos_embed``
``patch_embed/embed/embedding``        ``patch_embed.embed.embedding`` (text)
``patch_embed/expand/{kernel,bias}``   ``patch_embed.expand.*`` (compression)
``blocks_{b}/norm1_{r}/{scale,bias}``  ``blocks.{b}.norm1.{r}.*`` (and norm2)
``blocks_{b}/attn/qkv/{kernel,bias}``  ``blocks.{b}.attn.qkv.*`` (no text bias)
``blocks_{b}/attn/conv_l`` [R,H,H]     ``blocks.{b}.attn.conv_l`` (and conv_w)
``blocks_{b}/attn/proj/*``             ``blocks.{b}.attn.proj.*``
``blocks_{b}/mlp/fc1/*``, ``fc2/*``    ``blocks.{b}.mlp.fc1.*``, ``fc2.*``
``norm/{scale,bias}``, ``head/*``      ``norm.*``, ``head.*``
=====================================  =====================================

The plain CLIP encoders and the teacher (``ImageEncoder`` / ``TextEncoder``,
trees under a ``visual`` / ``text`` scope) map the same way, with
``transformer/resblocks_{i}/...`` becoming ``transformer.resblocks.{i}....``
(:func:`jax_encoder_to_torch`, :func:`jax_teacher_params_to_torch`).

The stage-3 task's tree ``{"student": {"image_tower": ..., "text_tower": ...}}``
maps to ``student.image_tower.<name>`` / ``student.text_tower.<name>``
(:func:`jax_dual_params_to_torch`); :func:`torch_name_to_jax_path` is the
inverse on names, so a gradient or an updated parameter of the port can be
laid beside its JAX leaf.

A student encoder's ``hidden_projection`` / ``embedding_projection`` map like
any other Dense.  The ViTKD loss's variables (``loss_aux`` beside ``student``
in a task's tree) map to ``loss_aux.<name>``: ``align_low_{i}/kernel`` ->
``align_low.{i}.kernel``, ``mask_token`` as it is, and the generation
convolutions ``generation_conv1_{i}/kernel`` ``[3, 3, in, out]`` ->
``generation_conv1.{i}.weight`` ``[out, in, 3, 3]`` (Flax's HWIO kernel on
NHWC tokens against torch's OIHW on NCHW): the one leaf whose values move
(:func:`jax_loss_aux_to_torch`).

Dense kernels stay ``[in, out]`` (Flax's layout, not torch.nn.Linear's
``[out, in]``): the port's ``Dense`` computes ``x @ kernel`` and its
LN-prologue kernels (K1, K2) read W as ``[C, N]`` row-major, so nothing is
transposed.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# a student encoder's width projections, beside its tower's scope
_PROJECTIONS = ("hidden_projection", "embedding_projection")

_REQUIRED = {
    "image": ("patch_kernel", "patch_bias", "cls_token", "pos_embed"),
    "text": ("pos_embed", "patch_embed.embed.embedding"),
}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


_INDEXED = r"blocks|resblocks|norm1|norm2|align_low|align_high|generation_conv1|generation_conv2"


def _torch_name(jax_path: str) -> str:
    name = jax_path.replace("/", ".")
    return re.sub(rf"\b({_INDEXED})_(\d+)\b", r"\1.\2", name)


def _renamed(params: Mapping) -> dict:
    """A JAX tree (optionally under ``"params"``) as ``{port name: fp32 tensor}``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    return {_torch_name(k): torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _flatten(params).items()}


def jax_student_to_torch(params: Mapping, tower: str) -> dict:
    """State dict for ``Repeat{Vision,Text}Transformer`` from a JAX student's
    params: a nested dict (optionally under ``"params"``) or a flat dict with
    ``/``-joined keys, with array values.  ``tower`` is ``"image"`` or
    ``"text"``; the tower's own parameters must be present."""
    if tower not in _REQUIRED:
        raise ValueError(f"tower must be 'image' or 'text', got {tower!r}")
    state = _renamed(params)
    missing = [k for k in _REQUIRED[tower] if k not in state]
    other = "text" if tower == "image" else "image"
    foreign = [k for k in _REQUIRED[other] if k in state and k not in _REQUIRED[tower]]
    if missing or foreign:
        raise ValueError(f"not a JAX {tower} student: missing {missing}, "
                         f"{other}-tower keys {foreign}")
    return state


def jax_encoder_to_torch(params: Mapping, tower: str) -> dict:
    """State dict for ``ImageEncoder`` / ``TextEncoder`` (``visual.*`` /
    ``text.*``, and a student's width projections beside the tower) from the
    JAX encoder's params; ``tower`` is ``"image"`` or ``"text"``."""
    scope = {"image": "visual", "text": "text"}.get(tower)
    if scope is None:
        raise ValueError(f"tower must be 'image' or 'text', got {tower!r}")
    state = _renamed(params)
    own = (scope + ".",) + tuple(p + "." for p in _PROJECTIONS)
    foreign = sorted(k for k in state if not k.startswith(own))
    if not state or foreign:
        raise ValueError(f"not a JAX {tower} encoder (scope {scope!r}): keys {foreign[:4]}")
    return state


def jax_teacher_params_to_torch(params: Mapping) -> dict:
    """State dict for the port's teacher from the JAX package's teacher
    variables: ``{"image_tower": {"visual": ...}, "text_tower": {"text": ...}}``
    for ``teacher_load(..., "all")`` (a ``CLIPModel``), or one tower's
    ``{"visual": ...}`` / ``{"text": ...}``."""
    state = _renamed(params)
    scopes = ("image_tower.visual.", "text_tower.text.", "visual.", "text.")
    foreign = sorted(k for k in state if not k.startswith(scopes))
    if not state or foreign:
        raise ValueError(f"not a JAX CLIP teacher tree: keys {foreign[:4]}")
    return state


def _tower_to_torch(params: Mapping, kind: str) -> dict:
    """A student tower of either architecture, told apart by its scope."""
    inner = params["params"] if "params" in params else params
    if set(inner) - set(_PROJECTIONS) == {"visual" if kind == "image" else "text"}:
        return jax_encoder_to_torch(params, kind)
    return jax_student_to_torch(params, kind)


def jax_loss_aux_to_torch(loss_aux: Mapping) -> dict:
    """``{"loss_aux.<name>": fp32 tensor}`` from the ViTKD variables of a JAX
    task's tree (``params["loss_aux"]``): the convolution kernels go from
    ``[3, 3, in, out]`` to ``[out, in, 3, 3]``."""
    out = {}
    for name, v in _renamed(loss_aux).items():
        if "generation_conv" in name and name.endswith(".kernel"):
            name, v = name[:-len("kernel")] + "weight", v.permute(3, 2, 0, 1).contiguous()
        out[f"loss_aux.{name}"] = v
    return out


def _check_top_level(params: Mapping) -> None:
    if not {"student"} <= set(params) <= {"student", "loss_aux"}:
        raise ValueError("expected the tree {'student': ...} (and 'loss_aux' for a loss with "
                         f"parameters), got top-level keys {sorted(params)}")


def jax_distill_params_to_torch(params: Mapping, model_type: str) -> dict:
    """fp32 masters ``{"student.<name>": tensor}`` (and ``loss_aux.<name>``)
    for ``DistillTask.init_state`` from the JAX one-tower task's tree
    ``{"student": ...[, "loss_aux": ...]}``."""
    _check_top_level(params)
    out = {f"student.{k}": v
           for k, v in _tower_to_torch(params["student"], model_type).items()}
    out.update(jax_loss_aux_to_torch(params.get("loss_aux", {})))
    return out


def torch_name_to_jax_path(name: str) -> str:
    """``student.image_tower.blocks.0.norm1.1.scale`` ->
    ``student/image_tower/blocks_0/norm1_1/scale``: the inverse of the
    renaming above (a convolution's ``weight`` is the JAX ``kernel``; its
    values are laid out differently, see :func:`jax_loss_aux_to_torch`)."""
    if name.startswith("loss_aux.") and name.endswith(".weight"):
        name = name[:-len("weight")] + "kernel"
    return re.sub(rf"\b({_INDEXED})\.(\d+)\b", r"\1_\2", name).replace(".", "/")


def jax_dual_params_to_torch(params: Mapping) -> dict:
    """fp32 masters ``{"student.image_tower.<name>": tensor, ...}`` for
    ``DualDistillTask.init_state`` from the JAX task's parameter tree
    ``{"student": {"image_tower": ..., "text_tower": ...}}`` (arrays as
    values), with ``loss_aux`` beside ``student`` when a loss has parameters."""
    _check_top_level(params)
    if set(params["student"]) != {"image_tower", "text_tower"}:
        raise ValueError("expected the tree {'student': {'image_tower': ..., 'text_tower': "
                         f"...}}}}, got student keys {sorted(params['student'])}")
    out = jax_loss_aux_to_torch(params.get("loss_aux", {}))
    for tower, kind in (("image_tower", "image"), ("text_tower", "text")):
        for k, v in _tower_to_torch(params["student"][tower], kind).items():
            out[f"student.{tower}.{k}"] = v
    return out
