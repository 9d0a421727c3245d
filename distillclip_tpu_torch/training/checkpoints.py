"""Checkpoints of the port: a nested dict of tensors in one ``torch.save`` file.

Port of ``distillclip_tpu/training/checkpoints.py``'s ``save_pytree``,
``restore_pytree`` and ``restore_tower_params``.  The JAX package writes
Orbax directories; the port writes one file holding the same tree, with the
port's parameter names as the keys: a stage checkpoint is
``{"params": {"student": <tower tree>}}`` (or ``{"state": {"params": ...}}``),
where a tower tree nests the tower's state dict on its dotted names
(:func:`nest`), and a stage-3 checkpoint holds ``image_tower`` and
``text_tower`` under ``student``.

A JAX checkpoint crosses in a process that has both packages: the JAX
package's ``restore_pytree``, then ``convert.jax_*_to_torch``, then
:func:`save_pytree` here.  The port reads no Orbax.  The retention policy
(``CheckpointManager``) waits for the trainer (ROADMAP queue 1: the trainer).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`nest`: leaves by their dotted path."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _to_tensors(tree):
    if isinstance(tree, Mapping):
        return {str(k): _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return torch.from_numpy(np.array(tree))
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts of tensors or arrays) to ``path``, on the
    CPU, through a temporary file so that a reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_tensors(tree), tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    """The tree :func:`save_pytree` wrote, on the CPU; with ``template`` its
    structure is checked against the template's and each leaf takes the
    template leaf's dtype."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return tree if template is None else _match(tree, template)


def _match(tree: Any, template: Any) -> Any:
    got, want = flatten(tree), flatten(template)
    bad = sorted(k for k in set(got) | set(want)
                 if k not in got or k not in want or tuple(got[k].shape) != tuple(want[k].shape))
    if bad:
        raise ValueError("checkpoint tower structure mismatch: "
                         + ", ".join(f"{k} got {_shape(got.get(k))} want {_shape(want.get(k))}"
                                     for k in bad[:8])
                         + (f" (and {len(bad) - 8} more)" if len(bad) > 8 else ""))
    return nest({k: got[k].to(want[k].dtype) for k in want})


def _shape(t) -> str:
    return "nothing" if t is None else str(tuple(t.shape))


def restore_tower_params(ckpt_path: str, template: Mapping[str, torch.Tensor],
                         tower: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One student tower's state dict from a stage checkpoint.

    Accepts a trainer checkpoint (``{"state": {"params": {"student": ...}}}``),
    a bare stage tree (``{"params": {"student": ...}}`` or ``{"student":
    ...}``) or a bare tower tree; ``tower`` (``image_tower`` / ``text_tower``)
    selects one tower of a stage-3 checkpoint.  ``template`` is the tower's
    state dict: names and shapes must match it exactly, and the values take
    its dtypes."""
    restored = restore_pytree(ckpt_path)
    for key in ("state", "params", "student"):
        if isinstance(restored, Mapping) and key in restored:
            restored = restored[key]
    if tower is not None and isinstance(restored, Mapping) and tower in restored:
        restored = restored[tower]
    return flatten(_match(restored, nest(dict(template))))
