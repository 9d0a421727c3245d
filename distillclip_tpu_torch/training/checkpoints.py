"""Checkpoints of the port: a nested dict of tensors in one ``torch.save`` file.

Port of ``distillclip_tpu/training/checkpoints.py``: ``save_pytree``,
``restore_pytree``, ``restore_tower_params`` and the trainer's retention
policy, ``CheckpointManager``.  The JAX package writes
Orbax directories; the port writes one file holding the same tree, with the
port's parameter names as the keys: a stage checkpoint is
``{"params": {"student": <tower tree>}}`` (or ``{"state": {"params": ...}}``),
where a tower tree nests the tower's state dict on its dotted names
(:func:`nest`), and a stage-3 checkpoint holds ``image_tower`` and
``text_tower`` under ``student``.

A JAX checkpoint crosses in a process that has both packages: the JAX
package's ``restore_pytree``, then ``convert.jax_*_to_torch``, then
:func:`save_pytree` here.  The port reads no Orbax.

A trainer checkpoint is ``{"state": state_tree(state), "epoch": e}``:
:func:`state_tree` gives a ``TrainState`` its tree form (step, nested masters,
optimizer state, counters as 0-dim int64 tensors), :func:`load_state` copies
such a tree back into a state of the same structure, in place, on the state's
device, with the counters as ints, and :func:`restore_state` does both halves
of a resume.  ``CheckpointManager`` keeps the JAX package's entry names and
``index.json``, one file an entry where JAX writes an Orbax directory.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from distillclip_tpu_torch.parallel import barrier, is_main


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


def state_tree(state) -> Dict[str, Any]:
    """A ``TrainState`` as a tree of tensors: ``{"step", "params",
    "opt_state"}``, the masters and each dict of the optimizer state nested on
    their dotted names, every int a 0-dim int64 tensor."""
    def leaf(v):
        if isinstance(v, Mapping):
            return nest(dict(v))
        return torch.tensor(v, dtype=torch.int64) if isinstance(v, int) else v

    return {"step": leaf(state.step), "params": nest(state.params),
            "opt_state": {k: leaf(v) for k, v in state.opt_state.items()}}


@torch.no_grad()
def load_state(state, tree: Mapping[str, Any]):
    """Copy ``tree`` (:func:`state_tree`'s form, on any device) into ``state``
    in place and return it: tensors keep their device and dtype, counters come
    back as ints.  The structure is checked against the state's own."""
    tree = _match(tree, state_tree(state))

    def put(dst, src):
        if isinstance(dst, Mapping):
            src = flatten(src)
            for k, v in dst.items():
                v.copy_(src[k])
            return dst
        if isinstance(dst, int):
            return int(src)
        dst.copy_(src)
        return dst

    state.step = int(tree["step"])
    put(state.params, tree["params"])
    for k, v in state.opt_state.items():
        state.opt_state[k] = put(v, tree["opt_state"][k])
    return state


def restore_state(path: str, state) -> int:
    """Load the trainer checkpoint at ``path`` (``{"state": ..., "epoch":
    e}``) into ``state`` in place; returns e."""
    restored = restore_pytree(path, {"state": state_tree(state), "epoch": torch.tensor(0)})
    load_state(state, restored["state"])
    return int(restored["epoch"])


class CheckpointManager:
    """Top-k by two metrics, plus ``last``.

    Keeps the union of the ``top_k`` entries by ``acc_metric`` (highest) and
    the ``top_k`` by ``loss_metric`` (lowest); a metric that is None does not
    compete for that metric's slots.  Each entry is one file named
    ``epoch{e}-acc{acc:.3f}-loss{loss:.5f}`` (``na`` for a missing metric),
    ``last`` a copy of the newest, and ``index.json`` lists the entries kept
    (``name``, ``epoch``, ``acc``, ``loss``), as in the JAX package, which
    writes Orbax directories under the same names."""

    def __init__(self, directory: str, top_k: int = 2, acc_metric: str = "stu_acc_top1",
                 loss_metric: str = "loss"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.top_k = top_k
        self.acc_metric = acc_metric
        self.loss_metric = loss_metric
        self._index_path = os.path.join(self.directory, "index.json")
        self._index: Dict[str, Any] = {"entries": []}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _write_index(self):
        tmp = f"{self._index_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f, indent=2)
        os.replace(tmp, self._index_path)

    def _refresh_index(self):
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def save_epoch(self, epoch: int, tree: Any, metrics: Dict[str, Optional[float]]) -> str:
        """Write the epoch's entry and refresh ``last``; returns the entry's
        path (removed again at once if it does not make the cut).  Every rank
        calls it: the first writes, the others wait and read the index."""
        acc = metrics.get(self.acc_metric)
        loss = metrics.get(self.loss_metric)
        acc = float(acc) if acc is not None else None
        loss = float(loss) if loss is not None else None
        acc_s = f"{acc:.3f}" if acc is not None else "na"
        loss_s = f"{loss:.5f}" if loss is not None else "na"
        name = f"epoch{epoch}-acc{acc_s}-loss{loss_s}"
        path = os.path.join(self.directory, name)
        if is_main():
            save_pytree(path, tree)
            last = os.path.join(self.directory, "last")
            tmp = f"{last}.{os.getpid()}.tmp"
            shutil.copyfile(path, tmp)
            os.replace(tmp, last)
            self._index["entries"].append({"name": name, "epoch": epoch, "acc": acc,
                                           "loss": loss})
            self._gc()
            self._write_index()
        barrier()
        if not is_main():
            self._refresh_index()
        return path

    def _gc(self):
        entries = self._index["entries"]
        by_acc = sorted((e for e in entries if e["acc"] is not None),
                        key=lambda e: -e["acc"])[:self.top_k]
        by_loss = sorted((e for e in entries if e["loss"] is not None),
                         key=lambda e: e["loss"])[:self.top_k]
        keep = {e["name"] for e in by_acc} | {e["name"] for e in by_loss}
        for e in list(entries):
            if e["name"] not in keep:
                p = os.path.join(self.directory, e["name"])
                if os.path.exists(p):
                    os.remove(p)
                entries.remove(e)

    def best(self, metric: str = "acc") -> Optional[str]:
        if not is_main():
            self._refresh_index()
        if metric == "acc":
            ranked = [e for e in self._index["entries"] if e["acc"] is not None]
            e = max(ranked, key=lambda e: e["acc"], default=None)
        else:
            ranked = [e for e in self._index["entries"] if e["loss"] is not None]
            e = min(ranked, key=lambda e: e["loss"], default=None)
        return os.path.join(self.directory, e["name"]) if e else None

    def last(self) -> Optional[str]:
        p = os.path.join(self.directory, "last")
        return p if os.path.exists(p) else None
