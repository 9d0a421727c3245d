"""The reference's first train steps, computed in blocks of rows so that they
fit beside nothing else on the card.

A step: the targets (the frozen teacher's representations, or the cached
ones a batch carries) without a gradient, block by block; the students'
outputs without a gradient, block by block; the loss and its gradient with
respect to those outputs on the whole batch (the contrastive terms need every
row); then each block again with a gradient, its backward seeded with its
rows of that gradient, summing the parameters' gradients; then AdamW.

What it reads for the comparison: each step's loss, the first step's loss
parts, teacher representations and student outputs, each leaf's gradient
norm at the first step, and each leaf's change after the last.  The teacher
may be computed in a precision of its own (the control that lowers the
teacher alone).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from benchmark.reference.numerics import Precision
from benchmark.reference.optim import AdamW


def _blocks(batch: Sequence[torch.Tensor], rows: int):
    n = batch[0].shape[0]
    for i in range(0, n, rows):
        yield [x[i:i + rows] for x in batch]


def _cat(parts: list) -> list:
    return [torch.cat(xs, dim=0) for xs in zip(*parts)]


def loss_and_grads(model, params: dict, batch: Sequence[torch.Tensor], P: Precision,
                   rows: int, PT: Precision = None):
    """(loss, ``{name: gradient}``, ``{part: value}``, the targets, the
    students' outputs) of one batch; ``PT`` is the teacher's precision
    (``P`` by default)."""
    with torch.no_grad():
        targets = _cat([model.targets(b, PT or P) for b in _blocks(batch, rows)])
        outs = _cat([model.student(params, b, P) for b in _blocks(batch, rows)])
    outs = [o.requires_grad_() for o in outs]
    loss, parts = model.loss(outs, targets)
    douts = torch.autograd.grad(loss, outs)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    for i, b in enumerate(_blocks(batch, rows)):
        part = model.student(leaves, b, P)
        torch.autograd.backward(part, [d[i * rows:i * rows + b[0].shape[0]] for d in douts])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    parts = {k: float(v.detach()) for k, v in parts.items()}
    outs = [o.detach() for o in outs]
    return float(loss.detach()), grads, parts, targets, outs


def train_readings(model, params0: dict, batches: Sequence[Sequence[torch.Tensor]],
                   make_optimizer: Callable[[dict], AdamW], P: Precision, rows: int,
                   half_batch: bool = False, PT: Precision = None) -> dict:
    """``losses`` of each step; of the first, ``parts1`` its loss parts,
    ``teacher1`` the representations the teacher computed (not those a
    batch carries), ``students1`` the students' outputs and ``grad1`` each
    leaf's gradient norm (``grad1_vec`` the gradient itself); ``change``
    each leaf's change after the last.  ``half_batch`` computes every step
    on the first half of its rows (a fault the comparison has to catch);
    ``PT`` is the teacher's precision (``P`` by default)."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    opt = make_optimizer(params)
    losses, first = [], None
    for batch in batches:
        if half_batch:
            batch = [x[:x.shape[0] // 2] for x in batch]
        loss, grads, parts, targets, outs = loss_and_grads(model, params, batch, P, rows, PT)
        losses.append(loss)
        if first is None:
            first = {"parts1": parts, "students1": outs,
                     "teacher1": [targets[i] for i in model.live_targets],
                     "grad1": {k: float(g.norm()) for k, g in grads.items()},
                     "grad1_vec": {k: g.clone() for k, g in grads.items()}}
        opt.step(params, grads)
        del grads
    change = {k: float((params[k] - params0[k]).norm()) for k in params}
    return {"losses": losses, **first, "change": change}
