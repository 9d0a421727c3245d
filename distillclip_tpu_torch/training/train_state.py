"""Train state and optimizer with mask-based freezing.

Port of ``distillclip_tpu/training/train_state.py``.  The parameters are fp32
masters in a flat ``{name: tensor}`` dict; the step casts them to the compute
dtype for the forward (:func:`cast_to_compute`, differentiable, so the
gradients arrive on the masters in fp32).  The optimizer reproduces the
arithmetic of ``optax.adamw`` as the JAX package builds it
(``make_optimizer``): optional clipping by the global norm, Adam moments with
bias correction, eps outside the root, decoupled weight decay on every
trainable parameter, the learning rate read from the schedule per update, and
the mean of k micro-batches under ``accumulate_steps``.

Freezing is a ``{name: bool}`` mask (True = trainable) applied to the
gradients and to the updates: masking only the gradients would still let the
weight decay move frozen parameters.

Unlike JAX's immutable arrays, :meth:`TrainState.apply_gradients` updates the
parameters and the moments in place and returns the same state object: at
full width a second copy of the state would only cost memory.  The TPU
layout barrier of the JAX version (``optimization_barrier``) has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from distillclip_tpu_torch.serving.inputs import EMBED_CAST_SKIP_ROWS, prepare_inputs

Params = Dict[str, torch.Tensor]

__all__ = ["AdamW", "EMBED_CAST_SKIP_ROWS", "TrainState", "apply_mask", "cast_to_compute",
           "count_params", "freeze_mask", "global_norm", "make_optimizer", "prepare_inputs"]


def apply_mask(tree: Params, mask: Optional[Dict[str, bool]]) -> Params:
    """Zero the leaves whose mask is False."""
    if mask is None:
        return tree
    return {k: v if mask[k] else torch.zeros_like(v) for k, v in tree.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt(Σ ||leaf||²) in fp32, as ``optax.global_norm``."""
    return torch.sqrt(sum(v.float().square().sum() for v in tree.values()))


class AdamW:
    """``optax.chain([clip_by_global_norm], adamw)``, optionally under
    ``optax.MultiSteps``; the state is a dict of tensors and Python ints."""

    def __init__(self, learning_rate: Callable[[int], float], weight_decay: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip_norm: Optional[float] = None, accumulate_steps: int = 1):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = max(1, int(accumulate_steps or 1))

    def init(self, params: Params) -> dict:
        state = {"count": 0,
                 "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
        if self.accumulate_steps > 1:
            state["mini_step"] = 0
            state["acc_grads"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params):
        """(updates, state): the updates to add to the parameters.  The
        moments in ``state`` are updated in place.  Under accumulation the
        updates are zero until the k-th micro-batch, which steps on the mean
        gradient."""
        if self.accumulate_steps > 1:
            n = state["mini_step"]
            acc = state["acc_grads"]
            for k, g in grads.items():
                acc[k] += (g - acc[k]) / (n + 1)
            state["mini_step"] = (n + 1) % self.accumulate_steps
            if n != self.accumulate_steps - 1:
                return {k: torch.zeros_like(v) for k, v in params.items()}, state
            grads = {k: v.clone() for k, v in acc.items()}
            for v in acc.values():
                v.zero_()
        if self.grad_clip_norm is not None:
            norm = global_norm(grads)
            # optax: unchanged where norm < max_norm, else g / norm * max_norm
            factor = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                 self.grad_clip_norm / norm)
            grads = {k: g * factor for k, g in grads.items()}
        lr = self.learning_rate(state["count"])
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        names = list(grads)
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, [params[k] for k in names], alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        state["count"] = count
        return dict(zip(names, upd)), state


def make_optimizer(learning_rate: Callable[[int], float], weight_decay: float = 1e-3,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   grad_clip_norm: Optional[float] = None,
                   accumulate_steps: int = 1) -> AdamW:
    """AdamW matching torch defaults; weight decay applies to every trainable
    parameter (LN and biases included, like the reference)."""
    return AdamW(learning_rate, weight_decay, b1, b2, eps, grad_clip_norm, accumulate_steps)


@dataclasses.dataclass
class TrainState:
    """Step counter, fp32 master parameters, optimizer state."""

    step: int
    params: Params
    opt_state: dict

    @torch.no_grad()
    def apply_gradients(self, grads: Params, tx: AdamW,
                        trainable_mask: Optional[Dict[str, bool]] = None) -> "TrainState":
        """One optimizer step, in place.  The mask zeroes the gradients and
        the updates of frozen leaves, so neither the moments nor the weight
        decay move them."""
        grads = apply_mask(grads, trainable_mask)
        updates, self.opt_state = tx.update(grads, self.opt_state, self.params)
        updates = apply_mask(updates, trainable_mask)
        names = list(updates)
        torch._foreach_add_([self.params[k] for k in names], [updates[k] for k in names])
        self.step += 1
        return self


def freeze_mask(params: Params, frozen_paths: Sequence[str] = (),
                frozen_prefixes: Sequence[str] = (),
                path_of: Callable[[str], str] = lambda name: name) -> Dict[str, bool]:
    """{name: trainable}: ``frozen_paths`` match exactly, ``frozen_prefixes``
    by startswith, both against ``path_of(name)`` (the JAX package's
    ``a/b/c`` path of the leaf, so that configs freeze the same leaves)."""
    frozen_paths = set(frozen_paths)
    prefixes = tuple(frozen_prefixes)

    def trainable(name: str) -> bool:
        path = path_of(name)
        return path not in frozen_paths and not any(path.startswith(p) for p in prefixes)

    return {name: trainable(name) for name in params}


def count_params(params: Params) -> int:
    return sum(v.numel() for v in params.values())


def cast_to_compute(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """The fp32 leaves cast to the compute dtype for the forward, except 2D
    tables with at least ``EMBED_CAST_SKIP_ROWS`` rows (the vocab embedding:
    its gathered rows are cast instead).  Differentiable: the gradient of a
    cast leaf returns to the master in fp32."""

    def cast(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return x
        if x.ndim == 2 and x.shape[0] >= EMBED_CAST_SKIP_ROWS:
            return x
        return x.to(dtype)

    return {k: cast(v) for k, v in params.items()}
