"""AdamW as the configurations train with it (``torch.optim.AdamW`` with a
HuggingFace cosine schedule with warm-up, stepped once an epoch): Adam's
moments with bias correction, eps outside the root, decoupled weight decay
on every parameter, the learning rate read from the schedule before each
update."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(base_lr: float, warmup: int, total: int, unit: int) -> float:
    """``transformers.get_cosine_schedule_with_warmup`` at ``unit`` (an epoch
    count), half a cycle."""
    if unit < warmup:
        return base_lr * unit / max(1, warmup)
    progress = (unit - warmup) / max(1, total - warmup)
    return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


class AdamW:
    def __init__(self, params: dict, lr: float, warmup: int, total: int, weight_decay: float,
                 steps_per_epoch: int, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lambda count: cosine_with_warmup(lr, warmup, total, count // steps_per_epoch)
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps)
            params[k].sub_(lr * (update + self.wd * params[k]))
