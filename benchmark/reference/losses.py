"""The distillation losses of the final configurations, from DistillCLIP's
loss modules (``model/component/loss/`` of ForJadeForest/DistillCLIP) and
its ``LossCalculator`` weighting: each named loss times its ``loss_scale``
(default 1) and its ``percent`` (default 1 / the number of losses); a
one-tower total sums the losses that are not image-text losses; the
two-tower total is half the sum of the two towers' totals plus the weighted
image-text losses.  The contrastive logits are raw cosines (no logit scale).

Each total comes with its parts: every loss times its ``loss_scale`` (not its
``percent``), named as the one-tower loss (``out_l1``), the two-tower
path's ``image_`` / ``text_`` prefix of it, or the image-text loss's name.
"""

from __future__ import annotations

import torch

from benchmark.reference.numerics import unit

IMAGE_TEXT = ("cos_diff",)


def out_l1(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``nn.L1Loss()``: mean |s − t|."""
    return (s - t).abs().mean()


def out_cos(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``nn.CosineEmbeddingLoss()`` with target 1: mean(1 − cos), the 1e-8 on
    the product of the norms."""
    cos = (s * t).sum(dim=1) / (s.norm(dim=1) * t.norm(dim=1) + 1e-8)
    return (1.0 - cos).mean()


def _off_diagonal(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return x.flatten()[:-1].view(n - 1, n + 1)[:, 1:].flatten()


def cos_diff(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pull the diagonal cosines up to the teacher's, push the off-diagonal
    ones below the teacher's."""
    pos = torch.relu(torch.diagonal(t) - torch.diagonal(s)).mean()
    neg = torch.relu(_off_diagonal(s) - _off_diagonal(t)).mean()
    return pos + neg


ONE_TOWER = {"out_l1": out_l1, "out_cos": out_cos}


def _weights(loss: dict):
    names = list(loss["loss_name"])
    for n in names:
        if n not in ONE_TOWER and n not in IMAGE_TEXT:
            raise NotImplementedError(f"the reference has no loss {n!r}")
    scale = {n: (loss.get("loss_scale") or {}).get(n, 1.0) for n in names}
    percent = dict(loss.get("percent") or {})
    missing = [n for n in names if n not in percent]
    share = (1.0 - sum(percent.values())) / len(missing) if missing else 0.0
    percent.update({n: share for n in missing})
    return names, scale, percent


def one_tower(loss: dict, s: torch.Tensor, t: torch.Tensor) -> tuple:
    """(total, parts) of one tower."""
    names, scale, percent = _weights(loss)
    parts = {n: ONE_TOWER[n](s, t) * scale[n] for n in names if n in ONE_TOWER}
    return sum(parts[n] * percent[n] for n in parts), parts


def two_tower(loss: dict, s_img: torch.Tensor, s_txt: torch.Tensor, t_img: torch.Tensor,
              t_txt: torch.Tensor) -> tuple:
    """(total, parts) of both towers and the image-text losses."""
    names, scale, percent = _weights(loss)
    image, image_parts = one_tower(loss, s_img, t_img)
    text, text_parts = one_tower(loss, s_txt, t_txt)
    total = 0.5 * (image + text)
    parts = {**{"image_" + n: v for n, v in image_parts.items()},
             **{"text_" + n: v for n, v in text_parts.items()}}
    if "cos_diff" in names:
        s_logits = unit(s_img) @ unit(s_txt).t()
        t_logits = unit(t_img) @ unit(t_txt).t()
        cd = 0.5 * (cos_diff(s_logits, t_logits) + cos_diff(s_logits.t(), t_logits.t()))
        parts["cos_diff"] = cd * scale["cos_diff"]
        total = total + parts["cos_diff"] * percent["cos_diff"]
    return total, parts
