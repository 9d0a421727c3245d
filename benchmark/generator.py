"""The one generator of traffic: a mix (``traffic/<mix>.json``) is data, and
this module turns it into the batches a cell sends, from the seed, on the
device.

A mix names its ``inputs`` (in the order the program's call takes them), the
``pairs`` a batch holds and the ``pool`` of distinct batches a run cycles
through; ``caption_len`` bounds the captions' lengths in tokens (the start
and end tokens included).  The shapes (resolution, context length, the
vocabulary's start and end ids, the teacher's embedding width) come from the
configuration.  Every seed gives the same sizes; only the values differ.

* ``images``: uint8 NHWC pixels, uniform; with ``image_grid`` g in the mix,
  a g × g layout of uniform colours a picture, bilinearly upsampled, plus
  uniform noise of ±``image_noise`` levels: pictures that differ as natural
  ones do in their large structure, so that each row's gradient differs.
* ``tokens``: the start id, ids drawn below it, the end id (the largest id,
  where the towers pool) at a length drawn from ``caption_len``, then zeros.
* ``text_rep`` / ``image_rep``: a teacher's cached fp32 representations,
  standard normal.
"""

from __future__ import annotations

import torch

from benchmark.common import TRAFFIC_STREAM, stream_seed

INPUTS = ("images", "tokens", "text_rep", "image_rep")


def _tokens(gen, n: int, shapes: dict, lengths, device) -> torch.Tensor:
    ctx, sot, eot = shapes["context_length"], shapes["sot"], shapes["eot"]
    lo, hi = lengths
    length = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(1, sot, (n, ctx), generator=gen, device=device)
    pos = torch.arange(ctx, device=device).expand(n, ctx)
    ids = torch.where(pos < length, ids, 0)
    ids = torch.where(pos == length - 1, eot, ids)
    ids[:, 0] = sot
    return ids


def _images(gen, n: int, S: int, mix: dict, device) -> torch.Tensor:
    if "image_grid" not in mix:
        return torch.randint(0, 256, (n, S, S, 3), generator=gen, device=device,
                             dtype=torch.uint8)
    g, amp = mix["image_grid"], mix.get("image_noise", 0)
    layout = torch.rand((n, 3, g, g), generator=gen, device=device) * 255.0
    x = torch.nn.functional.interpolate(layout, size=(S, S), mode="bilinear",
                                        align_corners=False)
    x = x + (torch.rand((n, 3, S, S), generator=gen, device=device) * 2.0 - 1.0) * amp
    return x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def make_batch(gen, mix: dict, shapes: dict, device) -> list:
    n, out = mix["pairs"], []
    for kind in mix["inputs"]:
        if kind == "images":
            out.append(_images(gen, n, shapes["image_size"], mix, device))
        elif kind == "tokens":
            out.append(_tokens(gen, n, shapes, mix["caption_len"], device))
        elif kind in ("text_rep", "image_rep"):
            out.append(torch.randn((n, shapes["rep_dim"]), generator=gen, device=device))
        else:
            raise ValueError(f"traffic {mix['name']}: unknown input {kind!r}; known {INPUTS}")
    return out


def pool(mix: dict, shapes: dict, seed: int, device) -> list:
    """``mix["pool"]`` batches, each a list of tensors in ``mix["inputs"]``
    order, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, TRAFFIC_STREAM))
    return [make_batch(gen, mix, shapes, device) for _ in range(mix["pool"])]
