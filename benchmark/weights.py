"""Weights the benchmark makes from a seed, on the device, in a few large
calls, and hands to the program and to the reference alike.

* :func:`student_masters`: fp32 masters for every parameter a student module
  names, by the weight-share students' init rules (DistillCLIP's
  ``_init_weights``): LayerNorm scales 1, biases 0, embedding tables
  N(0, 0.02), every other weight N(0, 0.02) cut at 2σ.  One normal draw fills
  them all.
* :func:`clip_checkpoint`: a CLIP checkpoint (OpenAI's key names and
  layouts, fp16) of a published geometry, by CLIP's own init scheme
  (``clip/model.py``: ``initialize_parameters``), drawn on the device from the
  configuration's fixed teacher seed and written once per checkout: the
  teacher is a fixed published checkpoint in every deployment, so every run
  of a configuration loads the same one.  The program's teacher loads only
  from a file.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from benchmark.common import CACHE_DIR, WEIGHT_STREAM, stream_seed

UNIT_LEAVES = ("scale",)
ZERO_LEAVES = ("bias", "patch_bias")


def student_masters(shapes: dict, seed: int, device, std: float = 0.02) -> dict:
    """``{name: fp32 tensor}`` for ``shapes`` (``{name: shape}``)."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    leaf = {n: n.rsplit(".", 1)[-1] for n in shapes}
    drawn = [n for n in shapes if leaf[n] not in UNIT_LEAVES + ZERO_LEAVES]
    sizes = [torch.Size(shapes[n]).numel() for n in drawn]
    flat = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    out = {}
    for n, part in zip(drawn, flat.split(sizes)):
        part = part.view(shapes[n])
        out[n] = part.mul_(std) if leaf[n] == "embedding" else part.clamp_(-2.0, 2.0).mul_(std)
    for n in shapes:
        if leaf[n] in UNIT_LEAVES:
            out[n] = torch.ones(shapes[n], device=device)
        elif leaf[n] in ZERO_LEAVES:
            out[n] = torch.zeros(shapes[n], device=device)
    return {n: out[n] for n in shapes}


def _resblock_shapes(pre: str, width: int) -> dict:
    return {
        pre + "ln_1.weight": (width,), pre + "ln_1.bias": (width,),
        pre + "attn.in_proj_weight": (3 * width, width), pre + "attn.in_proj_bias": (3 * width,),
        pre + "attn.out_proj.weight": (width, width), pre + "attn.out_proj.bias": (width,),
        pre + "ln_2.weight": (width,), pre + "ln_2.bias": (width,),
        pre + "mlp.c_fc.weight": (4 * width, width), pre + "mlp.c_fc.bias": (4 * width,),
        pre + "mlp.c_proj.weight": (width, 4 * width), pre + "mlp.c_proj.bias": (width,),
    }


def _clip_std(name: str, width: int, layers: int, shape) -> float:
    """CLIP's ``initialize_parameters`` (and PyTorch's default for conv1, by
    its fan-in); 0 for biases, 1 marks a LayerNorm weight."""
    if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight",
                      "ln_final.weight")):
        return 1.0
    if name.endswith("bias"):
        return 0.0
    if name == "token_embedding.weight":
        return 0.02
    if name == "positional_embedding":
        return 0.01
    if name.endswith("in_proj_weight"):
        return width ** -0.5
    if name.endswith(("out_proj.weight", "c_proj.weight")):
        return width ** -0.5 * (2 * layers) ** -0.5
    if name.endswith("c_fc.weight"):
        return (2 * width) ** -0.5
    if name == "visual.conv1.weight":
        return (shape[1] * shape[2] * shape[3]) ** -0.5
    return width ** -0.5      # class and positional embedding, the projections


def clip_shapes(t: dict) -> dict:
    """The state dict's shapes of a CLIP geometry: the vision tower, and the
    text tower unless ``t["text"]`` is false (then only ``text_projection``,
    which states the embedding width)."""
    vw, S, res = t["vision_width"], t["vision_patch_size"], t["image_resolution"]
    shapes = {"visual.conv1.weight": (vw, 3, S, S), "visual.class_embedding": (vw,),
              "visual.positional_embedding": ((res // S) ** 2 + 1, vw),
              "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
              "visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,),
              "visual.proj": (vw, t["embed_dim"])}
    for i in range(t["vision_layers"]):
        shapes.update(_resblock_shapes(f"visual.transformer.resblocks.{i}.", vw))
    tw = t["transformer_width"]
    shapes["text_projection"] = (tw, t["embed_dim"])
    if t.get("text", True):
        shapes.update({"token_embedding.weight": (t["vocab_size"], tw),
                       "positional_embedding": (t["context_length"], tw),
                       "ln_final.weight": (tw,), "ln_final.bias": (tw,)})
        for i in range(t["transformer_layers"]):
            shapes.update(_resblock_shapes(f"transformer.resblocks.{i}.", tw))
    return shapes


@torch.no_grad()
def clip_state_dict(t: dict, device) -> dict:
    """fp16 ``{key: tensor}`` on ``device`` from ``t["seed"]``."""
    gen = torch.Generator(device=device).manual_seed(int(t["seed"]))
    shapes = clip_shapes(t)
    sizes = {k: torch.Size(s).numel() for k, s in shapes.items()}
    flat = torch.empty(sum(sizes.values()), device=device).normal_(generator=gen)
    out = {}
    for (k, shape), part in zip(shapes.items(), flat.split(list(sizes.values()))):
        visual = k.startswith("visual.")
        width = t["vision_width"] if visual else t["transformer_width"]
        layers = t["vision_layers"] if visual else t["transformer_layers"]
        std = _clip_std(k, width, layers, shape)
        if std == 1.0:
            v = torch.ones(shape, device=device)
        elif std == 0.0:
            v = torch.zeros(shape, device=device)
        else:
            v = part.view(shape) * std
        out[k] = v.half()
    return out


# the teacher files this process wrote
WRITTEN = []


def clip_checkpoint(t: dict, device) -> Path:
    """The teacher's file under the benchmark's cache, written on first use
    (a fixed name from a hash of the geometry and its seed)."""
    key = hashlib.sha256(json.dumps(t, sort_keys=True).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"teacher_{key}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        sd = {k: v.cpu() for k, v in clip_state_dict(t, device).items()}
        tmp = path.with_suffix(".tmp")
        torch.save(sd, tmp)
        os.replace(tmp, path)
        WRITTEN.append(path)
    return path


def load_checkpoint(path: Path, device) -> dict:
    """The teacher's file as fp32 tensors on ``device`` (the reference's copy)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device).float() for k, v in sd.items()}
