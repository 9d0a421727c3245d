"""The builder of the EVA-02-CLIP configurations (``"builder": "eva_clip"``):
stage 1 of DistillCLIP against an EVA-02-CLIP vision tower as the frozen
teacher.

Everything of the student (its geometry, the masters, the step through
``training.DistillTask``, the hooks that keep what the loss read, the
optimizer and the loss of the reference) is the CLIP builder's
(``configs/clip.py``); this file adds the teacher: its seeded checkpoint in
EVA-CLIP's key layout, written once per checkout and handed to the program by
its path (``teacher_name``), its plain reference (``reference/eva.py``), its
geometry for the FLOP count and the kernels' plans (``"kind": "eva"``, which
only the kernel files of EVA-02's modes plan for) and its FLOPs.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from benchmark import common
from benchmark import flops as F
from benchmark import weights
from benchmark.reference import eva as RE
from benchmark.weights import load_checkpoint

clip = common.load_module(common.BENCH_DIR / "configs" / "clip.py")

reference_optimizer = clip.reference_optimizer


# -- the teacher's geometry and weights -----------------------------------------------

def vision(cfg: dict) -> dict:
    return cfg["teacher"]["vision_cfg"]


def hidden(v: dict) -> int:
    """The SwiGLU width, ``int(width · mlp_ratio)`` as EVA builds it."""
    return int(v["width"] * v["mlp_ratio"])


def heads(v: dict) -> int:
    return v["width"] // v["head_width"]


def eva_shapes(t: dict) -> dict:
    """The vision tower's state dict shapes in EVA-CLIP's key layout."""
    v = t["vision_cfg"]
    C, S, h = v["width"], v["patch_size"], hidden(v)
    grid = v["image_size"] // S
    shapes = {"visual.patch_embed.proj.weight": (C, 3, S, S),
              "visual.patch_embed.proj.bias": (C,), "visual.cls_token": (1, 1, C),
              "visual.pos_embed": (1, grid * grid + 1, C), "visual.norm.weight": (C,),
              "visual.norm.bias": (C,), "visual.head.weight": (t["embed_dim"], C),
              "visual.head.bias": (t["embed_dim"],)}
    for i in range(v["layers"]):
        p = f"visual.blocks.{i}."
        for ln, n in (("norm1", C), ("attn.inner_attn_ln", C), ("norm2", C),
                      ("mlp.ffn_ln", h)):
            shapes.update({f"{p}{ln}.weight": (n,), f"{p}{ln}.bias": (n,)})
        shapes.update({f"{p}attn.{n}_proj.weight": (C, C) for n in "qkv"})
        shapes.update({p + "attn.q_bias": (C,), p + "attn.v_bias": (C,),
                       p + "attn.proj.weight": (C, C), p + "attn.proj.bias": (C,),
                       p + "mlp.w1.weight": (h, C), p + "mlp.w1.bias": (h,),
                       p + "mlp.w2.weight": (h, C), p + "mlp.w2.bias": (h,),
                       p + "mlp.w3.weight": (C, h), p + "mlp.w3.bias": (C,)})
    return shapes


def _eva_init(name: str, shape, part: torch.Tensor) -> torch.Tensor:
    """EVA's ``_init_weights`` and ``fix_init_weight``: Linear weights, the
    class token and the positional embedding N(0, 0.02) (timm's
    ``trunc_normal_`` cuts at ±2 absolute, 100σ: no cut), every bias 0 (q_bias
    and v_bias too), LayerNorms 1 / 0; ``attn.proj`` and ``mlp.w3`` of block
    i divided by sqrt(2(i + 1)); the head times ``init_scale`` 0.001.  The
    patch convolution keeps PyTorch's default scale, a variance of
    1 / (3·fan_in), drawn normal here, and a zero bias."""
    if name.endswith(("bias", "q_bias", "v_bias")):
        return torch.zeros(shape, device=part.device)
    if name.endswith(("norm1.weight", "norm2.weight", "inner_attn_ln.weight", "ffn_ln.weight",
                      "visual.norm.weight")):
        return torch.ones(shape, device=part.device)
    x = part.view(shape)
    if name == "visual.patch_embed.proj.weight":
        return x * (3 * shape[1] * shape[2] * shape[3]) ** -0.5
    x = x * 0.02
    if name.endswith(("attn.proj.weight", "mlp.w3.weight")):
        return x / (2.0 * (int(name.split(".")[2]) + 1)) ** 0.5
    return x * 0.001 if name == "visual.head.weight" else x


@torch.no_grad()
def eva_state_dict(t: dict, device) -> dict:
    """fp16 ``{key: tensor}`` on ``device`` from ``t["seed"]``, one normal draw."""
    gen = torch.Generator(device=device).manual_seed(int(t["seed"]))
    shapes = eva_shapes(t)
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    flat = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    return {k: _eva_init(k, s, part).half()
            for (k, s), part in zip(shapes.items(), flat.split(sizes))}


def eva_checkpoint(t: dict, device) -> Path:
    """The teacher's file under the benchmark's cache, written on first use
    (a fixed name from a hash of the configuration's teacher entry)."""
    key = hashlib.sha256(json.dumps(t, sort_keys=True).encode()).hexdigest()[:16]
    path = common.CACHE_DIR / f"teacher_eva_{key}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        sd = {k: v.cpu() for k, v in eva_state_dict(t, device).items()}
        tmp = path.with_suffix(".tmp")
        torch.save(sd, tmp)
        os.replace(tmp, path)
        weights.WRITTEN.append(path)
    return path


# -- the program -------------------------------------------------------------------

def build_task(cfg: dict, device):
    """The program's stage-1 task with the EVA-02-CLIP teacher by its path."""
    from distillclip_tpu_torch.training import DistillTask

    return DistillTask(student=clip._tower(clip.IMAGE_CLASS, cfg["student_encoder"]),
                       loss_control_para=cfg["loss_control_para"],
                       warm_steps=cfg["warm_steps"], total_steps=cfg["total_steps"],
                       weight_decay=cfg["weight_decay"], lr=cfg["lr"],
                       teacher_name=str(eva_checkpoint(cfg["teacher"], device)),
                       compute_dtype=cfg["compute_dtype"],
                       freeze_embed=cfg.get("freeze_embed", False), norm=cfg.get("norm", False),
                       teacher_need_layers=cfg.get("teacher_need_layers"),
                       model_type=cfg["model_type"])


class TrainProgram(clip.TrainProgram):
    """The CLIP builder's train program with the EVA-02-CLIP teacher."""

    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.task = build_task(cfg, device)
        self.shapes = clip.param_shapes(self.task)
        self.kwargs = clip._step_kwargs(cfg, mix["inputs"])


def input_shapes(cfg: dict) -> dict:
    t = cfg["teacher"]
    text = t["text_cfg"]
    vocab = text["vocab_size"]
    return {"image_size": cfg["student_encoder"]["img_size"],
            "context_length": text["context_length"], "sot": vocab - 2, "eot": vocab - 1,
            "rep_dim": t["embed_dim"]}


# -- the reference -----------------------------------------------------------------

class EvaReference(clip.DistillReference):
    """Stage 1: the image student against the live EVA-02-CLIP teacher, or,
    with ``variant``, against the teacher with one mechanism left out or
    altered (``reference/eva.py``'s controls)."""

    def __init__(self, cfg: dict, inputs: list, teacher: dict, variant: str = None):
        super().__init__(cfg, inputs, teacher)
        self.variant = variant

    def targets(self, batch, P):
        v = vision(self.cfg)
        return [RE.eva_image(self.sd, batch[self.at], P, heads(v), v["pt_hw_seq_len"],
                             self.variant)]


def reference_model(cfg: dict, mix: dict, device, variant: str = None):
    teacher = load_checkpoint(eva_checkpoint(cfg["teacher"], device), device)
    return EvaReference(cfg, mix["inputs"], teacher, variant)


# -- what the builder reports -------------------------------------------------------

def eva_geometry(cfg: dict, B: int) -> dict:
    """The teacher tower as the FLOP count and the kernel files read it;
    ``mlp`` is the true SwiGLU width (2730 at L/14), padded to a multiple of
    32 in the program."""
    v = vision(cfg)
    C, S = v["width"], v["patch_size"]
    return {"kind": "eva", "modality": "image", "mode": "lean", "B": B,
            "N": (v["image_size"] // S) ** 2 + 1, "C": C, "H": heads(v), "d": v["head_width"],
            "mlp": hidden(v), "layers": v["layers"], "qkv_bias": True, "transform": False,
            "embed_in": 3 * S * S, "out_dim": cfg["teacher"]["embed_dim"], "causal": False}


def eva_forward_flops(t: dict) -> float:
    """A picture's forward FLOPs in the EVA tower: q, k, v, proj and SwiGLU's
    three products (W1, W2, w3) at the true width, q·kᵀ and P·v, the patch
    product and the head."""
    N, C, H, d = t["N"], t["C"], t["H"], t["d"]
    layer = 2 * N * C * 4 * C + 3 * 2 * N * C * t["mlp"] + 2 * 2 * H * N * N * d
    return 2 * (N - 1) * t["embed_in"] * C + t["layers"] * layer + 2 * C * t["out_dim"]


def train_towers(cfg: dict, mix: dict) -> list:
    B = mix["pairs"]
    return [clip.student_geometry(cfg["student_encoder"], "image", B, "train"),
            eva_geometry(cfg, B)]


def train_pair_flops(cfg: dict, mix: dict) -> float:
    """A pair's model FLOPs in a step: the student's forward and gradients,
    the frozen teacher's forward."""
    student, teacher = train_towers(cfg, mix)
    return F.tower_flops(student) + eva_forward_flops(teacher)
