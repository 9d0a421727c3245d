"""The builder of the CLIP-family configurations (``"builder": "clip"``):
the program's step or scorer built from a configuration file with the
benchmark's own weights, the towers' geometry (for the FLOP count and the
kernels' work), and the reference models the comparison runs.

The program is built only through its public entry points: the stage-3 task
``training.DualDistillTask``, the stage-1/2 task ``training.DistillTask``
(their ``init_state`` with the benchmark's masters and ``make_train_step``),
the scorer ``serving.LCLIPScorer``, the student towers from a config's
``{class_path, init_args}`` (``serving.lclip_score.build_tower``) and the
teacher from a checkpoint file.
"""

from __future__ import annotations

import torch

from benchmark import flops as F
from benchmark.reference import losses as RL
from benchmark.reference import towers as RT
from benchmark.reference.numerics import unit
from benchmark.reference.optim import AdamW as RefAdamW
from benchmark.weights import clip_checkpoint, load_checkpoint, student_masters

IMAGE_CLASS = "model.component.weight_share_model.RepeatVisionTransformer"
TEXT_CLASS = "model.component.weight_share_model.RepeatTextTransformer"


# -- geometry --------------------------------------------------------------------

def student_geometry(geo: dict, modality: str, B: int, mode: str) -> dict:
    C, H = geo["embed_dim"], geo["num_heads"]
    if modality == "image":
        S = geo["patch_size"]
        N, embed_in = (geo["img_size"] // S) ** 2 + 1, S * S * geo.get("in_chans", 3)
    else:
        N, embed_in = geo["context_length"], 0
    return {"kind": "student", "modality": modality, "mode": mode, "B": B, "N": N, "C": C,
            "H": H, "d": C // H, "mlp": int(C * geo["mlp_ratio"]), "layers": geo["depth"],
            "qkv_bias": bool(geo["qkv_bias"]), "transform": bool(geo["use_transform"]),
            "embed_in": embed_in, "out_dim": geo["out_dim"], "causal": False}


def clip_geometry(t: dict, modality: str, B: int) -> dict:
    if modality == "image":
        C, S = t["vision_width"], t["vision_patch_size"]
        N, layers, embed_in = (t["image_resolution"] // S) ** 2 + 1, t["vision_layers"], 3 * S * S
    else:
        C, N, layers, embed_in = (t["transformer_width"], t["context_length"],
                                  t["transformer_layers"], 0)
    return {"kind": "clip", "modality": modality, "mode": "lean", "B": B, "N": N, "C": C,
            "H": C // 64, "d": 64, "mlp": 4 * C, "layers": layers, "qkv_bias": True,
            "transform": False, "embed_in": embed_in, "out_dim": t["embed_dim"],
            "causal": modality == "text"}


def input_shapes(cfg: dict) -> dict:
    t = cfg["teacher"]
    image = cfg.get("image_student") or cfg.get("student_encoder") or {}
    vocab = t["vocab_size"]
    return {"image_size": image.get("img_size", t["image_resolution"]),
            "context_length": t["context_length"], "sot": vocab - 2, "eot": vocab - 1,
            "rep_dim": t["embed_dim"]}


# -- the program -----------------------------------------------------------------

def _tower(class_path: str, args: dict):
    from distillclip_tpu_torch.serving.lclip_score import build_tower

    return build_tower({"class_path": class_path, "init_args": dict(args)})


def _step_kwargs(cfg: dict, inputs: list) -> dict:
    cached = {k for k in inputs if k.endswith("_rep")}
    if cfg["task"] == "dual":
        if cached == {"text_rep", "image_rep"}:
            return {"cached_teachers": True}
        return {"cached_text_teacher": True} if cached == {"text_rep"} else {}
    if cached:
        raise NotImplementedError("the stage-1 builder runs the live teacher")
    return {}


def build_task(cfg: dict, device):
    """The program's task of ``cfg``, with the teacher checkpoint written (once
    per checkout) and named."""
    from distillclip_tpu_torch.training import DistillTask, DualDistillTask

    teacher = str(clip_checkpoint(cfg["teacher"], device))
    common = dict(loss_control_para=cfg["loss_control_para"], warm_steps=cfg["warm_steps"],
                  total_steps=cfg["total_steps"], weight_decay=cfg["weight_decay"],
                  lr=cfg["lr"], teacher_name=teacher, compute_dtype=cfg["compute_dtype"],
                  freeze_embed=cfg.get("freeze_embed", False), norm=cfg.get("norm", False))
    if cfg["task"] == "dual":
        return DualDistillTask(image_student=_tower(IMAGE_CLASS, cfg["image_student"]),
                               text_student=_tower(TEXT_CLASS, cfg["text_student"]), **common)
    return DistillTask(student=_tower(IMAGE_CLASS, cfg["student_encoder"]),
                       teacher_need_layers=cfg.get("teacher_need_layers"),
                       model_type=cfg["model_type"], **common)


def param_shapes(task) -> dict:
    """The masters' names and shapes, as the task names them."""
    return {f"student.{k}": tuple(v.shape) for k, v in task.student.named_parameters()}


def _rows(out) -> torch.Tensor:
    """A tower's output rows: its ``last_representation``."""
    return getattr(out, "last_representation", out)


class TrainProgram:
    """The program's train step of one cell: the task, its state from the
    benchmark's masters, and the step the window calls."""

    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.task = build_task(cfg, device)
        self.shapes = param_shapes(self.task)
        self.kwargs = _step_kwargs(cfg, mix["inputs"])

    def masters(self, seed: int) -> dict:
        return student_masters(self.shapes, seed, self.device)

    def start(self, seed: int):
        """(state, step, optimizer) from the masters of ``seed``."""
        state, tx = self.task.init_state(seed, steps_per_epoch=self.cfg["steps_per_epoch"],
                                         params=self.masters(seed), device=self.device)
        return state, self.task.make_train_step(tx, **self.kwargs), tx

    def tap(self, state) -> tuple:
        """(``seen``, ``close``): forward hooks on the students and on the
        teacher's towers that run live, which keep in ``seen`` what the next
        step's loss reads: ``students`` (image, then text) and ``teacher``
        (the live towers in the reference's order), as float32 rows.  Only
        the first call of each tower is kept; ``close`` removes the hooks, and
        the window runs without them."""
        seen = {"students": None, "teacher": []}
        device = next(iter(state.params.values())).device

        def keep_students(module, args, out):
            if seen["students"] is None:
                outs = ([out.visual_output, out.text_output] if hasattr(out, "visual_output")
                        else [out])
                seen["students"] = [_rows(o).detach().float().clone() for o in outs]

        def keep_teacher(slot):
            def hook(module, args, out):
                if seen["teacher"][slot] is None:
                    seen["teacher"][slot] = _rows(out).detach().float().clone()
            return hook

        handles = [self.task.student.register_forward_hook(keep_students)]
        for slot, which in enumerate(self.live_teacher_towers()):
            seen["teacher"].append(None)
            tower = self.task.teacher.tower(device, which)
            handles.append(tower.register_forward_hook(keep_teacher(slot)))
        return seen, lambda: [h.remove() for h in handles]

    def live_teacher_towers(self) -> list:
        """The teacher towers a step runs (``image``, ``text``), in order."""
        if self.cfg["task"] != "dual":
            return ["image"]
        return [m for m in ("image", "text") if f"{m}_rep" not in self.mix["inputs"]]


class ScoreProgram:
    """The program's scorer of one cell: both students with the benchmark's
    weights, served in the configuration's compute dtype."""

    def __init__(self, cfg: dict, seed: int, device):
        from distillclip_tpu_torch.serving import LCLIPScorer

        with torch.device(device):
            towers = {"image_tower": _tower(IMAGE_CLASS, cfg["image_student"]),
                      "text_tower": _tower(TEXT_CLASS, cfg["text_student"])}
        self.shapes = {f"{t}.{k}": tuple(v.shape) for t, m in towers.items()
                       for k, v in m.named_parameters()}
        masters = student_masters(self.shapes, seed, device)
        for t, m in towers.items():
            m.load_state_dict({k[len(t) + 1:]: v for k, v in masters.items()
                               if k.startswith(t + ".")})
        dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        self.scorer = LCLIPScorer(towers["image_tower"], towers["text_tower"], device=device,
                                  dtype=dtype)


# -- the reference ---------------------------------------------------------------

class DualReference:
    """Stage 3: both students against the teacher's representations (the
    image teacher live, the text teacher's cached ones where the batch
    carries them), the two-tower loss."""

    def __init__(self, cfg: dict, inputs: list, teacher: dict):
        self.cfg, self.inputs, self.sd = cfg, list(inputs), teacher
        # the targets the teacher computes; the others a batch carries
        self.live_targets = [i for i, m in enumerate(("image", "text"))
                             if f"{m}_rep" not in self.inputs]

    def _named(self, batch):
        return dict(zip(self.inputs, batch))

    def targets(self, batch, P):
        b = self._named(batch)
        img = b["image_rep"] if "image_rep" in b else RT.clip_image(self.sd, b["images"], P)
        txt = b["text_rep"] if "text_rep" in b else RT.clip_text(self.sd, b["tokens"], P)
        return [img, txt]

    def student(self, params, batch, P):
        b = self._named(batch)
        return [RT.student_image(params, "student.image_tower.", b["images"],
                                 self.cfg["image_student"], P),
                RT.student_text(params, "student.text_tower.", b["tokens"],
                                self.cfg["text_student"], P)]

    def loss(self, outs, targets):
        return RL.two_tower(self.cfg["loss_control_para"], outs[0], outs[1], *targets)


class DistillReference:
    """Stage 1: the image student against the live image teacher."""

    def __init__(self, cfg: dict, inputs: list, teacher: dict):
        self.cfg, self.sd = cfg, teacher
        self.at = list(inputs).index("images")
        self.live_targets = [0]

    def targets(self, batch, P):
        return [RT.clip_image(self.sd, batch[self.at], P)]

    def student(self, params, batch, P):
        return [RT.student_image(params, "student.", batch[self.at], self.cfg["student_encoder"],
                                 P)]

    def loss(self, outs, targets):
        return RL.one_tower(self.cfg["loss_control_para"], outs[0], targets[0])


def reference_model(cfg: dict, mix: dict, device):
    teacher = load_checkpoint(clip_checkpoint(cfg["teacher"], device), device)
    cls = DualReference if cfg["task"] == "dual" else DistillReference
    return cls(cfg, mix["inputs"], teacher)


def reference_optimizer(cfg: dict):
    return lambda params: RefAdamW(params, cfg["lr"], cfg["warm_steps"], cfg["total_steps"],
                                   cfg["weight_decay"], cfg["steps_per_epoch"])


def reference_scores(cfg: dict, params: dict, images, tokens, P, rows: int) -> torch.Tensor:
    out = []
    for i in range(0, images.shape[0], rows):
        img = RT.student_image(params, "image_tower.", images[i:i + rows], cfg["image_student"], P)
        txt = RT.student_text(params, "text_tower.", tokens[i:i + rows], cfg["text_student"], P)
        out.append((unit(img) * unit(txt)).sum(dim=1))
    return torch.cat(out)


# -- what the builders report ----------------------------------------------------

def train_towers(cfg: dict, mix: dict) -> list:
    """The towers one train step runs, with their geometry."""
    B, inputs = mix["pairs"], mix["inputs"]
    if cfg["task"] == "dual":
        towers = [student_geometry(cfg["image_student"], "image", B, "train"),
                  student_geometry(cfg["text_student"], "text", B, "train")]
        if "image_rep" not in inputs:
            towers.append(clip_geometry(cfg["teacher"], "image", B))
        if "text_rep" not in inputs:
            towers.append(clip_geometry(cfg["teacher"], "text", B))
        return towers
    return [student_geometry(cfg["student_encoder"], "image", B, "train"),
            clip_geometry(cfg["teacher"], "image", B)]


def score_towers(cfg: dict, mix: dict) -> list:
    B = mix["pairs"]
    return [student_geometry(cfg["image_student"], "image", B, "lean"),
            student_geometry(cfg["text_student"], "text", B, "lean")]


def train_pair_flops(cfg: dict, mix: dict) -> float:
    """A pair's model FLOPs in a step; the two-tower loss adds the students'
    cosine logits (forward and both gradients) and the teacher's."""
    extra = 0.0
    if cfg["task"] == "dual":
        extra = 4 * 2 * mix["pairs"] * cfg["teacher"]["embed_dim"]
    return F.pair_flops(train_towers(cfg, mix), extra)


def score_pair_flops(cfg: dict, mix: dict) -> float:
    return F.pair_flops(score_towers(cfg, mix), 2 * cfg["image_student"]["out_dim"])
