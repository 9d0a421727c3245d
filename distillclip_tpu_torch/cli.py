"""Command-line interface of the port.

Port of ``distillclip_tpu/cli.py``::

    distillclip-torch fit -c share.yaml -c version.yaml [--seed 2022] [--ckpt PATH]
    distillclip-torch validate -c config.yaml --ckpt PATH
    distillclip-torch lr_find -c config.yaml [--min-lr 1e-7 --max-lr 1 --steps 100]
    distillclip-torch score --image-ckpt A --text-ckpt B -c l_clip.yaml \
        --images DIR --captions FILE
    distillclip-torch score --teacher clip.pt --images DIR --captions FILE
    python -m distillclip_tpu_torch.cli fit -c configs/smoke_text.yaml --device cpu
    torchrun --nproc_per_node N -m distillclip_tpu_torch.cli fit -c config.yaml [--device cpu]

``fit``, ``validate`` and ``lr_find`` need at least one ``-c``: repeated files
deep-merge, the ``perf:`` section is applied (``config.apply_perf_config``;
``DISTILLCLIP_*`` variables win) and ``random`` and numpy are seeded with
``--seed``.  ``fit`` writes the resolved config to
``<result_dir>/<run_name>/config.yaml`` beside ``metrics.jsonl``,
``hparams.json`` and ``checkpoints/`` (``--ckpt`` resumes at the epoch after
the checkpoint's) and prints its summary as one JSON line; ``validate`` prints
the validation metrics of ``--ckpt`` (or of the seeded init); ``lr_find``
prints the suggested rate and exits 1 when there is none.

``score`` prints one JSON line per (image, caption) pair under the JAX CLI's
keys: the first ``len(captions)`` files of ``--images`` in sorted order,
paired with the non-empty lines of ``--captions``.  Without student
checkpoints it scores with the teacher (``--teacher``, a model name or a
checkpoint path).  One line on standard error says which tokenizer and which
image decoder ran.  Every command runs on the card unless ``--device cpu``;
without a card ``--device cuda`` fails.

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``fit``, ``validate`` and ``lr_find``
join the launcher's processes (``parallel.initialize_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and train data-parallel; the
first rank prints the result.  A process group that cannot form is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _seed_everything(seed: int) -> None:
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed)


def _load(args) -> dict:
    """The merged config with its ``perf`` section applied and recorded as
    the effective knobs, after seeding."""
    from distillclip_tpu_torch.config import apply_perf_config, load_configs

    _seed_everything(args.seed)
    cfg = load_configs(args.config)
    cfg["perf"] = apply_perf_config(cfg.get("perf"))
    return cfg


def _build(cfg, args):
    from distillclip_tpu_torch.config import build_trainer, instantiate
    from distillclip_tpu_torch.parallel import initialize_distributed

    initialize_distributed(args.device)
    return (instantiate(cfg.get("model")), instantiate(cfg.get("data")),
            build_trainer(cfg.get("trainer"), seed=args.seed, device=args.device))


def _print_main(line: str) -> None:
    """Print on the first rank only (every rank holds the same result)."""
    from distillclip_tpu_torch.parallel import is_main

    if is_main():
        print(line)


def cmd_fit(args) -> int:
    from distillclip_tpu_torch.config import save_resolved_config
    from distillclip_tpu_torch.parallel import is_main

    cfg = _load(args)
    task, datamodule, trainer = _build(cfg, args)
    run_dir = f"{trainer.result_dir}/{trainer.run_name}"
    os.makedirs(run_dir, exist_ok=True)
    if is_main():
        save_resolved_config(cfg, f"{run_dir}/config.yaml")
    result = trainer.fit(task, datamodule, ckpt_path=args.ckpt_path)
    _print_main(json.dumps({"summary": result["summary"]}))
    return 0


def cmd_validate(args) -> int:
    from distillclip_tpu_torch.training.checkpoints import restore_state
    from distillclip_tpu_torch.training.trainer import run_device

    cfg = _load(args)
    task, datamodule, trainer = _build(cfg, args)
    state, _ = task.init_state(args.seed, 1, device=run_device(args.device))
    if args.ckpt_path:
        restore_state(args.ckpt_path, state)
    _print_main(json.dumps(trainer.validate(task, datamodule, state), indent=2))
    return 0


def cmd_lr_find(args) -> int:
    """LR range test (Lightning's auto_lr_find)."""
    from distillclip_tpu_torch.tools.lr_finder import lr_find

    cfg = _load(args)
    task, datamodule, _ = _build(cfg, args)
    result = lr_find(task, datamodule, min_lr=args.min_lr, max_lr=args.max_lr,
                     num_steps=args.steps, seed=args.seed, device=args.device)
    _print_main(json.dumps({"suggested_lr": result["suggestion"],
                            "diverged_at": result["diverged_at"],
                            "steps_run": len(result["lrs"])}))
    return 0 if result["suggestion"] is not None else 1


def cmd_score(args) -> int:
    """L-CLIPScore batch inference (the serving path)."""
    from distillclip_tpu_torch.data import native_loader
    from distillclip_tpu_torch.serving.lclip_score import LCLIPScorer

    if not (args.images and args.captions):
        print("score: need --images DIR and --captions FILE", file=sys.stderr)
        return 2
    scorer = LCLIPScorer.from_checkpoints(
        image_ckpt=args.image_ckpt, text_ckpt=args.text_ckpt,
        config=args.config[0] if args.config else None, bpe_path=args.bpe_path,
        teacher_name=args.teacher, device=args.device)
    with open(args.captions) as f:
        captions = [line.rstrip("\n") for line in f if line.strip()]
    image_paths = sorted(os.path.join(args.images, p)
                         for p in os.listdir(args.images))[: len(captions)]
    print(f"score: tokenizer {type(scorer.tokenizer).__name__}, image decode "
          f"{'native/libdcloader.so' if native_loader.available() else 'PIL'}, "
          f"device {scorer.device}", file=sys.stderr)
    scores = scorer.score_files(image_paths, captions)
    for p, c, s in zip(image_paths, captions, scores):
        print(json.dumps({"image": p, "caption": c, "l_clip_score": float(s)}))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="distillclip-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-c", "--config", action="append", default=[],
                        help="YAML config (repeatable; later files override earlier)")
    common.add_argument("--seed", type=int, default=2022)
    common.add_argument("--ckpt_path", "--ckpt", dest="ckpt_path", default=None)
    common.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    sub.add_parser("fit", parents=[common], help="train a stage").set_defaults(fn=cmd_fit)
    sub.add_parser("validate", parents=[common],
                   help="run validation only").set_defaults(fn=cmd_validate)
    p_lr = sub.add_parser("lr_find", parents=[common], help="LR range test")
    p_lr.add_argument("--min-lr", type=float, default=1e-7)
    p_lr.add_argument("--max-lr", type=float, default=1.0)
    p_lr.add_argument("--steps", type=int, default=100)
    p_lr.set_defaults(fn=cmd_lr_find)
    p_score = sub.add_parser("score", parents=[common], help="L-CLIPScore inference")
    p_score.add_argument("--image-ckpt", required=False)
    p_score.add_argument("--text-ckpt", required=False)
    p_score.add_argument("--images", help="directory of images")
    p_score.add_argument("--captions", help="file with one caption per line")
    p_score.add_argument("--bpe-path", default=None)
    p_score.add_argument("--teacher", default="ViT-B/32",
                         help="teacher name or checkpoint path (used when no student ckpts)")
    p_score.set_defaults(fn=cmd_score)

    args = parser.parse_args(argv)
    if args.command in ("fit", "validate", "lr_find") and not args.config:
        parser.error(f"{args.command} requires at least one -c/--config")
    import torch.distributed as dist

    joined = dist.is_initialized()
    try:
        return args.fn(args)
    finally:
        if not joined and dist.is_initialized():   # the process group this call formed
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
