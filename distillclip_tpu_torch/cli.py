"""Command-line interface of the port.

Port of ``distillclip_tpu/cli.py``::

    distillclip-torch score --image-ckpt A --text-ckpt B -c l_clip.yaml \
        --images DIR --captions FILE [--device cuda|cpu]
    distillclip-torch score --teacher clip.pt --images DIR --captions FILE
    python -m distillclip_tpu_torch.cli score ...

``score`` prints one JSON line per (image, caption) pair under the JAX CLI's
keys: the first ``len(captions)`` files of ``--images`` in sorted order,
paired with the non-empty lines of ``--captions``.  Without student
checkpoints it scores with the teacher (``--teacher``, a model name or a
checkpoint path).  It runs on the card unless ``--device cpu``; one line on
standard error says which tokenizer and which image decoder ran.  ``fit``,
``validate`` and ``lr_find`` wait for the trainer (ROADMAP queue 1: the trainer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

_TRAINER_ITEM = "ROADMAP queue 1: the trainer, the eval steps and the CLI's commands"


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


def _not_ported(args) -> int:
    raise NotImplementedError(f"{args.command} is not ported yet ({_TRAINER_ITEM})")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="distillclip-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-c", "--config", action="append", default=[],
                        help="YAML config (repeatable; later files override earlier)")
    common.add_argument("--seed", type=int, default=2022)
    common.add_argument("--ckpt_path", "--ckpt", dest="ckpt_path", default=None)

    for name, help_ in (("fit", "train a stage"), ("validate", "run validation only"),
                        ("lr_find", "LR range test")):
        sub.add_parser(name, parents=[common], help=help_).set_defaults(fn=_not_ported)
    p_score = sub.add_parser("score", parents=[common], help="L-CLIPScore inference")
    p_score.add_argument("--image-ckpt", required=False)
    p_score.add_argument("--text-ckpt", required=False)
    p_score.add_argument("--images", help="directory of images")
    p_score.add_argument("--captions", help="file with one caption per line")
    p_score.add_argument("--bpe-path", default=None)
    p_score.add_argument("--teacher", default="ViT-B/32",
                         help="teacher name or checkpoint path (used when no student ckpts)")
    p_score.add_argument("--device", default="cuda",
                         help="torch device to score on (default: cuda)")
    p_score.set_defaults(fn=cmd_score)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
