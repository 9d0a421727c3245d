"""Quality A/B: augmented images with the live teacher against unaugmented
images with the teacher's representations cached.

The reference RandAugments its train images (stage 3: reference
data/component/ms_coco.py:15-21; stage 1: combine_image_dataset.py:85-117),
which forces the image teacher to run live every step.  The deviation configs
(``configs/final/l_clip_allcached.yaml`` / ``image_allcached.yaml``) drop the
augmentation so that the teacher's representations can be encoded once and
the teacher leaves the step.  This tool trains both on a fabricated corpus at
a tiny scale, under the same seeds and schedules, and reports the last
validation metrics side by side:

    python -m distillclip_tpu_torch.tools.cached_teacher_ab --epochs 8
    python -m distillclip_tpu_torch.tools.cached_teacher_ab --stage image --device cpu

The corpus is synthetic, so the absolute numbers mean nothing; the A/B
isolates what augmentation and the live teacher contribute.  Port of the JAX
package's tool, on the port's trainer (``training.trainer.Trainer``) and data
modules, on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import json
import os


def _last_val(metrics_path: str, prefixes) -> dict:
    last_val = {}
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if any(k.startswith("val_") for k in rec):
                last_val = rec
    return {k: v for k, v in last_val.items() if k.startswith(prefixes)}


def _teacher(workdir: str) -> str:
    import torch

    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "tiny_clip.pt")
    if not os.path.exists(path):
        torch.save(make_clip_state_dict(), path)
    return path


def run_ab(workdir: str, epochs: int = 8, n_train: int = 256, n_val: int = 64,
           seed: int = 2022, device: str = "cuda"):
    """Stage 3 (COCO captions): augmented + live image teacher against
    unaugmented + cached image representations; the text teacher cached in
    both."""
    from distillclip_tpu_torch.data.datamodule import MainDataModule
    from distillclip_tpu_torch.models import RepeatTextTransformer, RepeatVisionTransformer
    from distillclip_tpu_torch.tools.fabricate_images import fabricate, fabricate_coco_train
    from distillclip_tpu_torch.training import DualDistillTask
    from distillclip_tpu_torch.training.trainer import Trainer

    size = 32
    corpus = os.path.join(workdir, "corpus")
    teacher = _teacher(workdir)
    if not os.path.exists(os.path.join(corpus, "mscoco", "annotations",
                                       "captions_train2017.json")):
        fabricate(corpus, n_train=0, n_val=n_val, size=size)
        fabricate_coco_train(corpus, n_train=n_train, size=size)

    def build_dm(augment: bool, cache_dir: str):
        prepare = {"cache_caption_reps": True}
        para = {
            "root_path": f"{corpus}/mscoco",
            "annotation_path": f"{corpus}/mscoco/annotations",
            "image_size": size,
            "cached_text_teacher_reps": True,
            "augment_train": augment,
            "cache_dir": cache_dir,
            "teacher_name": teacher,
            "download_root": cache_dir,
        }
        if not augment:
            prepare["cache_image_reps"] = True
            para["cached_image_teacher_reps"] = True
        return MainDataModule(dataset="ms_coco", dataset_name="COCODataset",
                              prepare_para=prepare, dataset_para=para,
                              train_batch_size=32, val_batch_size=32, num_workers=0)

    def build_task():
        return DualDistillTask(
            image_student=RepeatVisionTransformer(
                img_size=size, patch_size=8, out_dim=48, embed_dim=64, depth=2, num_heads=4,
                repeated_times=2, qkv_bias=True, use_transform=True),
            text_student=RepeatTextTransformer(
                vocab_size=49408, context_length=77, out_dim=48, embed_dim=64, depth=2,
                num_heads=4, repeated_times=2, use_transform=True),
            loss_control_para={"loss_name": ["out_l1", "out_cos", "cos_diff"],
                               "loss_scale": {"cos_diff": 0.1}},
            teacher_name=teacher, download_root=workdir,
            lr=1e-3, warm_steps=2, total_steps=max(epochs, 4))

    results = {}
    for name, augment in (("augmented_live", True), ("noaugment_cached", False)):
        dm = build_dm(augment, os.path.join(workdir, f"cache_{name}"))
        Trainer(max_epochs=epochs, result_dir=os.path.join(workdir, "result"), run_name=name,
                log_every_n_steps=4, seed=seed, device=device).fit(build_task(), dm)
        results[name] = _last_val(os.path.join(workdir, "result", name, "metrics.jsonl"),
                                  ("val_loss/", "val_stu_acc/", "val_step/"))
    return results


def run_ab_image(workdir: str, epochs: int = 8, n_train: int = 256, n_val: int = 64,
                 seed: int = 2022, device: str = "cuda"):
    """Stage 1: augmented + live image teacher against unaugmented + cached
    train-image representations (configs/final/image_allcached.yaml)."""
    from distillclip_tpu_torch.data.datamodule import MainDataModule
    from distillclip_tpu_torch.models import RepeatVisionTransformer
    from distillclip_tpu_torch.tools.fabricate_images import fabricate
    from distillclip_tpu_torch.training import DistillTask
    from distillclip_tpu_torch.training.trainer import Trainer

    size = 32
    corpus = os.path.join(workdir, "corpus_image")
    teacher = _teacher(workdir)
    if not os.path.exists(os.path.join(corpus, "mscoco", "annotations",
                                       "captions_val2017.json")):
        fabricate(corpus, n_train=n_train, n_val=n_val, size=size)

    def build_dm(augment: bool, cache_dir: str):
        prepare = {"raw_data_dir": corpus, "overwrite": False}
        para = {
            "combine_dataset_path": os.path.join(corpus, "combined"),
            "image_use": ["coco", "imagenet"],
            "image_size": size,
            "augment_train": augment,
            "cache_dir": cache_dir,
            "teacher_name": teacher,
            "download_root": cache_dir,
        }
        if not augment:
            prepare["cache_train_image_reps"] = True
            para["cached_teacher_reps"] = True
        return MainDataModule(dataset="combine_image_dataset",
                              dataset_name="CombineImageDataset", prepare_para=prepare,
                              dataset_para=para, train_batch_size=32, val_batch_size=32,
                              num_workers=0)

    def build_task():
        return DistillTask(
            student=RepeatVisionTransformer(
                img_size=size, patch_size=8, out_dim=48, embed_dim=64, depth=2, num_heads=4,
                repeated_times=2, qkv_bias=True, use_transform=True),
            loss_control_para={"loss_name": ["out_l1", "out_cos"]},
            teacher_name=teacher, download_root=workdir, model_type="image",
            lr=1e-3, warm_steps=2, total_steps=max(epochs, 4))

    results = {}
    for name, augment in (("augmented_live", True), ("noaugment_cached", False)):
        dm = build_dm(augment, os.path.join(workdir, f"cache_img_{name}"))
        Trainer(max_epochs=epochs, result_dir=os.path.join(workdir, "result"),
                run_name=f"image_{name}", log_every_n_steps=4, seed=seed,
                device=device).fit(build_task(), dm)
        results[name] = _last_val(
            os.path.join(workdir, "result", f"image_{name}", "metrics.jsonl"),
            ("val_loss/", "val_stu_acc/", "val_step/", "val_stu_score/"))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="./.cache/cached_teacher_ab")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--stage", choices=["l_clip", "image"], default="l_clip")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    fn = run_ab if args.stage == "l_clip" else run_ab_image
    results = fn(args.workdir, args.epochs, args.n_train, args.n_val, device=args.device)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
