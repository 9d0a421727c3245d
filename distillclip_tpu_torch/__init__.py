"""PyTorch + CUDA port of distillclip_tpu for NVIDIA Hopper (H100).

The JAX package ``distillclip_tpu`` is the reference; this package imports
``torch`` and never JAX.  Ported so far: L-CLIPScore serving with the two
weight-share students (``serving.LCLIPScorer``), the frozen CLIP teacher
(``models.teacher_load``), every tower's taps (``models.ControlFlags``), all
distillation losses (``losses.LossCalculator``), every train step and eval
step of the one-tower and the two-tower tasks (``training``), dropout
included, the trainer (``training.trainer.Trainer``; the CLI's ``fit`` /
``validate`` / ``lr_find``), the datasets of the final configs with the
teacher's pre-encoding on the run's device (``data``), and data parallelism
over processes with global negatives (``parallel``; ``torchrun``).  The hot ops are hand-written CUDA kernels (``ops``, sources in
``csrc/``).
"""
