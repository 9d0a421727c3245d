"""The benchmark of ``distillclip_tpu_torch`` on NVIDIA GPUs (``run.py``)."""
