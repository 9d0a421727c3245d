"""PyTorch + CUDA port of distillclip_tpu for NVIDIA Hopper (H100).

The JAX package ``distillclip_tpu`` is the reference; this package imports
``torch`` and never JAX.  Ported so far: L-CLIPScore serving with the two
weight-share students (``serving.LCLIPScorer``), whose hot ops are four
hand-written CUDA kernels (``ops``, sources in ``csrc/``).
"""
