"""The port's kernels, each beside its plain PyTorch version.

Every wrapper runs its plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor (or raises); it adds one to its ``launches`` count
where, and only where, it launches the kernel.
"""

from distillclip_tpu_torch.ops.fc1_act import dense_act_ln, dense_ln
from distillclip_tpu_torch.ops.layer_norm import layer_norm_rows
from distillclip_tpu_torch.ops.transform_attention import transform_attention_rows_qkv

KERNELS = {
    "dense_ln": dense_ln,
    "dense_act_ln": dense_act_ln,
    "transform_attention_rows_qkv": transform_attention_rows_qkv,
    "layer_norm_rows": layer_norm_rows,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "dense_act_ln",
    "dense_ln",
    "launch_counts",
    "layer_norm_rows",
    "reset_launch_counts",
    "transform_attention_rows_qkv",
]
