"""The port's kernels, each beside its plain PyTorch version.

Every wrapper runs its plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor (or raises); it adds one to its ``launches`` count
where, and only where, it launches the kernel.  The first four serve (K3 at
head shapes past its tensor-core kernel goes to its second route, the fifth,
the CUDA-core kernel, which counts its own launches); with a gradient the
public functions go through ``torch.autograd.Function``s whose forward and
backward launch the next five (and K1 / K4 in the mode that also
writes the rows' statistics).  The next three are plain attention on the fused
qkv rows (the CLIP teacher towers and every student without head mixes):
forward, forward with saved probabilities, backward.  The next three are
attention on ``[B, H, N, d]`` views with the row logsumexp as residual (the
towers when they collect hidden states): plain forward and backward, and the
head-transform forward.  The next three are the dense GEMM without the
LayerNorm prologue, which the blocks run under the ``fc1_ln: "0"`` knob: h only
(no gradient), h with the (u, e) residuals, and u only (``fc1_res: u``).  The
next is the head-transform forward's second route, the CUDA-core kernel, for
head shapes past its tensor-core kernel's (it counts its own launches).  The
last two are the second route of the head-transform training pair, the
CUDA-core save-P forward and backward, for the head shapes past the
tensor-core backward's (``ops.transform_attention.grad_route``).  The last
three are EVA-02's forward modes of the LN GEMM (the EVA-02-CLIP teacher's
blocks): K1 with the rotary turn of q and k, K2 with SwiGLU at half width, and
K1 with the LayerNorm's moments over a true width below the padded one.  The
last is plain attention past 256 tokens, forward only (the EVA-02 tower's).
"""

from distillclip_tpu_torch.ops.fc1_act import (
    dense_act,
    dense_act_ln,
    dense_act_ln_res,
    dense_act_res,
    dense_act_u,
    dense_ln,
    dense_ln_bwd,
    dense_ln_rope,
    dense_ln_width,
    dense_swiglu_ln,
)
from distillclip_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_transform_attention_fwd,
    flash_transform_attention_fwd_wide,
    reference_attention,
)
from distillclip_tpu_torch.ops.layer_norm import layer_norm_rows, layer_norm_rows_bwd
from distillclip_tpu_torch.ops.plain_attention import (
    plain_attention_bwd,
    plain_attention_long,
    plain_attention_rows_qkv,
    plain_attention_save_p,
)
from distillclip_tpu_torch.ops.transform_attention import (
    transform_attention_bwd,
    transform_attention_bwd_wide,
    transform_attention_rows_qkv,
    transform_attention_rows_qkv_wide,
    transform_attention_save_p,
    transform_attention_save_p_wide,
)

# Every kernel by the name of the wrapper that launches and counts it.
KERNELS = {
    "dense_ln": dense_ln,
    "dense_act_ln": dense_act_ln,
    "transform_attention_rows_qkv": transform_attention_rows_qkv,
    "layer_norm_rows": layer_norm_rows,
    "transform_attention_rows_qkv_wide": transform_attention_rows_qkv_wide,
    "transform_attention_save_p": transform_attention_save_p,
    "transform_attention_bwd": transform_attention_bwd,
    "layer_norm_rows_bwd": layer_norm_rows_bwd,
    "dense_act_ln_res": dense_act_ln_res,
    "dense_ln_bwd": dense_ln_bwd,
    "plain_attention_rows_qkv": plain_attention_rows_qkv,
    "plain_attention_save_p": plain_attention_save_p,
    "plain_attention_bwd": plain_attention_bwd,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_transform_attention_fwd": flash_transform_attention_fwd,
    "dense_act": dense_act,
    "dense_act_res": dense_act_res,
    "dense_act_u": dense_act_u,
    "flash_transform_attention_fwd_wide": flash_transform_attention_fwd_wide,
    "transform_attention_save_p_wide": transform_attention_save_p_wide,
    "transform_attention_bwd_wide": transform_attention_bwd_wide,
    "dense_ln_rope": dense_ln_rope,
    "dense_swiglu_ln": dense_swiglu_ln,
    "dense_ln_width": dense_ln_width,
    "plain_attention_long": plain_attention_long,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    dense_ln_bwd.act_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "dense_act",
    "dense_act_ln",
    "dense_act_ln_res",
    "dense_act_res",
    "dense_act_u",
    "dense_ln",
    "dense_ln_bwd",
    "dense_ln_rope",
    "dense_ln_width",
    "dense_swiglu_ln",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "flash_transform_attention_fwd",
    "launch_counts",
    "layer_norm_rows",
    "layer_norm_rows_bwd",
    "plain_attention_bwd",
    "plain_attention_long",
    "plain_attention_rows_qkv",
    "plain_attention_save_p",
    "reference_attention",
    "reset_launch_counts",
    "transform_attention_bwd",
    "transform_attention_bwd_wide",
    "transform_attention_rows_qkv",
    "transform_attention_rows_qkv_wide",
    "transform_attention_save_p",
    "transform_attention_save_p_wide",
]
