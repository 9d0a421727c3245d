"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``distillclip_tpu_torch/csrc/*.cu`` compiles to an object file, one
nvcc process per source and all of them at once, and the objects link into
one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o build/torch_kernels/<hash>/<name>.o csrc/<name>.cu      (each source)
    nvcc -shared -o build/torch_kernels/libdistillclip_kernels_<hash>.so <hash>/*.o

The library lands in ``build/torch_kernels/`` at the root of the checkout and
is named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing file.  Nothing is built or loaded at
import: the first kernel launch (or an explicit :func:`build`) does it.

Each C entry point takes device pointers, ints, floats and the CUDA stream,
and returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> (restype, argtypes); pointers and the stream are c_void_p so that
# ctypes does not cut them to 32-bit ints.
_SIGNATURES = {
    "dc_error_string": (ctypes.c_char_p, [_I]),
    # x, gamma, beta, y, mean, rstd | rows, C, eps, threads, blocks, stream
    "dc_layer_norm_rows": (_I, [_P] * 6 + [_I, _I, _F, _I, _I, _P]),
    "dc_layer_norm_rows_warps_per_sm": (_I, [_I]),
    "dc_layer_norm_rows_bwd_max_c": (_I, []),
    # x, gamma, g, mean, rstd, dx, partial, dgamma_dbeta | rows, C, rows_per_block,
    # slot, stream
    "dc_layer_norm_rows_bwd": (_I, [_P] * 8 + [_I] * 4 + [_P]),
    "dc_dense_ln_wgmma_smem_bytes": (ctypes.c_longlong, [_I]),
    # x, gamma, beta, w, w16, bias, out, out_u, out_e, mean, rstd | rows, C, N, eps,
    # act, res, stream (dense_ln_wgmma.cu: K1, K2, #8)
    "dc_dense_ln_wgmma": (_I, [_P] * 11 + [_I, _I, _I, _F, _I, _I, _P]),
    # x, gamma, beta, w, w16, bias, cs, out, mean, rstd | rows, C, N, eps, seq, hd, rot,
    # stream (EVA-02's rotary K1)
    "dc_dense_ln_rope_wgmma": (_I, [_P] * 10 + [_I, _I, _I, _F, _I, _I, _I, _P]),
    # x, gamma, beta, w, w16, bias, out, mean, rstd | rows, C, N, eps, stream (SwiGLU K2)
    "dc_dense_swiglu_ln_wgmma": (_I, [_P] * 9 + [_I, _I, _I, _F, _P]),
    # x, gamma, beta, w, w16, bias, out, mean, rstd | rows, C, N, eps, width, stream
    # (K1 with the moments over a true width)
    "dc_dense_ln_width_wgmma": (_I, [_P] * 9 + [_I, _I, _I, _F, _I, _P]),
    # x, w, bias, h, u, e | rows, C, N, act, res, stream (dense_act.cu)
    "dc_dense_act": (_I, [_P] * 6 + [_I] * 5 + [_P]),
    "dc_dense_ln_bwd_max_c": (_I, []),
    "dc_dense_ln_bwd_max_clusters": (_I, [_I, _I]),
    "dc_dense_ln_bwd_blocks": (_I, [_I]),
    # x, gamma, beta, w, g, u, e, du, mean, rstd, dx, xn, partial, dgamma_dbeta | rows,
    # C, N, act, stream
    "dc_dense_ln_bwd": (_I, [_P] * 14 + [_I, _I, _I, _I, _P]),
    "dc_tf_fwd_mma_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # qkv, wl, ww, out, probs | batch, N, H, d, scale, stream (transform_attention_mma.cu)
    "dc_transform_attention_mma": (_I, [_P] * 5 + [_I, _I, _I, _I, _F, _P]),
    "dc_tf_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "dc_tf_max_tq": (_I, []),
    # qkv, wl, ww, out, probs | batch, N, H, d, tq, scale, stream (transform_attention.cu)
    "dc_transform_attention": (_I, [_P] * 5 + [_I, _I, _I, _I, _I, _F, _P]),
    "dc_tf_bwd_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    # qkv, wl, ww, dout, probs, dqkv, ds_hi, ds_lo, partial, dwl_dww |
    # batch, N, H, d, scale, stream
    "dc_transform_attention_bwd": (_I, [_P] * 10 + [_I, _I, _I, _I, _F, _P]),
    "dc_tf_bwd_wide_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    # qkv, wl, ww, dout, probs, dqkv, pm_scratch, ds_scratch, partial, dwl_dww |
    # batch, N, H, d, tq, scale, stream (transform_attention_bwd_wide.cu)
    "dc_transform_attention_bwd_wide": (_I, [_P] * 10 + [_I, _I, _I, _I, _I, _F, _P]),
    # qkv, out, probs | batch, N, H, d, scale, causal, kv_len, stream
    "dc_plain_attention": (_I, [_P] * 3 + [_I, _I, _I, _I, _F, _I, _I, _P]),
    # qkv, dout, probs, dqkv | batch, N, H, d, scale, stream
    "dc_plain_attention_bwd": (_I, [_P] * 4 + [_I, _I, _I, _I, _F, _P]),
    # qkv, out | batch, N, H, d, scale, stream (plain_attention_long.cu)
    "dc_plain_attention_long": (_I, [_P] * 2 + [_I, _I, _I, _I, _F, _P]),
    # q, k, v, out, lse, strides (host, 4 x 3 int64) | batch, N, H, d, scale, causal,
    # kv_len, stream
    "dc_flash_attention_fwd": (_I, [_P] * 6 + [_I, _I, _I, _I, _F, _I, _I, _P]),
    # q, k, v, o, dout, lse, dq, dk, dv, strides (host, 8 x 3 int64) | batch, N, H, d,
    # scale, causal, kv_len, stream
    "dc_flash_attention_bwd": (_I, [_P] * 10 + [_I, _I, _I, _I, _F, _I, _I, _P]),
    "dc_flash_tf_fwd_mma_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # q, k, v, wl, ww, out, strides (host, 4 x 3 int64) | batch, N, H, d, scale, causal,
    # kv_len, stream (flash_transform_attention_mma.cu)
    "dc_flash_transform_attention_mma": (_I, [_P] * 7 + [_I, _I, _I, _I, _F, _I, _I, _P]),
    "dc_fta_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    # q, k, v, wl, ww, out, strides (host, 4 x 3 int64) | batch, N, H, d, tq, scale, causal,
    # kv_len, stream (flash_transform_attention.cu)
    "dc_flash_transform_attention_fwd": (_I, [_P] * 7 + [_I, _I, _I, _I, _I, _F, _I, _I, _P]),
}

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 232448

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from csrc/ with nvcc")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdistillclip_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc process per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o",
               str(obj_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for cmd, proc in jobs:
        text, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + text
        if proc.returncode != 0:
            failed.append(cmd[-1])
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *[c[-2] for c, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text(log)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib().dc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(what: str, *tensors, unaligned=(), fp32=()) -> None:
    """Refuse what the kernels do not take: they read contiguous tensors on
    one CUDA device, bf16 ``tensors`` with 16-byte loads, bf16 ``unaligned``
    ones element by element, and ``fp32`` ones (saved row statistics) as
    float32.  Gradients are the business of the ``autograd.Function`` around
    a wrapper, not of this check."""
    import torch

    dev = tensors[0].device
    for t in (*tensors, *unaligned, *fp32):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every operand must be on {dev}, got {t.device}")
        want = torch.float32 if any(t is f for f in fp32) else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{what}: the kernel takes {want} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16 and any(t is a for a in tensors):
            raise ValueError(f"{what}: operands must be 16-byte aligned")


def plain_only(what: str, t) -> bool:
    """True where the plain PyTorch version runs: a tensor on the CPU.

    A CUDA tensor goes to the kernel; any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return False


def needs_grad(*tensors) -> bool:
    """True when autograd will ask for a gradient of any of ``tensors``: the
    wrappers then go through their ``autograd.Function``, whose forward saves
    what its backward kernel reads."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)
