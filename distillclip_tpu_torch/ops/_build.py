"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All of ``distillclip_tpu_torch/csrc/*.cu`` compile in one nvcc call into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libdistillclip_kernels_<hash>.so csrc/*.cu

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> (restype, argtypes); pointers and the stream are c_void_p so that
# ctypes does not cut them to 32-bit ints.
_SIGNATURES = {
    "dc_error_string": (ctypes.c_char_p, [_I]),
    "dc_layer_norm_rows": (_I, [_P, _P, _P, _P, _I, _I, _F, _P]),
    "dc_dense_ln_smem_bytes": (ctypes.c_longlong, [_I]),
    "dc_dense_ln": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
    "dc_tf_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "dc_tf_max_tq": (_I, []),
    "dc_transform_attention": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
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
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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


def check_operands(what: str, *tensors, unaligned=()) -> None:
    """Refuse what the kernels do not take: they read contiguous bf16 on
    one CUDA device, ``tensors`` with 16-byte loads (``unaligned`` ones
    element by element), and they have no backward."""
    import torch

    dev = tensors[0].device
    for t in (*tensors, *unaligned):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every operand must be on {dev}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16 and not any(t is u for u in unaligned):
            raise ValueError(f"{what}: operands must be 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{what}: no backward kernel yet (ROADMAP queue 2, the train "
                "step); run under torch.inference_mode()")


def plain_only(what: str, t) -> bool:
    """True where the plain PyTorch version runs: a tensor on the CPU.

    A CUDA tensor goes to the kernel; any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return False
