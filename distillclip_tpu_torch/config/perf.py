"""Perf knobs as config: the YAML ``perf:`` section.

Port of ``distillclip_tpu/config/perf.py``.  A config may pin the knobs that
steer the kernels::

    perf:
      fc1_ln: "0"
      fc1_res: u
      tf_impl: factored

:func:`apply_perf_config` writes each pinned knob to its ``DISTILLCLIP_*``
variable and returns the effective map: a variable already set in the
process overrides the YAML, YAML booleans become ``"1"`` / ``"0"``, an
unknown knob raises, and knobs set only in the environment are folded in.

The port reads the variables once, when a tower is built
(:func:`perf_knobs`), not in every forward.  Two knobs select another
function path on the card:

* ``fc1_ln: "0"`` unfuses the pre-LayerNorms: the norms run as the row
  LayerNorm (K4, #7 under a gradient), qkv is a plain product and fc1 + GELU
  the no-LN GEMM (#12 without a gradient, #10 with one);
* ``fc1_res: u`` makes fc1 under a gradient write u only (#11, or K1 with
  its statistics where the LayerNorm is fused), and h and e come from u;

``flash: "0"`` and ``fc1: xla`` ask for no kernel at all; on the card the
port refuses them (:func:`require_kernels`), on the CPU they change nothing.
``tf_impl: factored`` asks for the JAX package's per-head formulation of the
head-transform attention (#18), which is how K3 / #5 / #6 compute it already:
the port's path does not change.  The others choose among TPU
implementations of one function (block sizes, layouts, dispatch); they are
accepted and recorded and do nothing here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

ENV_PREFIX = "DISTILLCLIP_"

# every knob of the JAX package, in its order
PERF_KNOBS = (
    "flash",            # master kernel switch (1 default; 0 = no kernel)
    "plain_attn",       # TPU layout of plain attention
    "causal_attn",      # TPU layout of causal attention
    "flash_hc",         # TPU head-chunk override
    "fc1",              # fc1 kernel: kernel|xla
    "fc1_blk",          # TPU fc1 row-block size
    "fc1_ln",           # LayerNorm folded into the dense kernels (1) or not (0)
    "fc1_res",          # fc1 backward residuals: ue (default) or u
    "tf_impl",          # head-transform attention: colcat (default) or factored
    "tf_bwd",           # TPU transform backward selection
    "tf_bwd_gb",        # TPU transform backward grid block
    "tf_gb",            # TPU transform forward grid block
    "tf_fa_gb",         # TPU factored-kernel grid block
    "tf_hc",            # TPU transform head chunk
    "tf_mix",           # TPU head-mix formulation
    "tf_scores",        # TPU scores layout
    "tf_il",            # TPU transform interleave
    "true_n",           # TPU true-sequence-length mode
    "true_n_max_rows",  # TPU true-N row ceiling
)

NO_KERNEL_ITEM = ("ROADMAP queue 1, do not port: the port keeps only the perf knobs that mean "
                  "something on the H100, and every path of the port runs its kernels")


def apply_perf_config(perf_cfg: Optional[Dict]) -> Dict[str, str]:
    """Apply a config ``perf:`` section; return the effective knob map."""
    effective: Dict[str, str] = {}
    for key, val in dict(perf_cfg or {}).items():
        key = str(key).lower()
        if key not in PERF_KNOBS:
            raise ValueError(f"unknown perf knob {key!r}; known: {', '.join(PERF_KNOBS)}")
        env = ENV_PREFIX + key.upper()
        if env in os.environ:
            effective[key] = os.environ[env]
        else:
            sval = ("1" if val else "0") if isinstance(val, bool) else str(val)
            os.environ[env] = sval
            effective[key] = sval
    for key in PERF_KNOBS:
        env = ENV_PREFIX + key.upper()
        if key not in effective and env in os.environ:
            effective[key] = os.environ[env]
    return effective


@dataclasses.dataclass(frozen=True)
class PerfKnobs:
    """What the knobs mean to the port, read once when a tower is built.

    ``no_kernel`` names the knob that asks for no kernel, or is None."""

    ln_fusion: bool = True
    fc1_res: str = "ue"
    no_kernel: Optional[str] = None


def perf_knobs() -> PerfKnobs:
    """The knobs as the environment sets them now, parsed as the JAX package
    parses them (``models/layers.py::ln_fusion_active``, ``ops/fc1_act.py::
    _res_mode``)."""
    env = lambda key, default: os.environ.get(ENV_PREFIX + key.upper(), default)
    no_kernel = None
    if env("flash", "1") != "1":
        no_kernel = f"flash={env('flash', '1')!r}"
    elif env("fc1", "kernel") != "kernel":
        no_kernel = f"fc1={env('fc1', 'kernel')!r}"
    return PerfKnobs(ln_fusion=env("fc1_ln", "1") != "0",
                     fc1_res="u" if env("fc1_res", "ue") == "u" else "ue",
                     no_kernel=no_kernel)


def require_kernels(knobs: PerfKnobs, device) -> None:
    """Refuse a knob that asks for no kernel when the work is for the card."""
    import torch

    if knobs.no_kernel is not None and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"perf knob {knobs.no_kernel} asks for a path without kernels, which the port "
            f"does not have on the card ({NO_KERNEL_ITEM})")


def set_perf(module, knobs: PerfKnobs):
    """``module`` with ``knobs`` on every submodule that reads them: a tower
    built earlier, or lazily, runs as if it had been built under them."""
    for m in module.modules():
        if hasattr(m, "perf"):
            m.perf = knobs
    return module


def require_module_kernels(module, device) -> None:
    """:func:`require_kernels` for the knobs every submodule was built under."""
    for m in module.modules():
        if hasattr(m, "perf"):
            require_kernels(m.perf, device)
