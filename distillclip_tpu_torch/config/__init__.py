from distillclip_tpu_torch.config.loader import deep_merge, load_configs, save_resolved_config
from distillclip_tpu_torch.config.perf import (
    PERF_KNOBS,
    PerfKnobs,
    apply_perf_config,
    perf_knobs,
    require_kernels,
)

__all__ = [
    "PERF_KNOBS",
    "PerfKnobs",
    "apply_perf_config",
    "deep_merge",
    "load_configs",
    "perf_knobs",
    "require_kernels",
    "save_resolved_config",
]
