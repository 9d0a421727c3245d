from distillclip_tpu_torch.config.loader import (
    build_trainer,
    class_aliases,
    deep_merge,
    instantiate,
    load_configs,
    resolve_class,
    save_resolved_config,
)
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
    "build_trainer",
    "class_aliases",
    "deep_merge",
    "instantiate",
    "load_configs",
    "perf_knobs",
    "require_kernels",
    "resolve_class",
    "save_resolved_config",
]
