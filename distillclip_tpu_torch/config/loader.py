"""YAML configs: multi-file deep merge and the resolved-config snapshot.

Port of ``distillclip_tpu/config/loader.py``'s framework-free part: the
schema is ``{model, data, trainer, perf}``, repeated ``-c`` files merge in
order (a later file wins; lists are replaced whole), and a run writes the
merged config beside its results.  The towers of a config are built by
``serving.lclip_score.build_tower``; building a task, a data module and a
trainer from a config waits for the trainer (ROADMAP queue 1: the trainer).
"""

from __future__ import annotations

import copy
from typing import Dict, List

import yaml


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; ``override`` wins; lists replace wholesale."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_configs(paths: List[str]) -> Dict:
    """The YAML files merged in order."""
    merged: Dict = {}
    for path in paths:
        with open(path) as f:
            merged = deep_merge(merged, yaml.safe_load(f) or {})
    return merged


def save_resolved_config(cfg: Dict, out_path: str) -> None:
    with open(out_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
