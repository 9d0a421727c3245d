"""A tiny size of every cell for the CPU tests: the cells, configurations and
traffic as ``BENCHMARK.json`` names them, with every width and count cut so
that a run takes seconds on a CPU, and the benchmark's cache in a temporary
directory."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common, weights  # noqa: E402

TEACHER = {"model": "tiny", "image_resolution": 32, "vision_patch_size": 8, "vision_width": 128,
           "vision_layers": 2, "embed_dim": 32, "context_length": 16, "vocab_size": 1000,
           "transformer_width": 128, "transformer_layers": 2, "seed": 0}
CELLS = ("lclip_b32.train_textcached", "distill_l14.train_stage1", "lclip_b32.score_stream")


def tiny_config(name: str, dtype: str = "bfloat16") -> dict:
    cfg = common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")
    cfg["name"] = name
    cfg["teacher"] = dict(TEACHER, text=cfg["teacher"]["text"])
    for key in ("image_student", "student_encoder"):
        if key in cfg:
            cfg[key].update(img_size=32, patch_size=8, embed_dim=64, num_heads=4, depth=2,
                            out_dim=32)
    if "text_student" in cfg:
        cfg["text_student"].update(vocab_size=1000, context_length=16, embed_dim=64,
                                   num_heads=4, depth=2, out_dim=32)
    cfg.update(reference_rows=3, compute_dtype=dtype)
    return cfg


def tiny_traffic(name: str) -> dict:
    mix = {"name": name, **common.load_json(common.BENCH_DIR / "traffic" / f"{name}.json")}
    mix.update(pairs=8, pool=4)
    if "caption_len" in mix:
        mix["caption_len"] = [3, 10]
    return mix


def install(monkeypatch, tmp_path: Path, dtype: str = "bfloat16") -> None:
    """Point the harness at the tiny configurations and a temporary cache."""
    monkeypatch.setattr(common, "config", lambda name: tiny_config(name, dtype))
    monkeypatch.setattr(common, "traffic", tiny_traffic)
    monkeypatch.setattr(weights, "CACHE_DIR", tmp_path / "cache")


def run_cell(cell: str, seed: int = 2 ** 31 + 7, trace: int = 0, device="cpu") -> tuple:
    """(exit code, the result line) of one run on the CPU (``device`` None:
    on the GPU, after the harness's own look for one)."""
    import json
    from contextlib import redirect_stdout
    from io import StringIO

    from benchmark import run

    out = StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], device=device)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
