"""The PyTorch port, chip_smoke.py, chip_ab.py and the on-card tests (which
run where there is no JAX) import neither JAX, Flax nor the JAX package.

The check is static (an AST scan of every module): the test process itself
has JAX loaded, so ``sys.modules`` cannot tell what the port would import on
a machine without it.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "distillclip_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "tests" / "test_torch_cuda.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distillclip_tpu")


def _imported_modules(path: Path):
    """Every module an import statement of ``path`` names, at any depth
    (imports inside functions included)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_port_files_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "chip_ab.py", "tests/test_torch_cuda.py",
            "distillclip_tpu_torch/serving/lclip_score.py",
            "distillclip_tpu_torch/ops/fc1_act.py", "distillclip_tpu_torch/cli.py",
            "distillclip_tpu_torch/config/perf.py", "distillclip_tpu_torch/config/loader.py",
            "distillclip_tpu_torch/data/tokenizer.py", "distillclip_tpu_torch/data/transforms.py",
            "distillclip_tpu_torch/data/native_loader.py",
            "distillclip_tpu_torch/training/checkpoints.py",
            "distillclip_tpu_torch/data/loader.py", "distillclip_tpu_torch/data/datamodule.py",
            "distillclip_tpu_torch/data/component/synthetic.py",
            "distillclip_tpu_torch/training/trainer.py", "distillclip_tpu_torch/training/metrics.py",
            "distillclip_tpu_torch/training/logging.py",
            "distillclip_tpu_torch/training/profiling.py",
            "distillclip_tpu_torch/tools/lr_finder.py",
            "distillclip_tpu_torch/data/component/utils.py",
            "distillclip_tpu_torch/data/component/ms_coco.py",
            "distillclip_tpu_torch/data/component/combine_image_dataset.py",
            "distillclip_tpu_torch/data/component/combine_text_dataset.py",
            "distillclip_tpu_torch/data/component/text_image_webdataset.py",
            "distillclip_tpu_torch/parallel/__init__.py",
            "distillclip_tpu_torch/parallel/distributed.py",
            "distillclip_tpu_torch/tools/dryrun.py",
            "distillclip_tpu_torch/tools/fabricate_images.py",
            "distillclip_tpu_torch/models/frozen_teacher.py",
            "distillclip_tpu_torch/models/irpe.py", "distillclip_tpu_torch/models/resnet.py",
            "distillclip_tpu_torch/tools/hw_oracle.py",
            "distillclip_tpu_torch/tools/hw_trajectory.py",
            "distillclip_tpu_torch/tools/roofline.py",
            "distillclip_tpu_torch/tools/trace_summary.py",
            "distillclip_tpu_torch/tools/input_bench.py",
            "distillclip_tpu_torch/tools/cached_teacher_ab.py",
            "distillclip_tpu_torch/tools/experiments.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_module_imports_no_jax(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,bad", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("from flax import linen", True),
    ("import distillclip_tpu.models", True),
    ("from distillclip_tpu.ops import fc1_act", True),
    ("def f():\n    import jax\n", True),
    ("import distillclip_tpu_torch", False),
    ("from distillclip_tpu_torch.ops import _build", False),
    ("import torch", False),
    ("from . import ops", False),
])
def test_scan_flags_exactly_the_forbidden_imports(tmp_path, source, bad):
    path = tmp_path / "mod.py"
    path.write_text(source)
    assert any(_forbidden(m) for m in _imported_modules(path)) is bad
