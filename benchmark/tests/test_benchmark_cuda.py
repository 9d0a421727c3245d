"""Every cell for a short window on the GPU, traced and not (on the card:
``python -m pytest -m cuda benchmark/tests/test_benchmark_cuda.py``); skipped
where there is none."""

from __future__ import annotations

import pytest

from bench_tiny import CELLS, run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rc, line = run_cell(cell, trace=trace, device=None)
    assert rc == 0 and line["correct"] and line["device"]["platform"] == "gpu", line
