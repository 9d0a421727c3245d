"""Host ms a scored batch spends inside the program's ``score.stage`` span,
copying its pictures and tokens into pinned host memory
(``benchmark/spans.py``), over the traced batches."""

from benchmark.spans import host_ms


def read(r):
    return host_ms(r, "score", "score.stage")
