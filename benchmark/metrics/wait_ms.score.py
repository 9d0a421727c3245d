"""Host ms a scored batch spends inside the program's ``score.wait`` span,
waiting for its scores and copying them out (``benchmark/spans.py``), over
the traced batches: near 0 where the host paces the stream, large where the
device does."""

from benchmark.spans import host_ms


def read(r):
    return host_ms(r, "score", "score.wait")
