"""Device ms a train step launched under the program's ``step.teacher`` span:
the live teacher's forward, or the cached representations' cast and logits
(``benchmark/spans.py``), from the traced steps."""

from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "train", "step.teacher")
