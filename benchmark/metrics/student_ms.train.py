"""Device ms a train step launched under the program's ``step.student`` span:
the students' inputs prepared, the masters cast, the students' forward
(``benchmark/spans.py``), from the traced steps."""

from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "train", "step.student")
