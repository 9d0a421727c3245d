"""Device ms a train step launched under the program's ``step.loss`` span:
the gathers, the norms and the losses (``benchmark/spans.py``), from the
traced steps."""

from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "train", "step.loss")
