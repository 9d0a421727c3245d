"""Device ms a train step launched under the program's ``step.optimizer``
span: the gradients' norm where it is logged and AdamW's update
(``benchmark/spans.py``), from the traced steps."""

from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "train", "step.optimizer")
