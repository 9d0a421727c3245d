"""Device ms a train step launched under the program's ``step.backward``
span: autograd's backward (launched from its own thread while the step's
waits in the span), the zero gradients of unused leaves and their sum over
ranks (``benchmark/spans.py``), from the traced steps."""

from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "train", "step.backward")
