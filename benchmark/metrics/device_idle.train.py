"""The share of the traced train steps' wall in which the device ran no
kernel, copy or memset: 1 − their union ÷ the span, in %."""


def read(r):
    trace = r.get("trace")
    if r["kind"] != "train" or trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
