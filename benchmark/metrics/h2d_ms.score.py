"""Device ms a scored batch spends in host-to-device copies (the profiler's
``Memcpy HtoD`` events), over the traced batches."""


def read(r):
    trace = r.get("trace")
    if r["kind"] != "score" or trace is None or not r.get("units_profiled"):
        return None
    s = trace.seconds(lambda cat, name: cat == "gpu_memcpy" and "htod" in name.lower())
    return 1e3 * s / r["units_profiled"] if s > 0 else None
