"""Host ms a train step spends inside the step call before it returns (no
fence), the mean over the window's steps (host clock, taken by the driver
around each call)."""


def read(r):
    d = r.get("dispatch_s")
    return 1e3 * sum(d) / len(d) if r["kind"] == "train" and d else None
