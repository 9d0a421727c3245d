"""Device ms a train step spends in kernels that are neither the program's
own (the ``PATTERNS`` of ``kernels/``) nor a library's (cuBLAS, cuDNN,
NCCL): PyTorch's eager elementwise, reduction, copy-kernel and optimizer
passes, from the traced steps."""

from benchmark.common import kernel_files
from benchmark.trace import LIBRARY, matches


def read(r):
    trace = r.get("trace")
    if r["kind"] != "train" or trace is None or trace.busy_s <= 0:
        return None
    own = [p for k in kernel_files() for p in k.PATTERNS] + list(LIBRARY)
    s = trace.seconds(lambda cat, name: cat == "kernel" and not matches(name, own))
    return 1e3 * s / r["units_profiled"]
