"""The device's idle share over the profiled slice of a batch cell, in %: one
minus the union of its kernels' intervals over the slice's length."""


def read(trace):
    if trace.get("driver") != "batch" or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
