"""Device kernels per replay of the tracking program: the median count of
device records per profiled tracking frame."""

TRACKING = 2


def read(trace):
    ks = sorted(u["kernels"] for u in trace.get("units", []) if u.get("program") == TRACKING)
    if trace.get("driver") != "live" or not ks:
        return None
    return ks[len(ks) // 2]
