"""Device busy ms per init-frame replay (the init stage program: the
two-view estimate over ``ops/twoview.py``, ``epipolar``, ``scoring``),
averaged over the profiled init frames."""

INIT = 1  # the port's STAGE_INITIALIZING


def read(trace):
    units = [u for u in trace.get("units", []) if u.get("program") == INIT]
    if trace.get("driver") != "live" or not units:
        return None
    return sum(u["busy_ms"] for u in units) / len(units)
