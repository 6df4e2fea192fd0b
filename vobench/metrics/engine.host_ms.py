"""Host ms per tracking frame in ``VOEngine.add_frame`` (pinned copy, the
stage program's pick, the readback): each profiled tracking frame's wall
time minus its device busy time, averaged."""

TRACKING = 2  # the port's STAGE_TRACKING: the program that ran the frame


def read(trace):
    units = [u for u in trace.get("units", []) if u.get("program") == TRACKING]
    if trace.get("driver") != "live" or not units:
        return None
    return sum(u["wall_ms"] - u["busy_ms"] for u in units) / len(units)
