"""Device busy ms per replay of the ORB frontend (``ops/features.py``, stage
piece a), one tracking frame of the traced run's state captured as its own
graph."""


def read(trace):
    busy = trace.get("pieces", {}).get("busy_ms", {})
    return busy.get("a")
