"""Device busy ms per replay of RANSAC-PnP (``ops/pnp.py``, ``ops/ransac.py``:
piece d after its prefix c, read inside d's profile), one tracking frame of
the traced run's state captured as its own graph."""


def read(trace):
    busy = trace.get("pieces", {}).get("busy_ms", {})
    return busy.get("pnp")
