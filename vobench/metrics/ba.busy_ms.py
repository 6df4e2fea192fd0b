"""Device busy ms per replay of ``models/ba.py::ba_update_state`` on the state
the tracking program hands it, one tracking frame of the traced run's state
captured as its own graph."""


def read(trace):
    busy = trace.get("pieces", {}).get("busy_ms", {})
    return busy.get("ba")
