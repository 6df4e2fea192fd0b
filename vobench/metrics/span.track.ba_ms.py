"""Device ms of the tracking program's windowed BA and its select
(``models/ba.py::ba_update_state``): between its ``track.pnp`` and
``track.ba`` markers. Median over the slice's frames of that program; read by
``harness/spans.py`` from the slice run again with the port's spans on; None
where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.ba_ms")
