"""Device ms of the tracking program's RANSAC-PnP and pose checks
(``ops/pnp.py``, ``ops/ransac.py``, the rest of ``step_track``): between its
``track.match`` and ``track.pnp`` markers. Median over the slice's frames of
that program; read by ``harness/spans.py`` from the slice run again with the
port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.pnp_ms")
