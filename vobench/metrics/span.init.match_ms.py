"""Device ms of the init program's match (``models/vo.py::step_init``): between
its ``init.features`` and ``init.match`` markers. Median over the slice's
frames of that program; read by ``harness/spans.py`` from the slice run again
with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.init.match_ms")
