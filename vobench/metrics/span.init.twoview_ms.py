"""Device ms of the init program's two-view estimate and triangulation angles
(``ops/twoview.py::estimate_relative_pose``): between its ``init.match`` and
``init.twoview`` markers. Median over the slice's frames of that program; read
by ``harness/spans.py`` from the slice run again with the port's spans on;
None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.init.twoview_ms")
