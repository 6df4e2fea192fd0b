"""Device ms of the tracking program's keyframe update, its select and the
outputs (``models/vo.py::keyframe_update``, the program's tail): from its
``track.ba`` marker to its end marker. Median over the slice's frames of that
program; read by ``harness/spans.py`` from the slice run again with the port's
spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.keyframe_ms")
