"""Device ms of the tracking program's ORB frontend (``ops/features.py``): from
the program's start marker to its ``track.features`` marker. Median over the
slice's frames of that program; read by ``harness/spans.py`` from the slice
run again with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.features_ms")
