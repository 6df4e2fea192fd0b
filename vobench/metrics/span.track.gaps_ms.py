"""Device ms between kernels inside a replay of the tracking program: the
frame's unprofiled time from its first marker to its last, less the device
busy time between the same frame's first and last marker when the slice runs
again under the profiler (which stretches the time between kernels, not the
kernels); none below 0. Median over the slice's frames of that program; read
by ``harness/spans.py`` from the slice run again with the port's spans on;
None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.gaps_ms")
