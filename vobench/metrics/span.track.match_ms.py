"""Device ms of the tracking program's candidate pool and 3D-2D match
(``models/vo.py::track_candidates``, ``match_candidates``, the matcher
``csrc/hamming_nn_top2.cu``): between its ``track.features`` and
``track.match`` markers. Median over the slice's frames of that program; read
by ``harness/spans.py`` from the slice run again with the port's spans on;
None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.track.match_ms")
