"""Device ms of the general batched body's stage selects and its tail: from its
``batch.track`` marker to its end marker. Median over the slice's steps of
that program; read by ``harness/spans.py`` from the slice run again with the
port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.batch.select_ms")
