"""Device ms of the init program's gate, depth normalisation, map insert and
select, and its tail: from its ``init.twoview`` marker to its end marker.
Median over the slice's frames of that program; read by ``harness/spans.py``
from the slice run again with the port's spans on; None where the port has no
spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "span.init.gate_ms")
