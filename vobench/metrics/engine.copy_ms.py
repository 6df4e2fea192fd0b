"""Host ms of ``VOEngine.add_frame``'s ``engine.copy`` span per tracking frame
(the frame as a tensor, pinned, uploaded). Median over the slice's frames of
that program; read by ``harness/spans.py`` from the slice run again with the
port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "engine.copy_ms")
