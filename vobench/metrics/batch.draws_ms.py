"""Host ms of the batched step's ``batch.draws`` span per step (every stream's
RANSAC draws on the host, ``models/vo.py::draw_general``). Median over the
slice's steps of that program; read by ``harness/spans.py`` from the slice run
again with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "batch.draws_ms")
