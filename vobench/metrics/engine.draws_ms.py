"""Host ms of ``VOEngine.add_frame``'s ``engine.draws`` span per tracking frame
(the RANSAC draws made on the host, ``models/vo.py::_stage_draws``). Median
over the slice's frames of that program; read by ``harness/spans.py`` from the
slice run again with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "engine.draws_ms")
