"""Host ms of ``VOEngine.add_frame``'s ``engine.launch`` span per tracking frame
(``CapturedStep.load`` and the graph's replay launched). Median over the
slice's frames of that program; read by ``harness/spans.py`` from the slice
run again with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "engine.launch_ms")
