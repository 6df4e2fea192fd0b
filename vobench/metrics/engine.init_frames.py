"""Init-program frames (the engine's ``frames.init`` counter) the slice's fresh
session ran before tracking held. Read by ``harness/spans.py`` from the slice
run again with the port's spans on; None where the port has no spans."""

from harness import spans


def read(trace):
    return spans.read(trace, "engine.init_frames")
