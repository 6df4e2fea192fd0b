"""The matcher kernel's share of its roofline, in %: the least time of the
tracking frame's match (``harness/counts.py``: its operations and bytes
against the H100 SXM's peaks) over the kernel's device time by name, on
stage piece c's replays."""


def read(trace):
    p = trace.get("pieces")
    if not p or not p.get("hamming_ms"):
        return None
    return 100.0 * p["hamming_bound_ms"] / p["hamming_ms"]
