"""Device busy ms per replay of the captured general batched step
(``models/vo.py::general_batched_body`` under ``torch.func.vmap``),
averaged over the profiled steps."""


def read(trace):
    units = trace.get("units", [])
    if trace.get("driver") != "batch" or not units:
        return None
    return sum(u["busy_ms"] for u in units) / len(units)
