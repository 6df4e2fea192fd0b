"""The port's own spans and counters, read for the traced run's per-layer
metrics (``metrics/span.*``, ``engine.*``, ``batch.draws_ms``).

The traced slice (``trace.py``) times the port from outside its programs.
Here the same slice runs again on a driver built with the port's spans on
(``monocular_visual_odometry_tpu_torch/utils/logging.py``: marker kernels
inside the captured programs, host spans in ``add_frame`` and the batched
step): the cell's own driver class, configuration, traffic and seed, its
set-up included (live: the steady phase too, since a new engine's frames run
slower for their first 20-40 s). The live slice is a fresh pass from the
slice's key, its first ``frames`` frames; the batch slice ``steps`` steps.
Each runs twice:

1. unprofiled: each frame's or step's device spans (the program's slots,
   read back with its outputs), host spans and, live, the engine's counters;
2. under ``torch.profiler`` (:func:`profile`, with ``trace.py``'s guards
   against a profile that lost device records): the marker kernels and the
   ``vo.*`` ranges on one clock, for the device's idle time split by the
   innermost ``vo.*`` span covering it, printed on standard error. On an
   H100 this profile's device events can fall outside their own frame's
   host range (a tracking frame's range held 5,459-8,325 device records and
   0-8 markers where its program runs 7,035), so the split's labels are
   approximate, and the tracking frames' busy time is read over each run of
   consecutive tracking frames whole (:func:`tracking_busy_ms`), where a
   record put in a neighbour's range still counts.

Values are medians over the slice's frames or steps of one program. The
tracking frames' gaps between kernels are the median unprofiled time from a
frame's first marker to its last less that busy time per frame, none below
0: the profiler stretches the time between kernels, not the kernels. Both
come from the same engine: a new engine's frames may run slower on the
device for its first 20-40 s.

The readers find the values with :func:`read`. The first call measures, at
the end of the traced run (the run's driver is gone by then, so the cell and
seed come from ``run.py``'s command line), and keeps the result in the
trace under ``spans``. A port without spans, or a caller that is not
``run.py --trace 1`` on a card, gives an empty result (said on standard
error), and every reader then returns None; where the port has spans, a
failure of the measurement fails the traced run.
"""

from __future__ import annotations

import argparse
import bisect
import statistics
import sys
from pathlib import Path

import torch

from . import pieces, spec
from .trace import _busy, _union
from .traffic import derive

UNIT = "vobench.spans.unit"
TRACKING, INITIALIZING, BLANK = 2, 1, 0   # the port's stages
TRACK = ("features", "match", "pnp", "ba", "keyframe")
INIT = ("features", "match", "twoview", "gate")
BATCH = ("features", "init", "track", "select")


def read(trace: dict, name: str):
    """Metric ``name`` of the traced run ``trace`` (measured at the first
    call, see the module's docstring), or None."""
    if "spans" not in trace:
        trace["spans"] = _measure_run()
    return trace["spans"].get(name)


def _port_logging():
    """The port's tracing module, if it has spans."""
    from monocular_visual_odometry_tpu_torch.utils import logging as lg

    return lg if hasattr(lg, "spans") and hasattr(lg, "last_marks") else None


def _measure_run() -> dict:
    """The traced run's spans, from ``run.py``'s ``--workload`` and
    ``--seed``; {} where the port has none or the caller is not such a run."""
    if _port_logging() is None:
        print("vobench: the port has no spans; the span metrics are left out", file=sys.stderr)
        return {}
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if not (args.workload and args.seed is not None and args.trace == 1
            and torch.cuda.is_available()):
        print("vobench: the span metrics are measured only under run.py --trace 1 on a card; "
              "left out (harness.spans.measure takes a cell's driver directly)", file=sys.stderr)
        return {}
    cell = spec.find_cell(args.workload, Path(spec.BENCH_DIR).parent)
    traffic = cell.traffic
    return measure(spec.driver(traffic["driver"], cell.bench_dir),
                   spec.vo_config(cell.config), traffic, args.seed, "cuda")


def measure(driver_cls, cfg, traffic: dict, seed: int, device) -> dict:
    """Build ``driver_cls`` on ``cfg``, ``traffic`` and ``seed`` with spans
    on, run its slice unprofiled and profiled, and return
    {metric name: value} with a few readings more (``closure.*``, ``idle.*``)."""
    lg = _port_logging()
    kind = traffic["driver"]
    if kind not in ("live", "batch"):
        return {}
    with lg.spans(True):
        drv = driver_cls(cfg, traffic, seed, device)
        try:
            if kind == "live":
                return _live(lg, drv, traffic["profile"]["frames"])
            return _batch(lg, drv, traffic["profile"]["steps"])
        finally:
            drv.free()


def _host_ms(lg, run) -> dict:
    """``run()``'s host spans, {name: ms}."""
    h0 = lg.host_totals()
    run()
    h1 = lg.host_totals()
    return {k: (s - h0.get(k, (0, 0.0))[1]) * 1e3 for k, (_, s) in h1.items()
            if s != h0.get(k, (0, 0.0))[1]}


def _median(values: list):
    return statistics.median(values) if values else None


def _live(lg, drv, frames: int) -> dict:
    eng, key = drv.engine, derive(drv.seed, "slice")
    drv._restart(key)
    init_before = eng.counters["frames.init"]
    rows, stage = [], BLANK
    for i in range(frames):
        outs = []
        host = _host_ms(lg, lambda: outs.append(eng.add_frame(drv.frame(0, i))))
        rows.append(dict(program=stage, host=host,
                         device=lg.last_marks() if stage != BLANK else {}))
        stage = int(outs[0].stage)
    out = {"engine.init_frames": eng.counters["frames.init"] - init_before}
    track = [r for r in rows if r["program"] == TRACKING]
    init = [r for r in rows if r["program"] == INITIALIZING]
    for part in TRACK:
        out[f"span.track.{part}_ms"] = _median([r["device"][f"track.{part}"] for r in track])
    for part in INIT:
        out[f"span.init.{part}_ms"] = _median([r["device"][f"init.{part}"] for r in init])
    for part in ("copy", "draws", "launch", "readback", "finish"):
        out[f"engine.{part}_ms"] = _median([r["host"].get(f"engine.{part}", 0.0)
                                            for r in track])
    drv._restart(key)
    dev, cpu = profile(lambda i: eng.add_frame(drv.frame(0, i)), frames)
    window = _median([sum(r["device"][f"track.{p}"] for p in TRACK) for r in track])
    busy = tracking_busy_ms(dev, cpu, [r["program"] for r in rows])
    if window is not None and busy:
        out.update({"span.track.gaps_ms": max(0.0, window - busy),
                    "closure.track_sum_ms": window, "closure.track_busy_ms": busy,
                    "closure.track_sum_over_busy": window / busy})
    out.update(_report(dev, cpu, "outside add_frame", out))
    return out


def _batch(lg, drv, steps: int) -> dict:
    rows = []
    for _ in range(steps):
        host = _host_ms(lg, drv._step)
        rows.append(dict(host=host, device=lg.last_marks()))
    out = {f"span.batch.{p}_ms": _median([r["device"][f"batch.{p}"] for r in rows])
           for p in BATCH}
    out["batch.draws_ms"] = _median([r["host"].get("batch.draws", 0.0) for r in rows])
    dev, cpu = profile(lambda i: drv._step(), steps)
    return dict(out, **_report(dev, cpu, "outside the step", out))


def _report(dev: list, cpu: list, outside: str, out: dict) -> dict:
    """Print the closure and the device's idle time by span; return the idle
    shares as ``idle.<label>`` (% of the slice)."""
    idle = idle_by_span(dev, cpu, outside)
    window = sum(idle.values()) + busy_ns(dev, cpu)
    shares = {f"idle.{k}": 100.0 * v / window for k, v in idle.items()} if window else {}
    print("spans (spans on): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                                            if v is not None), file=sys.stderr)
    print("device idle by innermost span, % of the profiled slice: " + ", ".join(
        f"{k[5:]} {v:.2f}" for k, v in sorted(shares.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    return shares


def profile(run_unit, n: int) -> tuple:
    """``run_unit(i)`` for i < n under the profiler, each in a ``UNIT`` range,
    between two runs of spin kernels (``pieces.markers``: a profile loses
    device records at its start): (device events, host ranges), each
    [(start ns, end ns, name)] on the profiler's clock, the spin kernels left
    out. Raises, as ``trace.profile_units`` does, unless n ranges and a spin
    kernel were recorded."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pieces.markers()
        torch.cuda.synchronize()
        for i in range(n):
            with torch.profiler.record_function(UNIT):
                run_unit(i)
        torch.cuda.synchronize()
        pieces.markers()
        torch.cuda.synchronize()
    return events(list(prof.profiler.kineto_results.events()), n)


def events(raw: list, n: int) -> tuple:
    """:func:`profile`'s (device events, host ranges) from the profiler's
    records ``raw`` of ``n`` units; raises where records were lost."""
    on_card = torch.autograd.DeviceType.CUDA
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), pieces.kind(e.name()))
           for e in raw if e.device_type() == on_card
           and not e.name().startswith(("vo.", UNIT))]
    cpu = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in raw
                 if e.device_type() != on_card and e.name().startswith(("vo.", UNIT)))
    ranges = sum(name == UNIT for _, _, name in cpu)
    if ranges != n:
        raise RuntimeError(f"profile: {ranges} ranges recorded for {n} units")
    if not any("spin_kernel" in k for _, _, k in dev):
        raise RuntimeError("profile: no spin kernel recorded; the slice may have lost records")
    return sorted(e for e in dev if "spin_kernel" not in e[2]), cpu


def busy_ns(dev: list, cpu: list) -> int:
    """Device busy ns inside the slice (from the first unit's start to the
    last one's end)."""
    units = [(a, b) for a, b, n in cpu if n == UNIT]
    if not units:
        return 0
    return _busy(_union([(a, b) for a, b, _ in dev]), units[0][0], units[-1][1])


def tracking_busy_ms(dev: list, cpu: list, programs: list):
    """Device busy ms per tracking frame of a profiled slice whose ``UNIT``
    ranges ran ``programs``: over each run of consecutive tracking frames,
    from its first range's start to its last range's end; None without a
    tracking frame."""
    units = [(a, b) for a, b, n in cpu if n == UNIT]
    merged = _union([(a, b) for a, b, _ in dev])
    busy = count = i = 0
    while i < len(programs):
        j = i
        while j < len(programs) and programs[j] == TRACKING:
            j += 1
        if j > i:
            busy += _busy(merged, units[i][0], units[j - 1][1])
            count += j - i
        i = j + 1
    return busy / count / 1e6 if count else None


def idle_by_span(dev: list, cpu: list, outside: str) -> dict:
    """The device's idle ns inside the slice (from the first unit's start to
    the last one's end), by the innermost ``vo.*`` range covering it on the
    host: ``unit, outside vo.* spans`` inside a unit but no span, ``outside``
    beyond every unit."""
    units = [(a, b) for a, b, n in cpu if n == UNIT]
    if not units:
        return {}
    lo, hi = units[0][0], units[-1][1]
    busy = [(max(a, lo), min(b, hi)) for a, b in _union([(a, b) for a, b, _ in dev])
            if b > lo and a < hi]
    idle, at = [], lo
    for a, b in busy:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if at < hi:
        idle.append((at, hi))
    # the host's time cut at every range boundary; each piece's innermost range
    cuts = sorted({t for a, b, _ in cpu for t in (a, b) if lo <= t <= hi} | {lo, hi})
    labels = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        # the innermost: the latest to start, the first to end among those
        cover = [(ra, -rb, name) for ra, rb, name in cpu if ra <= mid < rb]
        if not cover:
            labels.append(outside)
        else:
            name = max(cover)[2]
            labels.append("unit, outside vo.* spans" if name == UNIT else name[3:])
    out: dict = {}
    for a, b in idle:
        i = max(0, bisect.bisect_right(cuts, a) - 1)
        while a < b and i < len(labels):
            end = min(b, cuts[i + 1])
            out[labels[i]] = out.get(labels[i], 0) + (end - a)
            a, i = end, i + 1
    return out
