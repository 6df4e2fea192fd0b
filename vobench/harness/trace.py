"""The traced run's profiled slice and what the per-layer readers read.

After the window has closed, a bounded slice runs twice: first timed by the
host clock alone, then under ``torch.profiler`` (CPU and CUDA activity),
each frame or step inside a ``record_function`` range, between two runs of
spin kernels that take the device records a profile loses at its start. The
slice is a fresh live pass's first ``frames`` frames (both times from the
same key, so the same programs run on the same frames), or ``steps`` batch
steps (the next ones each time). Each frame's or step's kernels are the
device events that start inside its range (``add_frame`` and the batched
step end with a readback, so a frame's work is done before its range
closes). Its busy time comes from the profile and its wall time from the
first, unprofiled run: recording some 10^4 kernels a frame costs the host
milliseconds. No chrome trace is written.

The live cells also split one tracking frame of the slice's state into the
stage pieces (``pieces.py``) and time the matcher's launch against its
least time (``counts.py``). The pieces are built from the port's stage
functions, not cut from the tracking program itself (the program marks no
stage), so they are kept only while they close on it: their kernels and
busy time together within ``CLOSE_KERNELS`` and ``CLOSE_BUSY`` of the
profiled tracking frames'. A piece that no longer builds, or pieces that no
longer add up to the program that runs, leave the per-stage metrics out of
the result (and say why on standard error); the run goes on.
"""

from __future__ import annotations

import bisect
import sys
import time

import numpy as np
import torch

from . import counts, pieces
from .traffic import derive

RANGE = "vobench.unit"
CLOSE_KERNELS = (0.85, 1.02)   # pieces d + ba + keyframe over the tracking program's kernels
CLOSE_BUSY = (0.80, 1.05)      # and over its busy ms per frame (the glue is the rest)


def _union(intervals: list) -> list:
    """Merged [start, end] intervals of a list of (start, end), sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy(merged: list, lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


def timed_units(run_unit, n: int) -> list:
    """The host ms of ``run_unit(i)`` for i < n, without the profiler."""
    torch.cuda.synchronize()
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        run_unit(i)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profile_units(run_unit, n: int, wall_ms: list) -> dict:
    """``run_unit(i)`` for i < n under the profiler, each in a range, with
    ``wall_ms`` the same units' host ms without it. Returns ``{"units":
    [{"wall_ms", "busy_ms", "kernels", "profiled_ms"}], "busy_s", "window_s",
    "breakdown"}``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pieces.markers()
        torch.cuda.synchronize()
        for i in range(n):
            with torch.profiler.record_function(RANGE):
                run_unit(i)
        torch.cuda.synchronize()
        pieces.markers()
        torch.cuda.synchronize()
    raw = list(prof.profiler.kineto_results.events())
    # the ranges show on the device's timeline too (as user annotations)
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), pieces.kind(e.name())) for e in raw
           if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() != RANGE]
    cpu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in raw
           if e.device_type() != torch.autograd.DeviceType.CUDA]
    ranges = sorted((a, b) for a, b, name in cpu if name == RANGE)
    if len(ranges) != n:
        raise RuntimeError(f"profile: {len(ranges)} ranges recorded for {n} units")
    if not any("spin_kernel" in k for _, _, k in dev):
        raise RuntimeError("profile: no marker kernel recorded; the slice may have lost records")
    lo, hi = ranges[0][0], ranges[-1][1]
    kern = sorted((a, b, k) for a, b, k in dev if "spin_kernel" not in k and lo <= a <= hi)
    starts = [a for a, _, _ in kern]
    merged = _union([(a, b) for a, b, _ in kern])
    units = []
    for (u_lo, u_hi), wall in zip(ranges, wall_ms):
        mine = kern[bisect.bisect_left(starts, u_lo):bisect.bisect_right(starts, u_hi)]
        units.append(dict(wall_ms=wall, profiled_ms=(u_hi - u_lo) / 1e6, kernels=len(mine),
                          busy_ms=_busy(_union([(a, b) for a, b, _ in mine]), u_lo, u_hi) / 1e6))
    by_name = {}
    for a, b, k in kern:
        by_name[k] = by_name.get(k, 0) + (b - a)
    longest = sorted(((a1 - b0, b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                     reverse=True)[:10]
    gaps = []
    for length, b0, a1 in longest:
        mid = (b0 + a1) // 2
        doing = [(b - a, name) for a, b, name in cpu if a <= mid <= b and name != RANGE]
        gaps.append([min(doing)[1] if doing else "host, outside any op", length / 1e9])
    return dict(units=units, busy_s=_busy(merged, lo, hi) / 1e9, window_s=sum(wall_ms) / 1e3,
                breakdown=dict(
                    device_ops=[[k, v / 1e9] for k, v in sorted(by_name.items(),
                                                                key=lambda kv: -kv[1])[:10]],
                    idle_gaps=gaps))


def live_trace(drv, frames: int) -> dict:
    """The live driver's profiled slice: a fresh pass's first ``frames``
    frames; each unit's ``program`` is the stage whose program ran it. Then
    the stage pieces on the tracking state it ends in, at its next frame."""
    S = drv.S
    key = derive(drv.seed, "slice")
    drv._restart(key)
    wall = timed_units(lambda i: drv.engine.add_frame(drv.frame(0, i)), frames)
    drv._restart(key)
    stages = [S.STAGE_BLANK]

    def unit(i):
        stages.append(int(drv.engine.add_frame(drv.frame(0, i)).stage))

    rec = profile_units(unit, frames, wall)
    for u, s in zip(rec["units"], stages):
        u["program"] = s
    if stages[-1] == S.STAGE_TRACKING:
        try:
            p = stage_pieces(drv, drv.engine.state, drv.frame(0, frames))
            why = closure(p, rec["units"], S.STAGE_TRACKING)
        except Exception as e:   # the port's stage functions reshaped: no pieces
            p, why = None, f"{type(e).__name__}: {e}"
        if why:
            print(f"vobench: stage pieces left out: {why}", file=sys.stderr)
        else:
            rec["pieces"] = p
    return rec


def closure(p: dict, units: list, tracking: int) -> str:
    """Why the pieces do not close on the profiled tracking frames, or ""."""
    track = sorted((u["kernels"], u["busy_ms"]) for u in units if u["program"] == tracking)
    if not track:
        return "no tracking frame profiled"
    k_prog, b_prog = track[len(track) // 2]
    parts = [k for k in ("d", "ba", "keyframe") if k in p["kernels"]]
    k = sum(p["kernels"][x] for x in parts) / k_prog
    b = sum(p["busy_ms"][x] for x in parts) / b_prog
    if not (CLOSE_KERNELS[0] <= k <= CLOSE_KERNELS[1] and CLOSE_BUSY[0] <= b <= CLOSE_BUSY[1]):
        return (f"pieces {'+'.join(parts)} are {k:.3f} of the tracking program's kernels and "
                f"{b:.3f} of its busy ms")
    return ""


def batch_trace(drv, steps: int) -> dict:
    wall = timed_units(lambda i: drv._step(), steps)
    return profile_units(lambda i: drv._step(), steps, wall)


def stage_pieces(drv, st, frame: np.ndarray) -> dict:
    """Busy ms per replay of each stage of the tracking frame on ``st`` (its
    key in ``rng``) and ``frame``: features (piece a), RANSAC-PnP (piece d
    after its prefix c, read inside d's profile), BA, the keyframe update;
    and the matcher's launch in c: its device ms and least ms."""
    cfg, cam = drv.cfg, drv.engine.cam
    img = torch.from_numpy(np.asarray(frame)).to(drv.device).to(torch.float32)
    ch = pieces.tracking_chain(cfg, cam, st, int(st.rng), img, height=drv.h, width=drv.w)
    fns = pieces.track_pieces(cfg, cam, ch, height=drv.h, width=drv.w)
    seq = {k: pieces.profile_replays(k, pieces.capture(fn, drv.device)) for k, fn in fns.items()}
    busy = {k: sum(ms for _, ms in s) / pieces.PROFILED for k, s in seq.items()}
    kernels = {k: len(s) / pieces.PROFILED for k, s in seq.items()}
    busy["pnp"] = pieces.after_prefix(seq["c"], seq["d"])
    f, cs, m = fns["c"]()
    hamming = [ms for n, ms in seq["c"] if "hamming" in n]
    return dict(busy_ms=busy, kernels=kernels, hamming_ms=sum(hamming) / pieces.PROFILED,
                hamming_bound_ms=counts.matcher_bound_ms(
                    cs.proj, cs.proj_alt, cs.comp_ok, f.kpts, f.valid,
                    cfg.match.max_pixel_dist_pnp))
