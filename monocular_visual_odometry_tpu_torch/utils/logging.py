"""Spans, the summary table, the per-frame banner, and a profiler trace.

The port's one tracing system (the JAX package's ``StageTimer`` and
``jax_trace`` have their counterparts here):

- **The switch.** ``spans(True)`` turns spans on and ``spans(False)`` off,
  from there on or, used as a context manager, until its block ends. Off is
  the default. Off, a per-frame span site is one boolean test, no marker is
  captured into a program and no extra kernel runs or value is read back.
- **Host spans.** ``with span("engine.copy"):`` around a step of the host's
  per-frame path. On, it adds its ``time.perf_counter_ns`` duration to
  per-name totals, which runs without a profiler read (:func:`host_totals`),
  and while a profiler records it is also a ``torch.profiler.record_function``
  range named ``vo.<name>``, which puts it on the device events' clock
  (without a profiler such a range records nothing, and costs host time).
  ``with timed(name) as t:`` always takes ``t.seconds`` and the totals (the
  range only when on): for set-up (a capture's warm-up and graph) and the
  CLI's own steps, whose callers report the seconds either way.
- **Device spans.** A program made by ``models/capture.py::CapturedStep``
  with span names, while spans are on, owns a slot buffer; each of its runs
  writes slot 0 when it starts, one slot at each :func:`mark` inside its
  function, and the last slot when it ends (``ops/cuda/span_mark.py``: the
  card's ``%globaltimer`` in stream order, captured into the graph). Span
  ``names[i]`` is the time between slots i and i + 1. The caller reads the
  slots back with the program's outputs and hands them to
  :func:`record_marks` (per-name totals, :func:`device_totals`, and the last
  run's spans, :func:`last_marks`).
- :func:`summary` prints the totals and a set of counters as a table;
  :func:`torch_trace` writes a profile of a block as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Sequence

import torch

from monocular_visual_odometry_tpu_torch.ops.cuda.span_mark import span_mark

_on = False
_host: dict = {}      # name -> [count, ns]
_device: dict = {}    # name -> [count, ns]
_last: dict = {}      # name -> ms, the last recorded run of a marked program
_marks = None         # the marked program whose function runs now


class spans:
    """The span switch: ``spans(True)`` / ``spans(False)`` set it from here
    on; ``with spans(on):`` sets it for the block and restores the previous
    setting after it."""

    def __init__(self, on: bool):
        global _on
        self._previous, _on = _on, bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self._previous


def spans_on() -> bool:
    return _on


def _add(totals: dict, name: str, ns: int) -> None:
    t = totals.setdefault(name, [0, 0])
    t[0] += 1
    t[1] += ns


class _Span:
    """A host span: its duration in the totals (``seconds`` after the block),
    and a ``vo.<name>`` profiler range while spans are on and a profiler
    records."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name, self.seconds = name, None

    def __enter__(self):
        self._range = (torch.profiler.record_function(f"vo.{self.name}")
                       if _on and torch._C._autograd._profiler_enabled() else None)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self.seconds = ns / 1e9
        _add(_host, self.name, ns)


class _Off:
    """What :func:`span` gives while spans are off: nothing happens."""

    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_OFF = _Off()


def span(name: str):
    """A host span of the per-frame path: measured only while spans are on."""
    return _Span(name) if _on else _OFF


def timed(name: str) -> _Span:
    """A host span measured whether spans are on or not (``seconds``)."""
    return _Span(name)


class _Marking:
    """One run of a marked program: its slots and the boundaries it wrote."""

    def __init__(self, names: Sequence[str], slots: torch.Tensor):
        self.index = {n: i + 1 for i, n in enumerate(names[:-1])}
        self.slots, self.seen = slots, []


@contextlib.contextmanager
def marking(names: Sequence[str], slots: torch.Tensor):
    """The block is one run of a program with spans ``names``: slot 0 marked
    on entry, ``mark(names[i])`` marks slot i + 1 (other names are not this
    program's and mark nothing), the last slot on exit. Raises unless every
    inner boundary was marked once, in order (a program is branch-free, so
    its boundaries come in a fixed order)."""
    global _marks
    run, previous = _Marking(names, slots), _marks
    _marks = run
    span_mark(slots, 0)
    try:
        yield
        span_mark(slots, len(names))
    finally:
        _marks = previous
    if run.seen != list(names[:-1]):
        raise RuntimeError(f"spans: the program marked {run.seen}, expected {list(names[:-1])}")


def mark(name: str) -> None:
    """The end of span ``name`` (the start of the next) inside a marked
    program's function; nothing elsewhere, and nothing while spans are off."""
    if _marks is None:
        return
    i = _marks.index.get(name)
    if i is not None:
        _marks.seen.append(name)
        span_mark(_marks.slots, i)


def record_marks(names: Sequence[str], stamps) -> dict:
    """A marked program's slots, read back (ns), as its spans: added to the
    device totals and kept as :func:`last_marks`. Returns {name: ms}."""
    global _last
    t = [int(v) for v in stamps]
    _last = {}
    for name, a, b in zip(names, t, t[1:]):
        _add(_device, name, b - a)
        _last[name] = (b - a) / 1e6
    return _last


def last_marks() -> dict:
    """{span name: ms} of the last run :func:`record_marks` read."""
    return dict(_last)


def host_totals() -> dict:
    """{name: (calls, seconds)} of every host span since :func:`reset`."""
    return {k: (n, ns / 1e9) for k, (n, ns) in _host.items()}


def device_totals() -> dict:
    """{name: (runs, seconds)} of every device span recorded since :func:`reset`."""
    return {k: (n, ns / 1e9) for k, (n, ns) in _device.items()}


def reset() -> None:
    """Clear the totals (the switch stays as it is)."""
    global _last
    _host.clear()
    _device.clear()
    _last = {}


def summary(counters: Optional[dict] = None) -> str:
    """The host spans' table (calls, total s, mean ms), the device spans'
    table where any were recorded, and ``counters``."""
    def table(title, totals):
        lines = [f"{title:<24}{'calls':>8}{'total_s':>10}{'mean_ms':>10}"]
        for name in sorted(totals, key=lambda k: -totals[k][1]):
            n, s = totals[name]
            lines.append(f"{name:<24}{n:>8}{s:>10.3f}{s / max(n, 1) * 1e3:>10.2f}")
        return lines

    lines = table("span", host_totals())
    if _device:
        lines += table("device span", device_totals())
    if counters:
        lines.append(f"{'counter':<24}{'value':>8}")
        lines += [f"{k:<24}{v:>8}" for k, v in counters.items()]
    return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Wrap a block in a ``torch.profiler`` trace of CPU and (where there is
    a card) CUDA activity when ``log_dir`` is set; the trace is written to
    ``log_dir/trace.json`` in the Chrome trace format (with spans on, the
    ``vo.*`` ranges and the marker kernels are in it)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def format_step(frame_idx: int, out) -> str:
    """One-line per-frame banner."""
    stage_names = {0: "BLANK", 1: "INIT", 2: "TRACK"}
    return (
        f"frame {frame_idx:4d} [{stage_names.get(int(out.stage), '?'):5s}] "
        f"kpts={int(out.n_keypoints):4d} matches={int(out.n_matches):4d} "
        f"inliers={int(out.n_inliers):4d} map={int(out.n_map_points):4d} "
        f"{'KF' if bool(out.is_keyframe) else '  '} "
        f"{'ok' if bool(out.tracking_ok) else 'TRACK-FAIL'}"
    )
