"""The readers of the port's spans and counters (``harness/spans.py``) on
synthetic trace records: each reads its value from the record's ``spans``,
and none reads anything where the run has no spans; and the arithmetic of
the profiled run (busy time per tracking frame, the device's idle time by
the innermost span) on synthetic events, with its guards against a profile
that lost records."""

import json

import pytest
from conftest import ROOT

from harness import spans, spec

NEW = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
       if m["name"].startswith(("span.", "engine.copy", "engine.draws", "engine.launch",
                                "engine.init_frames", "batch.draws"))]


def test_the_span_metrics_are_listed():
    assert len(NEW) == 18


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_its_value(name):
    value = 1.0 + NEW.index(name)
    trace = {"driver": "live", "spans": {n: 100.0 + i for i, n in enumerate(NEW)}}
    trace["spans"][name] = value
    assert spec.metric_reader(name)(trace) == value


@pytest.mark.parametrize("name", NEW)
def test_without_spans_each_reader_returns_none(name):
    """A run whose port has no spans (the record's ``spans`` empty), and a
    record of no traced run at all (nothing to measure from here)."""
    assert spec.metric_reader(name)({"driver": "live", "spans": {}}) is None
    trace = {"driver": "batch", "units": []}
    assert spec.metric_reader(name)(trace) is None and trace["spans"] == {}


def _ev(a, b, name):
    return (a, b, name)


# two units (frames): the first three markers around two kernels, a gap of 5
# between them; the second a kernel and a copy; host spans inside each
DEV = [_ev(100, 101, "span_mark_kernel"), _ev(101, 120, "kernel_a"),
       _ev(125, 140, "kernel_b"), _ev(140, 141, "span_mark_kernel"),
       _ev(141, 150, "kernel_c"), _ev(150, 151, "span_mark_kernel"),
       _ev(300, 330, "kernel_d"), _ev(340, 350, "Memcpy DtoH")]
CPU = [(90, 200, spans.UNIT), (90, 95, "vo.engine.copy"), (95, 160, "vo.engine.launch"),
       (160, 200, "vo.engine.readback"), (280, 400, spans.UNIT), (280, 335, "vo.engine.launch"),
       (335, 400, "vo.engine.readback")]


@pytest.mark.parametrize("programs, busy", [
    ([spans.TRACKING, spans.TRACKING], (20 + 26 + 30 + 10) / 2),
    ([spans.INITIALIZING, spans.TRACKING], 30 + 10),
    ([spans.TRACKING, spans.INITIALIZING], 20 + 26),
    ([spans.INITIALIZING, spans.INITIALIZING], None)])
def test_tracking_busy_per_frame(programs, busy):
    """Busy ns per tracking frame over each run of consecutive tracking
    frames, their ranges taken whole (90..200 and 280..400 here; in a run of
    both, the device's 200..280 too)."""
    got = spans.tracking_busy_ms(DEV, CPU, programs)
    assert got == (None if busy is None else pytest.approx(busy / 1e6))


def test_tracking_busy_counts_a_record_in_a_neighbours_range():
    """A kernel of the first frame that the profile puts after its range
    still counts once for the run of both."""
    dev = DEV + [(250, 260, "late_kernel")]
    assert spans.tracking_busy_ms(dev, CPU, [spans.TRACKING] * 2) == pytest.approx(
        (20 + 26 + 30 + 10 + 10) / 2 / 1e6)
    assert spans.busy_ns(DEV, CPU) == 20 + 26 + 30 + 10


class _Rec:
    """A profiler record as ``kineto_results.events()`` gives it."""

    def __init__(self, a, b, name, on_card):
        self.a, self.b, self.n, self.card = a, b, name, on_card

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def name(self):
        return self.n

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self.card else torch.autograd.DeviceType.CPU


def _records(spin=True, units=2):
    recs = [_Rec(a, b, n, True) for a, b, n in DEV]
    recs += [_Rec(a, b, n, False) for a, b, n in CPU if n != spans.UNIT]
    recs += [_Rec(a, b, n, False) for a, b, n in CPU if n == spans.UNIT][:units]
    recs += [_Rec(a, b, spans.UNIT, True) for a, b, n in CPU if n == spans.UNIT]
    if spin:
        recs += [_Rec(0, 50, "spin_kernel", True), _Rec(450, 500, "spin_kernel", True)]
    return recs


def test_events_leave_out_spin_kernels_and_annotations():
    dev, cpu = spans.events(_records(), 2)
    assert dev == sorted(DEV) and cpu == sorted(CPU)


@pytest.mark.parametrize("spin, units, why", [(False, 2, "no spin kernel"),
                                               (True, 1, "1 ranges recorded for 2")])
def test_events_refuse_a_profile_that_lost_records(spin, units, why):
    with pytest.raises(RuntimeError, match=why):
        spans.events(_records(spin, units), 2)


def test_idle_split_by_innermost_span():
    """The slice runs 90..400: idle 90..100 (copy 5, launch 5), 120..125
    (launch), 151..300 (launch 9, readback 40, outside the frames 80, launch
    20), 330..340 (5 launch, 5 readback), 350..400 (readback)."""
    idle = spans.idle_by_span(DEV, CPU, "outside add_frame")
    assert idle == {"engine.copy": 5, "engine.launch": 5 + 5 + 9 + 20 + 5,
                    "engine.readback": 40 + 5 + 50, "outside add_frame": 80}
    assert sum(idle.values()) + spans.busy_ns(DEV, CPU) == 400 - 90


def test_idle_inside_a_unit_but_no_span():
    cpu = [(0, 100, spans.UNIT), (10, 20, "vo.batch.draws")]
    dev = [(20, 90, "kernel")]
    assert spans.idle_by_span(dev, cpu, "outside the step") == {
        "unit, outside vo.* spans": 10 + 10, "batch.draws": 10}
