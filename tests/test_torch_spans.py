"""The port's spans and counters on the CPU (``utils/logging.py``).

With spans on, the init and tracking programs of ``VOEngine`` and the
general batched body mark their stage boundaries (``mvo::span_mark``: on the
CPU a ``perf_counter_ns`` write) in the order ``models/vo.py`` declares
(``INIT_SPANS``, ``TRACK_SPANS``, ``GENERAL_SPANS``), once per step under
the general body's vmap; ``add_frame`` and the batched step record their
host spans. With spans off nothing is marked or recorded. Either way the
poses, stages and keys are the same, bit for bit, and the engine's counters
equal the counts recomputed from its outputs. A capture's ``warmup_s`` and
``capture_s`` are its two capture spans (the capture itself runs here on a
stand-in for the CUDA calls).

The sequence is ``test_torch_fused.py``'s half-resolution one (240x320, 256
keypoints), 14 frames: it initializes at frame 6 and takes keyframes.
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import capture as TC
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.utils import logging as lg
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

H, W = 240, 320
N = 14
INTRINSICS = dict(fx=307.5, fy=307.5, cx=160.0, cy=120.0)
CAM = Camera.create(**INTRINSICS)
SPANS_IDS = dict(argvalues=[False, True], ids=["spans_off", "spans_on"])
PROGRAM_SPANS = {TS.STAGE_BLANK: (), TS.STAGE_INITIALIZING: TV.INIT_SPANS,
                 TS.STAGE_TRACKING: TV.TRACK_SPANS}
ENGINE_SPANS = ("engine.copy", "engine.draws", "engine.launch", "engine.readback",
                "engine.finish")


def _cfg() -> VOConfig:
    cfg = VOConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=256, num_keypoints=2000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=64, pnp_n_hypotheses=64),
        map=dataclasses.replace(cfg.map, max_map_points=1024),
        init=dataclasses.replace(cfg.init, min_pixel_dist=25.0),
        dataset=dataclasses.replace(cfg.dataset, **INTRINSICS))


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_no_vmap_fallback():
    """One intra-op thread (beside other test workers a pool only contends);
    vmap's slow fallback off, so an op without a batch rule raises; spans
    off and the totals cleared after the file."""
    was, threads = torch._C._functorch._is_vmap_fallback_enabled(), torch.get_num_threads()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    torch.set_num_threads(1)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(was)
    torch.set_num_threads(threads)
    lg.spans(False)
    lg.reset()


@pytest.fixture(scope="module")
def frames():
    return tsyn.render_sequence_arrays(N, seed=0, height=H, width=W, translation_step=0.05,
                                       **INTRINSICS)[0]


@contextlib.contextmanager
def _counting_marks():
    """The marker calls made in the block, as [slot index]."""
    calls = []
    real = lg.span_mark

    def counting(slots, index):
        calls.append(index)
        real(slots, index)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lg, "span_mark", counting)
        yield calls


@pytest.fixture(scope="module")
def engine_runs(frames):
    """The engine over the frames with spans off and on: per frame the stage
    that ran it, its output, the state after it, its device spans, its host
    span totals and its marker calls; and the engine."""
    runs = {}
    for on in (False, True):
        rows = []
        with lg.spans(on):
            eng = TV.VOEngine(_cfg(), H, W, device="cpu")
            for f in frames:
                stage = eng._stage
                lg.reset()
                with _counting_marks() as calls:
                    out = eng.add_frame(f)
                rows.append(dict(stage=stage, out=out, state=eng.state, marks=lg.last_marks(),
                                 host=lg.host_totals(), calls=calls))
        runs[on] = (rows, eng)
    return runs


def _assert_equal(got, want, what=""):
    """Every tensor of two records equal, dtype and value."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _assert_equal(getattr(got, f), getattr(want, f), f"{what}.{f}")
    elif want is None:
        assert got is None, what
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), what


def test_engine_results_are_the_same_with_spans_on(engine_runs):
    """Every output and state field of every frame, the key too."""
    off, on = engine_runs[False][0], engine_runs[True][0]
    for i, (a, b) in enumerate(zip(off, on)):
        _assert_equal(b["out"], a["out"], f"frame {i}")
        _assert_equal(b["state"], a["state"], f"state after frame {i}")
    stages = [r["stage"] for r in on]
    assert stages[-1] == TS.STAGE_TRACKING and TS.STAGE_INITIALIZING in stages


@pytest.mark.parametrize("stage", [TS.STAGE_BLANK, TS.STAGE_INITIALIZING, TS.STAGE_TRACKING],
                         ids=["first", "init", "track"])
def test_each_program_marks_its_boundaries_in_order(stage, engine_runs):
    """A frame of a marked program writes its start, each boundary once in
    the declared order, and its end: one span per name, none negative; the
    first-frame program is not marked."""
    rows = [r for r in engine_runs[True][0] if r["stage"] == stage]
    names = PROGRAM_SPANS[stage]
    assert rows
    for r in rows:
        assert list(r["marks"]) == list(names)
        assert all(ms >= 0 for ms in r["marks"].values())
        assert r["calls"] == (list(range(len(names) + 1)) if names else [])
    prog = engine_runs[True][1].stages.programs[stage]
    assert prog.spans == names and (prog.slots is None) == (not names)


def test_spans_off_mark_and_record_nothing(engine_runs):
    """No marker call, no device or host span, no slot buffer."""
    rows, eng = engine_runs[False]
    assert all(r["calls"] == [] and r["marks"] == {} and r["host"] == {} for r in rows)
    assert all(p.slots is None for p in eng.stages.programs.values())


def test_host_spans_cover_each_add_frame(engine_runs):
    """With spans on, one of each engine span per frame."""
    for r in engine_runs[True][0]:
        assert {k: n for k, (n, _) in r["host"].items()} == dict.fromkeys(ENGINE_SPANS, 1)


@pytest.mark.parametrize("on", **SPANS_IDS)
def test_engine_counters_equal_counts_from_the_outputs(on, engine_runs):
    rows, eng = engine_runs[on]
    outs = [r["out"] for r in rows]
    stages = [r["stage"] for r in rows]
    frames = {name: stages.count(s) for s, name in TV._FRAMES.items()}
    rejected = [0] + [int(o.ba_rejected_total) for o in outs]
    cap = eng.cfg.map.track_candidates
    want = dict(
        frames,
        **{"inits.held": sum(s == TS.STAGE_INITIALIZING and int(o.stage) == TS.STAGE_TRACKING
                             for s, o in zip(stages, outs)),
           "keyframes": sum(bool(o.is_keyframe) for o in outs),
           "tracking.failures": sum(not bool(o.tracking_ok) for o in outs),
           "ba.rejections": sum(max(b - a, 0) for a, b in zip(rejected, rejected[1:])),
           "candidates.overflows": sum(int(o.n_candidates) > cap for o in outs)})
    assert eng.counters == want
    assert want["inits.held"] == 1 and want["keyframes"] > 2 and want["frames.track"] > 3


def test_a_resumed_tracking_state_counts_only_new_rejections(engine_runs, frames):
    """Setting a tracking state (as the CLI's ``--resume`` does) takes its
    BA rejections as the baseline, not the count the engine had."""
    rows, _ = engine_runs[False]
    eng = TV.VOEngine(_cfg(), H, W, device="cpu")
    eng.add_frame(frames[0])
    st = rows[-2]["state"]
    eng.state = st._replace(ba_rejected=st.ba_rejected + 7)
    out = eng.add_frame(frames[-1])
    assert int(out.ba_rejected_total) >= 7 and eng.counters["frames.track"] == 1
    assert eng.counters["ba.rejections"] == int(out.ba_rejected_total) - 7 - int(st.ba_rejected)


class _Marks(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.__name__.startswith("span_mark")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def general_runs(engine_runs, frames):
    """Two general steps of B = 3 streams in mixed stages (fresh, in init,
    tracking; their keys the engine's) with spans off and on: per step the
    states, outputs, device spans, host spans and marker ops."""
    rows = engine_runs[False][0]
    cfg = _cfg()
    start = TS.stack_states([TS.init_state(cfg, 5, "cpu"), rows[2]["state"], rows[9]["state"]])
    imgs = [np.stack([frames[0], frames[3], frames[10]]),
            np.stack([frames[1], frames[4], frames[11]])]
    runs = {}
    for on in (False, True):
        sts, steps = start, []
        with lg.spans(on):
            for im in imgs:
                lg.reset()
                with _Marks() as m:
                    sts, out = TV.step_general_batched(cfg, CAM, sts, im, height=H, width=W)
                steps.append(dict(state=sts, out=out, marks=lg.last_marks(),
                                  host=lg.host_totals(), ops=m.n))
        runs[on] = steps
    TV.release_batched()
    return runs


def test_general_step_results_are_the_same_with_spans_on(general_runs):
    for i, (a, b) in enumerate(zip(general_runs[False], general_runs[True])):
        _assert_equal(b["out"], a["out"], f"step {i}")
        _assert_equal(b["state"], a["state"], f"states after step {i}")
    stages = general_runs[True][0]["out"].stage.tolist()
    assert stages[0] == TS.STAGE_INITIALIZING and stages[2] == TS.STAGE_TRACKING


@pytest.mark.parametrize("on", **SPANS_IDS)
def test_general_body_marks_once_per_step_for_every_stream(on, general_runs):
    """Spans on: one marker op per boundary per step (not per stream) and the
    body's spans in order, the step's host spans once each; off: none."""
    for s in general_runs[on]:
        if on:
            assert s["ops"] == len(TV.GENERAL_SPANS) + 1
            assert list(s["marks"]) == list(TV.GENERAL_SPANS)
            assert {k: n for k, (n, _) in s["host"].items()} == dict.fromkeys(
                ("batch.draws", "batch.launch", "batch.readback", "batch.keys"), 1)
        else:
            assert s["ops"] == 0 and s["marks"] == {} and s["host"] == {}


@pytest.mark.parametrize("on", **SPANS_IDS)
def test_profiler_sees_vo_ranges_only_with_spans_on(on, frames):
    eng = TV.VOEngine(_cfg(), H, W, device="cpu")
    with lg.spans(on), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.add_frame(frames[0])
    names = {e.name for e in prof.events() if e.name.startswith("vo.")}
    assert names == ({f"vo.{n}" for n in ENGINE_SPANS} if on else set())


class _FakeCuda:
    """Stand-ins for the CUDA calls of ``CapturedStep._capture``: the warm-up
    and the "capture" run the function eagerly; the pool grows 1 MiB."""

    reserved = 0

    def __init__(self, mp):
        for name, value in dict(
                Stream=lambda: self, stream=lambda s: contextlib.nullcontext(),
                current_stream=lambda: self, synchronize=lambda: None,
                CUDAGraph=lambda: self, graph=self._graph,
                memory_reserved=lambda: self.reserved).items():
            mp.setattr(torch.cuda, name, value)

    def wait_stream(self, other):
        pass

    @contextlib.contextmanager
    def _graph(self, graph, capture_error_mode):
        yield
        self.reserved += 2**20


@pytest.mark.parametrize("on", **SPANS_IDS)
def test_capture_seconds_are_the_capture_spans(on, monkeypatch):
    _FakeCuda(monkeypatch)
    lg.reset()
    with lg.spans(on):
        prog = TC.CapturedStep(lambda s, x: (s, x * 2), spans=("double",))
        prog.load(torch.zeros(2), torch.ones(3))
        prog._capture()
    totals = lg.host_totals()
    assert totals["capture.warmup"] == (1, prog.warmup_s)
    assert totals["capture.graph"] == (1, prog.capture_s)
    assert prog.pool_bytes == 2**20 and prog.warmup_s > 0 and prog.capture_s > 0
    assert (prog.slots is not None) == on
    if on:   # the warm-up and the capture each wrote the start and the end
        assert prog.slots[1] >= prog.slots[0] > 0


def test_span_switch_and_totals():
    """``spans(on)`` as a context restores the previous setting; ``span`` is
    measured only while on, ``timed`` always; ``record_marks`` turns slots
    (ns) into spans (ms)."""
    lg.reset()
    assert not lg.spans_on()
    with lg.spans(True):
        assert lg.spans_on()
        with lg.spans(False):
            assert not lg.spans_on()
            with lg.span("off"), lg.timed("always") as t:
                pass
        assert lg.spans_on()
        with lg.span("on"):
            pass
    assert not lg.spans_on() and t.seconds >= 0
    assert set(lg.host_totals()) == {"always", "on"}
    assert lg.record_marks(("a", "b"), torch.tensor([10, 1_000_010, 4_000_010])) == \
        {"a": 1.0, "b": 3.0}
    assert lg.device_totals() == {"a": (1, 0.001), "b": (1, 0.003)}
    lg.reset()
    assert lg.host_totals() == {} and lg.last_marks() == {}


def test_a_program_that_skips_a_boundary_raises():
    with lg.spans(True):
        prog = TC.CapturedStep(lambda s: (s, lg.mark("b") or s), spans=("a", "b", "c"))
        with pytest.raises(RuntimeError, match="marked"):
            prog(torch.zeros(1))


def test_summary_keeps_its_table_format():
    """The CLI's summary: one row a span (calls, total s, mean ms; the form
    ``chip_smoke.py`` reads), then the device spans and the counters."""
    lg.reset()
    with lg.timed("vo_step"):
        pass
    lg.record_marks(("track.features",), [0, 2_000_000])
    text = lg.summary({"keyframes": 3})
    assert re.search(r"^vo_step +1 +[\d.]+ +[\d.]+$", text, re.M)
    assert re.search(r"^track.features +1 +0.002 +2.00$", text, re.M)
    assert re.search(r"^keyframes +3$", text, re.M)
    lg.reset()
