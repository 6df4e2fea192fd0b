"""The port's one-program-per-frame route on the CPU: the stage programs of
``vo.StagePrograms`` held as ``models/capture.py::CapturedStep``s (on a card
each is a CUDA graph; on the CPU the same object calls the same function
eagerly on the same buffers), ``VOEngine(fused=True)`` and ``run_sequence``
through them, and the batched steps through their captured bodies.

The captured route makes the same draws from the same keys as the eager
host-branch ``step``, and its selects pick exactly what ``step``'s branches
compute, so on the CPU every output field and every state field is equal
(``torch.equal``) over a 30-frame run with BA off and on. The tracking
program computes BA and the keyframe update on every tracking frame (applied
where ``tracking_ok`` / ``is_keyframe`` hold), so ``ba_update_state`` runs
once per tracking frame. Each stage program reads nothing back (no
``_local_scalar_dense``, ``nonzero``, ``lift_fresh`` or copy to another
device): on a card that is what lets it be captured.

The sequence is the benchmark scene at half resolution (240x320, the same
field of view: focal 307.5 px), with the small configuration of
``test_torch_vo.py`` cut further (256 keypoints, 64 hypotheses, the init's
pixel gate halved with the resolution): a frame costs ~0.45 s on one CPU
thread, and it still initializes at frame 6 and takes keyframes.
"""

import dataclasses
from collections import Counter
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep
from monocular_visual_odometry_tpu_torch.ops import lie as tlie
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

H, W = 240, 320
N = 30
N_SCAN = 14   # run_sequence's frames (tests/test_fused_step.py's sequence length)
INTRINSICS = dict(fx=307.5, fy=307.5, cx=160.0, cy=120.0)


def _cfg(ba: bool, minimal: str = "8pt") -> VOConfig:
    cfg = VOConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=256, num_keypoints=2000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=64, pnp_n_hypotheses=64,
                                   essential_minimal=minimal),
        map=dataclasses.replace(cfg.map, max_map_points=1024),
        init=dataclasses.replace(cfg.init, min_pixel_dist=25.0),
        dataset=dataclasses.replace(cfg.dataset, **INTRINSICS),
        ba=dataclasses.replace(cfg.ba, enabled=ba))


CAM = Camera.create(**INTRINSICS)
BA_IDS = dict(argvalues=[False, True], ids=["ba_off", "ba_on"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops are small, and beside other test workers
    a pool of threads per process only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    return tsyn.render_sequence_arrays(N, seed=0, height=H, width=W, translation_step=0.05,
                                       **INTRINSICS)[0]


def _img(f):
    return torch.from_numpy(np.asarray(f)).float()


@pytest.fixture(scope="module")
def eager_runs(frames):
    """``step`` over the frames from a fresh state, BA off and on: per frame
    (state before it, output)."""
    runs = {}
    for ba in (False, True):
        cfg, st, run = _cfg(ba), TS.init_state(_cfg(ba), 0, "cpu"), []
        for f in frames:
            new, out = TV.step(cfg, CAM, st, _img(f), height=H, width=W)
            run.append((st, out))
            st = new
        runs[ba] = (run, st)
    return runs


@pytest.fixture(scope="module")
def engine_runs(frames):
    """``VOEngine(fused=True, device="cpu")`` over the frames, BA off and on:
    (outputs, states after each frame, BA calls per frame, launches, engine)."""
    runs = {}
    for ba in (False, True):
        eng = TV.VOEngine(_cfg(ba), H, W, device="cpu")
        outs, states, ba_calls = [], [], []
        launches = TH.hamming_nn_top2.launches
        for f in frames:
            calls = TB.ba_update_state.calls
            outs.append(eng.add_frame(f))
            ba_calls.append(TB.ba_update_state.calls - calls)
            states.append(eng.state)
        runs[ba] = (outs, states, ba_calls, TH.hamming_nn_top2.launches - launches, eng)
    return runs


def _assert_equal(got, want, what=""):
    """Every tensor of two records equal, dtype and value."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _assert_equal(getattr(got, f), getattr(want, f), f"{what}.{f}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), what


@pytest.mark.parametrize("ba", **BA_IDS)
def test_engine_equals_step(ba, eager_runs, engine_runs):
    """Every output and state field of every frame equal, the key too; BA
    computed on every tracking frame, applied where tracking held."""
    run, _ = eager_runs[ba]
    outs, states, ba_calls, launches, eng = engine_runs[ba]
    for i, ((_, want), got) in enumerate(zip(run, outs)):
        _assert_equal(got, want, f"frame {i}")
    after = [st for st, _ in run[1:]] + [eager_runs[ba][1]]
    for i, (got_st, want_st) in enumerate(zip(states, after)):
        _assert_equal(got_st, want_st, f"state after frame {i}")
    stages = [int(st.stage) for st, _ in run]
    assert stages[-1] == TS.STAGE_TRACKING and sum(bool(o.is_keyframe) for o in outs) > 2
    tracking = [s == TS.STAGE_TRACKING for s in stages]
    assert ba_calls == [int(ba and t) for t in tracking]
    applied = [bool(o.tracking_ok) for o, t in zip(outs, tracking) if t]
    assert len(applied) > 10 and all(applied)
    assert launches == 0 and eng.captured_stages == ()
    prog = eng.stages.programs[TS.STAGE_TRACKING]
    assert prog.calls == sum(tracking) and prog.replays == 0
    assert prog.per_call == {"hamming_nn_top2": 0, "ba_lm_pose": 0, "ba_update_state": int(ba),
                             "ba_update_state_dist": 0}


def test_run_sequence_equals_engine(frames, engine_runs):
    """``run_sequence`` over the first N_SCAN frames (the same stage
    programs, a preallocated [N] output) gives the engine's outputs and its
    state after them."""
    outs, states, _, _, _ = engine_runs[True]
    final, got = TV.run_sequence(_cfg(True), CAM, TS.init_state(_cfg(True), 0, "cpu"),
                                 frames[:N_SCAN], height=H, width=W)
    assert got.T_w_c.shape == (N_SCAN, 4, 4)
    assert int(got.stage[-1]) == TS.STAGE_TRACKING and bool(got.is_keyframe[7:].any())
    for i, want in enumerate(outs[:N_SCAN]):
        _assert_equal(TS.StepOutput(*(t[i] for t in got)), want, f"frame {i}")
    _assert_equal(final, states[N_SCAN - 1])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.__name__] += 1
        # forward-mode AD (the init's Sampson LM) casts its tangents with a
        # device argument, the tensor's own: only a move counts
        dev = (kwargs or {}).get("device")
        if func.__name__.startswith("_to_copy") and dev is not None and dev != args[0].device:
            self.ops["_to_copy to another device"] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def eager_5pt(frames):
    """``step`` under the five-point solver on the card's route (``lie.card_route``
    forced: both ``eigh`` calls Jacobi), from a fresh state through its first
    successful init attempt: per frame (state before it, output)."""
    cfg, run = _cfg(True, "5pt"), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlie, "card_route", lambda t: True)
        st = TS.init_state(cfg, 0, "cpu")
        for f in frames:
            new, out = TV.step(cfg, CAM, st, _img(f), height=H, width=W)
            run.append((st, out))
            st = new
            if int(out.stage) == TS.STAGE_TRACKING:
                break
    assert int(run[-1][1].stage) == TS.STAGE_TRACKING and len(run) > 2
    return run


@pytest.mark.parametrize("stage,frame,minimal", [
    (TS.STAGE_BLANK, 0, "8pt"), (TS.STAGE_INITIALIZING, 1, "8pt"),
    (TS.STAGE_INITIALIZING, 6, "8pt"), (TS.STAGE_TRACKING, 10, "8pt"),
    (TS.STAGE_INITIALIZING, 1, "5pt"), (TS.STAGE_INITIALIZING, -1, "5pt")],
    ids=["first", "init_failing", "init_succeeding", "tracking", "init_failing_5pt",
         "init_succeeding_5pt"])
def test_stage_program_reads_nothing_back(stage, frame, minimal, frames, eager_runs, request,
                                          monkeypatch):
    """Each stage program, as captured, makes no readback, no tensor built
    from host data, no copy between devices and no LAPACK ``eigh``; its
    output's stage is its new state's (the readback's stage picks the next
    program). The five-point init runs on the card's route (``lie.card_route``
    forced), against ``step`` on the same route."""
    if minimal == "5pt":
        monkeypatch.setattr(tlie, "card_route", lambda t: True)
        cfg, run = _cfg(True, "5pt"), request.getfixturevalue("eager_5pt")
        frame %= len(run)
    else:
        cfg, (run, _) = _cfg(True), eager_runs[True]
    st = run[frame][0]
    assert int(st.stage) == stage
    fn = TV.StagePrograms(cfg, CAM, H, W, "cpu")._fn(stage)
    draws = TV._stage_draws(cfg, stage, int(st.rng), "cpu")
    img = _img(frames[frame])
    with _Ops() as mode:
        new, out = fn(st._replace(rng=None), img, draws)
    found = {k: mode.ops[k] for k in ("_local_scalar_dense.default", "nonzero.default",
                                      "lift_fresh.default", "_to_copy to another device",
                                      "_linalg_eigh.default")}
    assert sum(found.values()) == 0, found
    assert torch.equal(out.stage, new.stage)
    _assert_equal(out, run[frame][1])


@pytest.mark.parametrize("kind", ["tracking", "general"])
def test_batched_step_through_captured_step_equals_eager_body(kind, frames, eager_runs):
    """B=2, two steps in a row (the second takes the program's own state
    buffers back): every field of the states, outputs and next keys equal
    to the eager vmapped body's, one BA call per step."""
    cfg = _cfg(True)
    run, _ = eager_runs[True]
    at = (10, 14) if kind == "tracking" else (1, 12)   # general: initializing and tracking
    sts = TS.stack_states([run[i][0] for i in at])
    body, draw, step_fn = ((TV.tracking_batched_body, TV.draw_batched, TV.step_tracking_batched)
                           if kind == "tracking" else
                           (TV.general_batched_body, TV.draw_general, TV.step_general_batched))
    want_st = sts
    for k in range(2):
        imgs = torch.stack([_img(frames[i + k]) for i in at])
        calls = TB.ba_update_state.calls
        sts, got = step_fn(cfg, CAM, sts, imgs, height=H, width=W)
        assert TB.ba_update_state.calls == calls + 1
        new, want = body(cfg, CAM, want_st, imgs, draw(cfg, want_st.rng, "cpu"), height=H,
                         width=W)
        want_st = new._replace(rng=TV._next_keys(want_st.rng, want_st.stage.tolist(),
                                                 want.is_keyframe.int().tolist()))
        _assert_equal(got, want, f"step {k}")
        _assert_equal(sts, want_st, f"step {k}")
    prog = TV._batched_program(kind, cfg, CAM, 2, H, W, torch.device("cpu"))
    assert prog.per_call == {"hamming_nn_top2": 0, "ba_lm_pose": 0, "ba_update_state": 1,
                             "ba_update_state_dist": 0} and prog.replays == 0


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_captured_step_buffers_aliasing_and_counters():
    """A new state field that is another field's input buffer, and an output
    that is an input buffer, are cloned before the copy-back: the returned
    values are the step's; the caller's state is never written; the
    program's own buffers handed back are not copied; the counters move by
    what one call adds; a changed input structure or shape raises."""
    def fn(st, x):
        TB.ba_update_state.calls += 1
        return _Pair(a=st.b, b=st.a + x), st.a

    prog = CapturedStep(fn)
    s0 = _Pair(torch.tensor([1.0]), torch.tensor([2.0]))
    calls = TB.ba_update_state.calls
    new, out = prog(s0, torch.tensor([10.0]))
    assert new.a.tolist() == [2.0] and new.b.tolist() == [11.0] and out.tolist() == [1.0]
    assert s0.a.tolist() == [1.0] and s0.b.tolist() == [2.0]
    new2, out2 = prog(new, torch.tensor([10.0]))
    assert new2.a.tolist() == [11.0] and new2.b.tolist() == [12.0] and out2.tolist() == [2.0]
    assert out.tolist() == [1.0]  # an eager call's outputs are its own tensors
    assert new2.a is new.a        # the state buffers, written in place
    assert TB.ba_update_state.calls == calls + 2
    assert prog.per_call == {"hamming_nn_top2": 0, "ba_lm_pose": 0, "ba_update_state": 1,
                             "ba_update_state_dist": 0}
    assert (prog.calls, prog.replays) == (2, 0)
    with pytest.raises(ValueError, match="shape"):
        prog(new2, torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="structure"):
        prog(new2, torch.tensor([1.0]), torch.tensor([1.0]))
