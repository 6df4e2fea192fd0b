"""The mesh route through the stage programs (``VOEngine(mesh=...)`` and
``run_sequence(mesh=...)``: ``vo.StagePrograms`` with the sharded BA in the
tracking program) against the eager ``step(mesh=...)``, in two gloo
processes on the CPU (``tests/torch_dist_worker.py``, job ``programs``).

On the CPU a stage program calls its function eagerly on its buffers, and
under gloo the tracking program is never a graph (gloo's collectives cannot
be captured): what this holds is that the programs compute what the eager
step computes. The tracking program computes the sharded BA on every
tracking frame and applies it by a select, as ``step(mesh=...)`` does, so
every decision is equal, every pose within 1e-6, the collectives each frame
records equal the eager run's by primitive and bytes, and
``ba_update_state_dist`` runs once per tracking frame. Every rank picks its
next program from its own readback: the ranks' poses, stages and records
are bitwise equal.

The sequence is ``tests/test_torch_fused.py``'s half-resolution scene
(240x320, 256 keypoints, 1,024 map slots), 14 frames: initialized at frame
6, BA on from frame 7; landmarks fixed and joint.
"""

import dataclasses
import json

import numpy as np
import pytest

from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig
from torch_dist_worker import launch

H, W = 240, 320
N_FRAMES = 14
INTRINSICS = dict(fx=307.5, fy=307.5, cx=160.0, cy=120.0)
MODES = ("fixed", "joint")
POSE_TOL = 1e-6
DECISIONS = ("stage", "is_keyframe", "tracking_ok", "n_matches", "n_inliers", "n_map_points")


def _cfg(mode):
    cfg = VOConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=256, num_keypoints=2000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=64, pnp_n_hypotheses=64),
        map=dataclasses.replace(cfg.map, max_map_points=1024),
        init=dataclasses.replace(cfg.init, min_pixel_dist=25.0),
        dataset=dataclasses.replace(cfg.dataset, **INTRINSICS),
        ba=dataclasses.replace(cfg.ba, fix_map_points=mode == "fixed"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    frames = tsyn.render_sequence_arrays(N_FRAMES, seed=0, height=H, width=W,
                                         translation_step=0.05, **INTRINSICS)[0]
    work = tmp_path_factory.mktemp("programs")
    np.savez(work / "inputs.npz", frames=np.asarray(frames, np.float32),
             spec=json.dumps({"configs": {m: dataclasses.asdict(_cfg(m)) for m in MODES},
                              "run_sequence": "fixed"}))
    return launch("programs", 2, str(work), timeout=600)


def _tracking_frames(r, mode):
    """Frames that entered in tracking (the stage before each frame)."""
    stages = r[f"{mode}_eager_stage"]
    return np.concatenate([[False], stages[:-1] == TS.STAGE_TRACKING])


@pytest.mark.parametrize("mode", MODES)
def test_programs_equal_the_eager_mesh_step(ranks, mode):
    r = ranks[0]
    for f in DECISIONS:
        np.testing.assert_array_equal(r[f"{mode}_engine_{f}"], r[f"{mode}_eager_{f}"], f)
    np.testing.assert_allclose(r[f"{mode}_engine_T_w_c"], r[f"{mode}_eager_T_w_c"],
                               atol=POSE_TOL, rtol=0)
    tracking = _tracking_frames(r, mode)
    assert r[f"{mode}_eager_stage"][-1] == TS.STAGE_TRACKING and tracking.sum() >= 5
    assert int(r[f"{mode}_engine_ba_calls"]) == int(tracking.sum())
    assert int(r[f"{mode}_eager_ba_calls"]) == int(tracking.sum())
    # on the CPU nothing is a graph; under gloo the tracking program never is
    assert r[f"{mode}_captured"].tolist() == [] and not bool(r[f"{mode}_tracking_graph"])


@pytest.mark.parametrize("mode", MODES)
def test_programs_record_the_eager_collectives(ranks, mode):
    """Per frame, the same collectives (primitive and result bytes) in the
    same order as the eager step; a tracking frame's are the tracking
    program's per call, and no other frame calls one."""
    r = ranks[0]
    np.testing.assert_array_equal(r[f"{mode}_engine_rec"], r[f"{mode}_eager_rec"])
    rec, tracking = r[f"{mode}_engine_rec"], _tracking_frames(r, mode)
    per_call = r[f"{mode}_per_call_rec"]
    assert len(per_call) > 0
    for i in range(N_FRAMES):
        mine = rec[rec[:, 0] == i, 1:]
        np.testing.assert_array_equal(mine, per_call if tracking[i] else per_call[:0])
    if mode == "joint":   # the landmark blocks move: scattered and gathered
        assert {0, 1, 2} <= set(per_call[:, 0].tolist())


@pytest.mark.parametrize("mode", MODES)
def test_ranks_agree_bitwise(ranks, mode):
    for key in ("engine_T_w_c", "engine_stage", "engine_is_keyframe", "engine_rec"):
        np.testing.assert_array_equal(ranks[1][f"{mode}_{key}"], ranks[0][f"{mode}_{key}"])


def test_run_sequence_through_the_programs(ranks):
    """``run_sequence(mesh=...)`` gives the engine's poses and stages, and
    records one tracking program's collectives per tracking frame."""
    r = ranks[0]
    np.testing.assert_array_equal(r["fixed_seq_T_w_c"], r["fixed_engine_T_w_c"])
    np.testing.assert_array_equal(r["fixed_seq_stage"], r["fixed_engine_stage"])
    assert int(r["fixed_seq_n_rec"]) == len(r["fixed_engine_rec"])


class _Mesh:
    def __init__(self, backend):
        self.backend, self.size, self.record = backend, 2, []


@pytest.mark.parametrize("backend,captured", [(None, (0, 1, 2)), ("nccl", (0, 1, 2)),
                                              ("gloo", (0, 1))])
def test_captured_stages_on_a_card(backend, captured):
    """Which stage programs are graphs on a card (nothing is captured by
    building them): every stage, the five-point init included, but the
    tracking program of a gloo mesh; none on the CPU."""
    cfg = _cfg("fixed").replace(ransac=dataclasses.replace(_cfg("fixed").ransac,
                                                           essential_minimal="5pt"))
    cam = Camera.create(**INTRINSICS)
    mesh = None if backend is None else _Mesh(backend)
    assert TV.StagePrograms(cfg, cam, H, W, "cuda", mesh=mesh).captured_stages == captured
    assert TV.StagePrograms(cfg, cam, H, W, "cpu", mesh=mesh).captured_stages == ()
