"""The end-to-end paths the scene generators and camera tools open, on the
port (CPU, short runs; ``chip_smoke.py`` phase 4g runs them at full length
on the card):

- planar init under both model-selection rules, with the gates of the JAX
  package's ``tests/test_planar_sequence.py`` (40 frames, 512 keypoints):
  tracking at the end with finite poses, 0 < init frame <= 15, H chosen at
  init under the reference (ORB-SLAM score) rule, ATE < 8% of the path,
  ``tracking_ok`` on at least N - init - 2 frames;
- the robustness matrix's adaptive FAST threshold against the port's
  ``detect_and_describe`` (``tests/test_robustness.py``), and one short run
  of perturbed frames (low contrast 0.25) that must reach tracking;
- calibrate -> distort -> undistort -> track (``tests/test_tools_chain.py``)
  over 20 frames, which must reach tracking;
- bench's reference-parity configuration cfg6 (1500 keypoints, the
  reference selection rule, the keyframe-time E-RANSAC filter, the
  last-W-frames BA window) over 30 benchmark frames beside the JAX
  package's run of the same frames, held to the band ``test_torch_vo.py``
  holds its BA-on run to. It is the first test of the single-stream step's
  keyframe E-RANSAC branch.

The two packages draw different RANSAC samples, so nothing end to end is
compared bit for bit: the runs are held to the bands and budgets above.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from chip_smoke import _chessboard_views

from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models.vo import VOEngine as JEngine
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.data import tools as ttools
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models.vo import VOEngine, run_sequence
from monocular_visual_odometry_tpu_torch.ops import features as TF
from monocular_visual_odometry_tpu_torch.ops import twoview
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.utils import metrics
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

K3 = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1.0]])
N_PLANAR = 40
N_SHORT = 20     # the perturbed run and the chain: enough to initialise and track
N_CFG6 = 30
DIST_GT = np.array([-0.28, 0.09])  # the chain's true lens (test_tools_chain.py)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine's ops are small, and beside other
    test workers a pool of threads per process only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stages_ok(final_stage, est):
    assert int(final_stage) == TS.STAGE_TRACKING
    assert np.isfinite(est).all()


# ---- planar init under both selection rules --------------------------------


@pytest.fixture(scope="module")
def planar_sequence():
    scene, gt = tsyn.planar_scene(), tsyn.make_planar_trajectory(N_PLANAR)
    return np.stack([tsyn.render_frame(gt[i], scene, K3) for i in range(N_PLANAR)]), gt


def planar_cfg(use_reference_selection: bool) -> VOConfig:
    """``tests/test_planar_sequence.py``'s 512-keypoint configuration."""
    cfg = VOConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        init=dataclasses.replace(cfg.init, use_reference_selection=use_reference_selection))


@pytest.mark.parametrize("use_reference_selection", [True, False],
                         ids=["reference-rule", "tournament-rule"])
def test_planar_init_end_to_end(planar_sequence, use_reference_selection):
    frames, gt = planar_sequence
    cfg = planar_cfg(use_reference_selection)
    final, outs = run_sequence(cfg, Camera.create(615.0, 615.0, 320.0, 240.0),
                               TS.init_state(cfg, 0, "cpu"), frames, height=480, width=640)
    est, stages = outs.T_w_c.numpy(), outs.stage.numpy()
    _stages_ok(final.stage, est)
    init_frame = int(np.argmax(stages == TS.STAGE_TRACKING))
    assert 0 < init_frame <= 15, init_frame
    if use_reference_selection:
        assert bool(outs.used_homography[init_frame]), \
            "the reference selection rule picked E on a dominant plane"
    length = metrics.trajectory_length(gt)
    assert metrics.ate_rmse(est, gt) < 0.08 * length
    assert int(outs.tracking_ok.sum()) >= N_PLANAR - init_frame - 2


# ---- the robustness matrix: adaptive threshold, one perturbed run ----------


def test_adaptive_threshold_rescues_low_contrast_detection():
    """``tests/test_robustness.py``'s test on the port's frontend: a 4x
    contrast squeeze keeps >= 90% of the keypoints, and on a full-contrast
    frame the adaptive threshold is the fixed one (scale capped at 1)."""
    gt = tsyn.make_trajectory(1, seed=0, translation_step=0.05)
    img = tsyn.render_frame(gt[0], tsyn.default_scene(0), K3).astype(np.float32)
    full = TF.detect_and_describe(torch.from_numpy(img))
    squeezed = img.mean() + 0.25 * (img - img.mean())
    low = TF.detect_and_describe(torch.from_numpy(squeezed))
    n_full, n_low = int(full.valid.sum()), int(low.valid.sum())
    assert n_full >= 1000, n_full
    assert n_low >= 0.9 * n_full, (n_low, n_full)
    t = torch.from_numpy(img)
    scale = float(torch.clamp(torch.std(t, correction=0) / 60.0, 0.15, 1.0))
    assert scale == 1.0, scale
    atlas = TF.build_atlas(t, 4, 1.2, 16)
    adaptive = 20.0 * torch.clamp(torch.std(t, correction=0) / 60.0, 0.15, 1.0)
    assert torch.equal(TF.fast_corner_mask(atlas, adaptive), TF.fast_corner_mask(atlas, 20.0))


def test_short_perturbed_run_reaches_tracking():
    frames, gt = tsyn.render_sequence_arrays(N_SHORT, seed=0, translation_step=0.05)
    frames = tsyn.perturb_frames(frames, "low_contrast", 0.25)
    eng = VOEngine(VOConfig(), 480, 640, device="cpu")
    outs = [eng.add_frame(f) for f in frames]
    _stages_ok(outs[-1].stage, np.stack([o.T_w_c.numpy() for o in outs]))
    # the adaptive threshold keeps the squeezed frames' detector saturated
    assert min(int(o.n_keypoints) for o in outs) >= 900


# ---- calibrate -> distort -> undistort -> track -----------------------------


def test_chessboard_views_equal_the_chain_tests():
    """``chip_smoke.py``'s views (the port's Euler rotation) are those of
    ``tests/test_tools_chain.py`` (scipy's)."""
    import test_tools_chain

    for got, want in zip(_chessboard_views(K3, DIST_GT),
                         test_tools_chain._chessboard_views(K3, DIST_GT)):
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_short_calibrate_undistort_track_chain():
    K_cal, dist_cal, rms = ttools.calibrate_camera(*_chessboard_views(K3, DIST_GT), (640, 480))
    assert rms < 0.1 and abs(K_cal[0, 0] - K3[0, 0]) < 3.0, (rms, K_cal)
    gt = tsyn.make_trajectory(N_SHORT, seed=0, translation_step=0.05)
    scene = tsyn.default_scene(0)
    raw = [ttools.distort_image(tsyn.render_frame(gt[i], scene, K3).astype(np.float64), K3,
                                DIST_GT) for i in range(N_SHORT)]
    frames = np.stack([ttools.undistort_image(f, K_cal, dist_cal) for f in raw]).astype(np.float32)
    cfg = VOConfig()
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, fx=float(K_cal[0, 0]), fy=float(K_cal[1, 1]),
        cx=float(K_cal[0, 2]), cy=float(K_cal[1, 2])))
    eng = VOEngine(cfg, 480, 640, device="cpu")
    assert eng.cam.fx == float(np.float32(K_cal[0, 0]))
    outs = [eng.add_frame(f) for f in frames]
    _stages_ok(outs[-1].stage, np.stack([o.T_w_c.numpy() for o in outs]))


# ---- bench cfg6, the reference-parity configuration -------------------------


def cfg6(cfg):
    """``bench.py``'s cfg6 on a config of either package."""
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=1500),
        init=dataclasses.replace(cfg.init, use_reference_selection=True),
        ransac=dataclasses.replace(cfg.ransac, keyframe_use_ransac_filter=True),
        ba=dataclasses.replace(cfg.ba, keyframe_window=False))


def test_cfg6_tracks_beside_jax(monkeypatch):
    frames, gt = tsyn.render_sequence_arrays(N_CFG6, seed=0, translation_step=0.04)
    jcfg = cfg6(JConfig())
    tcfg = convert.config_to_torch(dataclasses.asdict(jcfg))
    assert tcfg == cfg6(VOConfig())
    jeng = JEngine(jcfg, 480, 640)
    j_outs = [jax.device_get(jeng.add_frame(f.astype(np.float32))) for f in frames]

    filter_calls = []
    epipolar = twoview.find_inlier_matches_by_epipolar
    monkeypatch.setattr(twoview, "find_inlier_matches_by_epipolar",
                        lambda *a, **k: filter_calls.append(1) or epipolar(*a, **k))
    eng = VOEngine(tcfg, 480, 640, device="cpu")
    ba_calls = TB.ba_update_state.calls
    outs = [eng.add_frame(f) for f in frames]
    ba_calls = TB.ba_update_state.calls - ba_calls

    assert int(j_outs[-1].stage) == JS.STAGE_TRACKING
    _stages_ok(outs[-1].stage, np.stack([o.T_w_c.numpy() for o in outs]))
    tracked = [o for prev, o in zip(outs, outs[1:]) if int(prev.stage) == TS.STAGE_TRACKING]
    assert sum(not bool(o.tracking_ok) for o in tracked) <= 2
    # the engine's tracking program computes the keyframe update (with its
    # E-RANSAC filter) and BA on every tracking frame and applies them where
    # is_keyframe / tracking_ok hold
    assert len(filter_calls) == len(tracked) and sum(bool(o.is_keyframe) for o in tracked) > 0
    assert ba_calls == len(tracked) and sum(bool(o.tracking_ok) for o in tracked) > 0
    ate = lambda os_: metrics.ate_rmse(np.stack([np.asarray(o.T_w_c) for o in os_]), gt)
    ate_t, ate_j = ate(outs), ate(j_outs)
    assert ate_t < 0.10, f"port ATE {ate_t:.4f}"
    assert abs(ate_t - ate_j) <= max(0.02, 0.5 * ate_j), (ate_t, ate_j)
    first = lambda os_, s: next(i for i, o in enumerate(os_) if int(o.stage) == s)
    assert abs(first(outs, TS.STAGE_TRACKING) - first(j_outs, JS.STAGE_TRACKING)) <= 2
