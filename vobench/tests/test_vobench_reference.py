"""The plain reference: it loads nothing of the port or of JAX, agrees with
the port within the cells' limits, and reads above them where the
comparison must fail: one precision lower, keypoints moved; the pose, the
two-view and the match references on scenes whose answer is known."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from harness import check, scene
from reference import match, orb, pose, twoview

CAM = dict(fx=615.0, fy=615.0, cx=320.0, cy=240.0)
LIMITS = json.loads((BENCH / "limits" / "vo_default.live.json").read_text())
VO = json.loads((BENCH / "configs" / "vo_default.json").read_text())["vo_config"]


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r})
import numpy as np, torch
from reference import ate, match, orb, pose, twoview
img = torch.from_numpy((np.random.default_rng(0).random((120, 160)) * 255).astype(np.uint8))
orb.harris_at(img, np.float32([[40, 40]]), np.int64([1]),
              dict(n_levels=2, scale_factor=1.2, grid_size=16, harris_k=0.04))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "monocular_visual_odometry_tpu",
                         "monocular_visual_odometry_tpu_torch", "harness"}


@pytest.fixture(scope="module")
def frames():
    poses = scene.make_trajectory(150, 0.04)
    planes = scene.room(3, lambda d: scene.texture_torch(d, "cpu"))
    return scene.render_torch(poses[:40], planes, scene.intrinsics(CAM), 480, 640, "cpu")


def _port_features(img):
    from monocular_visual_odometry_tpu_torch.ops.features import features_from_config
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    f = features_from_config(img.to(torch.float32), VOConfig().orb)
    v = f.valid.numpy()
    return dict(frame=img.numpy(), kpts=f.kpts.numpy()[v], levels=f.levels.numpy()[v],
                scores=f.scores.numpy()[v])


def test_harris_reference_agrees_with_the_port_within_the_limit(frames):
    items = [_port_features(frames[i]) for i in (0, 30)]
    assert check.score_gap(items, VO["orb"]) <= LIMITS["score_gap"]["limit"]


def test_a_lower_precision_reference_reads_above_the_limit(frames):
    """The CPU has no TF32: bfloat16 stands in for the control here; the
    card's test below runs the control itself."""
    items = []
    for i in (0, 30):
        it = _port_features(frames[i])
        items.append(dict(it, scores=orb.harris_at(frames[i], it["kpts"], it["levels"],
                                                   VO["orb"], torch.bfloat16)))
    assert check.score_gap(items, VO["orb"]) > LIMITS["score_gap"]["limit"]


def test_scores_at_shifted_keypoints_read_above_the_limit(frames):
    it = _port_features(frames[0])
    assert check.score_gap([dict(it, kpts=it["kpts"] + np.float32([1.2, 0]))],
                           VO["orb"]) > LIMITS["score_gap"]["limit"]


def _points_and_views(seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (300, 3))
    T = pose.se3_exp(np.r_[0.3, 0.05, 0.02, 0.02, -0.05, 0.01])
    noise = lambda: rng.normal(0.0, 0.3, (300, 2))
    uv1 = pose.project(np.eye(4), X, CAM)[0] + noise()
    uv2 = pose.project(T, X, CAM)[0] + noise()
    return X, T, uv1, uv2


@pytest.mark.parametrize("seed", [0, 1])
def test_the_pose_reference_finds_the_minimiser_from_either_side(seed):
    X, T, _, uv = _points_and_views(seed)
    from_truth, n = pose.refine(T, X, uv, CAM)
    moved = pose.se3_exp(np.r_[1e-3, -2e-3, 0, 0, 1e-3, -1e-3]) @ T
    from_moved, _ = pose.refine(moved, X, uv, CAM)
    assert n == 300
    dt, dr = pose.gap(pose.inv(from_truth), pose.inv(from_moved))
    assert dt < 1e-10 and dr < 1e-10
    assert 1e-4 < pose.gap(pose.inv(from_truth), pose.inv(T))[0] < 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_the_two_view_reference_recovers_the_relative_pose(seed):
    X, T, uv1, uv2 = _points_and_views(seed)
    R, t = twoview.relative_pose(uv1, uv2, CAM)
    assert np.degrees(pose.angle(R.T @ T[:3, :3])) < 0.1
    assert np.degrees(np.arccos(t @ T[:3, 3] / np.linalg.norm(T[:3, 3]))) < 1.0
    x1, x2 = twoview.normalized(uv1, CAM), twoview.normalized(uv2, CAM)
    R2, t2 = twoview.refine(T[:3, :3], T[:3, 3] / np.linalg.norm(T[:3, 3]), x1, x2)
    assert np.degrees(pose.angle(R.T @ R2)) < 1e-6


def test_the_match_reference_counts_links_that_are_not_the_nearest():
    rng = np.random.default_rng(3)
    X, T, _, uv = _points_and_views(3)
    kpts = np.concatenate([uv, uv + 30.0])           # a decoy 42 px from each keypoint
    desc_pts = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    desc_k = np.concatenate([desc_pts, desc_pts ^ 1])  # decoys 32 bits away
    T_w_c = pose.inv(T)
    args = (desc_pts, None, kpts, desc_k, np.ones(600, bool), T_w_c, None, CAM, 480, 640, 50.0)
    right = np.arange(300)
    assert match.misses(X, args[0], right, *args[2:]) == 0
    assert match.misses(X, args[0], right + 300, *args[2:]) == 300
    assert match.misses(X, args[0], right, *args[2:10], 10.0) == 0


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card(card, tiny_bench, capsys):
    """The control of ``control.py`` at test size: the program with its TF32
    path on, through the benchmark's own run and judge."""
    import control

    bench = tiny_bench / "vobench"
    control.main(["--workload", "vo_tiny.tiny_live", "--seconds", "20", "--fault", "tf32",
                  "--seeds", "7", "--bench", str(bench)])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert rows[0]["correct"] is False and rows[0]["failing"]
