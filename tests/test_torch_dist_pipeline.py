"""Port parity: the live tracking loop on the mesh route
(``VOEngine(mesh=...)``: BA sharded by ``parallel/dist_ba.py`` inside the
per-frame step) in two gloo processes, against the port's single-device
route and against JAX's ``VOEngine(mesh=points_mesh())`` on the 8-device
virtual CPU mesh.

The sequence and the configuration are ``tests/test_dist_pipeline.py``'s
(18 frames, 512 keypoints, 2,048 map slots, 256/128 hypotheses, 10 LM
iterations), and so are the gates, against each reference:

- landmarks fixed (the default): largest translation distance < 0.02 and
  |dATE| < 0.01;
- joint: < 0.05 and |dATE| < 0.03 (f32 noise compounds through 18 frames);
- the mesh route tracks with ATE < 0.13 and a finite map mostly in front.

Every rank steps the same frames; each rank's poses must equal rank 0's
bitwise, the sharded BA must run on every tracking frame, and a frame
whose tracking fails must call the same collectives as one where it holds.
The engines of each process run on one torch thread.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

from monocular_visual_odometry_tpu.data import synthetic as syn
from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.utils import metrics
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from torch_dist_worker import launch

N_FRAMES = 18
# mode -> (translation distance, |dATE|): tests/test_dist_pipeline.py's gates
GATES = {"fixed": (0.02, 0.01), "joint": (0.05, 0.03)}


def _cfg(mode):
    cfg = JConfig()
    cfg = cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, iterations=10))
    if mode == "joint":
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, fix_map_points=False))
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the port's mesh route on each of two ranks, its single
    route and JAX's mesh route (each a process of its own)."""
    planes = syn.default_scene(0)
    K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])
    gt = syn.make_trajectory(N_FRAMES, seed=0, translation_step=0.05)
    frames = np.stack([syn.render_frame(gt[i], planes, K).astype(np.float32)
                       for i in range(N_FRAMES)])
    # per mode one world of two ranks, one process of the single route and
    # one of JAX's mesh route, all at once
    jobs = [(job, world, mode) for job, world in (("pipeline", 2), ("single", 1), ("jax", 1))
            for mode in GATES]
    results, errors = {}, []

    def run(job, world, mode):
        try:
            work = tmp_path_factory.mktemp(f"{job}_{mode}")
            np.savez(work / "inputs.npz", frames=frames,
                     spec=json.dumps({"configs": {mode: dataclasses.asdict(_cfg(mode))}}))
            results[job, mode] = launch(job, world, str(work), timeout=900)
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    merge = lambda job, r: {k: v for mode in GATES for k, v in results[job, mode][r].items()}
    return gt, [merge("pipeline", r) for r in range(2)], merge("single", 0), merge("jax", 0)


def _ate(poses, gt):
    return metrics.ate_rmse(poses, gt, align="sim3")


@pytest.mark.parametrize("mode", sorted(GATES))
def test_mesh_route_tracks(runs, mode):
    gt, ranks, _, _ = runs
    r = ranks[0]
    assert int(r[f"{mode}_stages"][-1]) == JS.STAGE_TRACKING
    poses = r[f"{mode}_poses"]
    assert np.isfinite(poses).all()
    assert _ate(poses, gt) < 0.13
    assert bool(r[f"{mode}_pts_finite"]) and float(r[f"{mode}_pts_z_pos"]) > 0.9
    # the sharded BA ran on every tracking frame (applied where tracking held)
    tracking = int((r[f"{mode}_stages"] == JS.STAGE_TRACKING).sum())
    assert int(r[f"{mode}_ba_calls"]) == tracking - 1   # not on the init frame


@pytest.mark.parametrize("mode", sorted(GATES))
@pytest.mark.parametrize("reference", ["port single route", "jax mesh route"])
def test_mesh_route_matches(runs, mode, reference):
    gt, ranks, single, jax_poses = runs
    mesh = ranks[0][f"{mode}_poses"]
    ref = (single if reference == "port single route" else jax_poses)[f"{mode}_poses"]
    dist_gate, ate_gate = GATES[mode]
    d = np.linalg.norm(mesh[:, :3, 3] - ref[:, :3, 3], axis=1)
    assert d.max() < dist_gate, d.max()
    assert abs(_ate(mesh, gt) - _ate(ref, gt)) < ate_gate, (_ate(mesh, gt), _ate(ref, gt))


@pytest.mark.parametrize("mode", sorted(GATES))
def test_ranks_step_bitwise_equal(runs, mode):
    _, ranks, _, _ = runs
    for key in ("poses", "stages", "ok", "n_rec"):
        np.testing.assert_array_equal(ranks[1][f"{mode}_{key}"], ranks[0][f"{mode}_{key}"])


@pytest.mark.parametrize("mode", sorted(GATES))
def test_collective_schedule_depends_on_the_stage_only(runs, mode):
    """Every tracking frame calls the same collectives, and a blank frame,
    on which tracking fails, calls them too: the sharded BA is computed on
    every tracking frame and applied by a select."""
    _, ranks, _, _ = runs
    r = ranks[0]
    stages, n_rec = r[f"{mode}_stages"], r[f"{mode}_n_rec"]
    # a frame's record counts the BA of the frame that entered in tracking
    entered_tracking = np.concatenate([[False], stages[:-1] == JS.STAGE_TRACKING])
    assert (n_rec[~entered_tracking] == 0).all()
    per_frame = set(n_rec[entered_tracking].tolist())
    assert len(per_frame) == 1 and per_frame.pop() > 0
    assert not bool(r[f"{mode}_fail_ok"])
    assert int(r[f"{mode}_fail_n_rec"]) == int(n_rec[entered_tracking][0])


def test_engine_refuses_a_mesh_that_does_not_divide_its_shapes():
    """``max_keypoints`` (1,024) and ``max_map_points`` (4,096) must split
    over the ranks: a mesh of 3 raises before any frame."""
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    class _Mesh:
        size = 3

    with pytest.raises(ValueError, match="divide by the mesh size 3"):
        VOEngine(VOConfig(), 480, 640, device="cpu", mesh=_Mesh())
