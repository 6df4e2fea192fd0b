"""Port parity for the whole path: the per-frame VO step without and with
windowed BA, the PyTorch package against the JAX package on the same
rendered frames (CPU), and the port's independence from JAX.

The two packages draw their RANSAC samples from different generators, so a
run is not bit-identical: end to end the budget is an ATE band. The port
must track the 30-frame sequence with ATE < 0.10 (the budget of the JAX
package's own ``test_vo_pipeline``) and within max(0.02, half the JAX ATE)
of the JAX run. One tracking step started from the same carried-over state
must land within 1e-3 (pose_distance, world units on a ~1.9-unit path) of
the JAX step: the PnP samples differ, the inlier set and the polished pose
should not. With BA on, the same budgets hold, and on the carried-over state
BA's window, solve and write-back agree with the JAX package's: the window's
masks and slots exactly, its floats to 1e-6, the state after BA to 1e-4.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu.models import ba as JB
from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models.vo import VOEngine as JEngine
from monocular_visual_odometry_tpu.utils import metrics as jmetrics
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models.vo import VOEngine as TEngine
from monocular_visual_odometry_tpu_torch.ops import lie as tlie
from monocular_visual_odometry_tpu_torch.utils import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 30
CARRY_FRAME = 15  # the state after this frame is carried across


def _small_cfg(ba=False):
    """The capacity-reduced config of tests/test_vo_pipeline.py, BA off or on."""
    cfg = JConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, enabled=ba),
    )


def _port_cfg(ba=False):
    return convert.config_to_torch(dataclasses.asdict(_small_cfg(ba)))


@pytest.fixture(scope="module")
def sequence():
    frames, gt = tsyn.render_sequence_arrays(N_FRAMES, seed=0, translation_step=0.05)
    return frames, gt


def _run_jax(cfg, frames):
    eng = JEngine(cfg, 480, 640)
    outs, carried = [], None
    for i, f in enumerate(frames):
        outs.append(jax.device_get(eng.add_frame(f.astype(np.float32))))
        if i == CARRY_FRAME:
            carried = {k: jax.device_get(v) for k, v in eng.state._asdict().items()}
    return outs, carried


@pytest.fixture(scope="module")
def jax_run(sequence):
    return _run_jax(_small_cfg(), sequence[0])


@pytest.fixture(scope="module")
def jax_run_ba(sequence):
    return _run_jax(_small_cfg(ba=True), sequence[0])


@pytest.fixture(scope="module")
def torch_run(sequence):
    eng = TEngine(_port_cfg(), 480, 640, device="cpu")
    return [eng.add_frame(f) for f in sequence[0]]


@pytest.fixture(scope="module")
def torch_run_ba(sequence):
    eng = TEngine(_port_cfg(ba=True), 480, 640, device="cpu")
    calls = TB.ba_update_state.calls
    outs = [eng.add_frame(f) for f in sequence[0]]
    return outs, TB.ba_update_state.calls - calls


def _ate(outs, gt):
    return tmetrics.ate_rmse(np.stack([np.asarray(o.T_w_c) for o in outs]), gt)


def _failures(outs, stage_tracking):
    return sum(int(o.stage) == stage_tracking and not bool(o.tracking_ok) for o in outs)


def test_rendered_sequence_matches_jax_renderer(sequence):
    frames, gt = sequence
    np.testing.assert_array_equal(gt, jsyn.make_trajectory(N_FRAMES, seed=0,
                                                           translation_step=0.05))
    K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])
    planes = jsyn.default_scene(0)
    for i in (0, N_FRAMES - 1):
        np.testing.assert_array_equal(frames[i], jsyn.render_frame(gt[i], planes, K))


def test_metrics_match_jax(sequence):
    _, gt = sequence
    est = gt.copy()
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] + np.random.default_rng(0).normal(0, 0.02, (N_FRAMES, 3))
    assert tmetrics.ate_rmse(est, gt) == pytest.approx(jmetrics.ate_rmse(est, gt, "sim3"),
                                                       rel=1e-12)
    assert tmetrics.trajectory_length(gt) == pytest.approx(jmetrics.trajectory_length(gt),
                                                           rel=1e-12)


def _check_tracks(gt, j_outs, t_outs):
    assert int(j_outs[-1].stage) == JS.STAGE_TRACKING
    assert int(t_outs[-1].stage) == TS.STAGE_TRACKING
    assert _failures(t_outs, TS.STAGE_TRACKING) <= 2
    ate_j, ate_t = _ate(j_outs, gt), _ate(t_outs, gt)
    assert ate_t < 0.10, f"port ATE {ate_t:.4f}"
    assert abs(ate_t - ate_j) <= max(0.02, 0.5 * ate_j), (ate_t, ate_j)
    # the same frame starts tracking within a frame or two
    first = lambda outs, s: next(i for i, o in enumerate(outs) if int(o.stage) == s)
    assert abs(first(t_outs, TS.STAGE_TRACKING) - first(j_outs, JS.STAGE_TRACKING)) <= 2


def test_both_packages_track_the_sequence(sequence, jax_run, torch_run):
    _check_tracks(sequence[1], jax_run[0], torch_run)


def test_both_packages_track_the_sequence_with_ba(sequence, jax_run_ba, torch_run_ba):
    outs, ba_calls = torch_run_ba
    _check_tracks(sequence[1], jax_run_ba[0], outs)
    # BA runs once on every tracking frame whose tracking held
    tracked = [o for prev, o in zip(outs, outs[1:]) if int(prev.stage) == TS.STAGE_TRACKING]
    assert ba_calls == sum(bool(o.tracking_ok) for o in tracked) > 0


def _step_from_carried(frames, run, ba):
    j_outs, carried = run
    assert int(carried["stage"]) == JS.STAGE_TRACKING
    eng = TEngine(_port_cfg(ba), 480, 640, device="cpu")
    eng.state = convert.state_from_numpy(carried, device="cpu")
    out = eng.add_frame(frames[CARRY_FRAME + 1])
    want = j_outs[CARRY_FRAME + 1]
    assert bool(out.tracking_ok) and bool(want.tracking_ok)
    assert bool(out.is_keyframe) == bool(want.is_keyframe)
    dist = float(tlie.pose_distance(out.T_w_c, torch.from_numpy(np.array(want.T_w_c))))
    assert dist < 1e-3, dist
    assert abs(int(out.n_inliers) - int(want.n_inliers)) <= 0.05 * int(want.n_inliers)
    assert int(out.ba_rejected_total) == int(want.ba_rejected_total)


def test_tracking_step_from_carried_state(sequence, jax_run):
    _step_from_carried(sequence[0], jax_run, ba=False)


def test_tracking_and_ba_step_from_carried_state(sequence, jax_run_ba):
    _step_from_carried(sequence[0], jax_run_ba, ba=True)


def test_ba_on_carried_state_matches_jax(jax_run_ba):
    """gather_window, ba_update_state and write_back on the JAX engine's
    state after frame CARRY_FRAME (BA on)."""
    _, carried = jax_run_ba
    jcfg, tcfg = _small_cfg(ba=True), _port_cfg(ba=True)
    jst = jax.tree.map(jnp.asarray, JS.VOState(**carried))
    tst = convert.state_from_numpy(carried, device="cpu")
    jeng = JEngine(jcfg, 480, 640)
    teng = TEngine(tcfg, 480, 640, device="cpu")
    pj, sj = jax.device_get(JB.gather_window(jcfg, jst, jeng.cam))
    pt, s_t = TB.gather_window(tcfg, tst, teng.cam)
    np.testing.assert_array_equal(s_t.numpy(), sj)
    assert pj.obs_valid.sum() > 100
    for f in TB.BAProblem._fields:
        got, want = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        if want.dtype.kind in "bi":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=f)

    def close(got, want):
        for f in ("T_w_c", "ref_pose", "last_keyframe_pose"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=1e-4, rtol=0, err_msg=f)
        np.testing.assert_allclose(got.ring.poses.numpy(), np.asarray(want.ring.poses),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.map.pts.numpy(), np.asarray(want.map.pts), atol=1e-4,
                                   rtol=0)
        assert int(got.ba_rejected) == int(want.ba_rejected)

    close(TB.ba_update_state(tcfg, teng.cam, tst),
          jax.device_get(JB.ba_update_state(jcfg, jeng.cam, jst)))
    # write-back of the same solved window (JAX's)
    T_c_w, pts, _ = jax.device_get(JB.ba_solve(jcfg, jeng.cam, JB.BAProblem(*pj)))
    close(TB.write_back(tcfg, tst, pt, s_t, torch.from_numpy(np.array(T_c_w)),
                        torch.from_numpy(np.array(pts))),
          jax.device_get(JB.write_back(jcfg, jst, JB.BAProblem(*pj), sj, T_c_w, pts)))


def test_engine_refuses_what_it_cannot_run():
    """The default config (BA on) builds an engine on the CPU; "cuda"
    without a card raises."""
    eng = TEngine(convert.config_to_torch(dataclasses.asdict(JConfig())), 480, 640,
                  device="cpu")
    assert eng.cfg.ba.enabled and eng.cfg.ransac.essential_minimal == "8pt"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TEngine(convert.config_to_torch(dataclasses.asdict(_small_cfg())), 480, 640)


def _port_files():
    return sorted((ROOT / "monocular_visual_odometry_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    """No import of jax or of the JAX package anywhere in the port or in
    chip_smoke.py, none of yaml or PIL either (the card's machine has
    neither), and matplotlib only inside functions. Imports by name
    (``importlib.import_module``, ``__import__``) count too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            in_function.update(id(n) for n in ast.walk(fn) if n is not fn)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "monocular_visual_odometry_tpu", "yaml", "PIL"), \
                f"{path.name}:{node.lineno} imports {name}"
            if root == "matplotlib":
                assert id(node) in in_function, \
                    f"{path.name}:{node.lineno} imports {name} outside a function"
