"""The BA LM kernel's wrapper (``ops/cuda/ba_lm.py``) on a machine without
a card.

``ba_solve`` on CPU tensors is the plain loop (``models/ba.py::lm_loop``)
and never builds or loads the kernel's library; the operator
``mvo::ba_lm_pose`` and its vmap rule register when the module is imported,
and on CPU tensors both run the plain version (the vmap rule per stream), so
their results equal the loop's bit for bit. The wrapper refuses the joint
mode, and its launch refuses a CPU tensor before it loads anything. The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import pytest
import torch

from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import capture
from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm, build
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig
from test_torch_cuda import BA_MODES, CAM, _ba_problem

# the pose-only modes of the card tests, with their problems' sizes cut
MODES = {k: v for k, v in BA_MODES.items() if v[1].get("fix_map_points", True)}


def _case(mode, deterministic=False, seed=None):
    prob_kw, ba_kw = MODES[mode]
    prob_kw = dict(prob_kw, K=48, M=128, **({} if seed is None else {"seed": seed}))
    prob = _ba_problem(**prob_kw)
    if mode == "invalid_frames":
        fv = torch.tensor([True, True, True, False, False])
        prob = prob._replace(frame_valid=fv, obs_valid=prob.obs_valid & fv[:, None])
    if mode == "huber_outliers":
        uv = prob.obs_uv.clone()
        uv[:, ::10] += 50.0
        prob = prob._replace(obs_uv=uv)
    cfg = VOConfig()
    ba_kw = dict(ba_kw, iterations=6)
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, deterministic=deterministic, **ba_kw))
    return cfg, prob


def _no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel's library was built or loaded")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(ba_lm, "_launch", refuse)


def _equal(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("deterministic", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ba_solve_on_cpu_takes_the_loop_without_the_library(monkeypatch, mode, deterministic):
    cfg, prob = _case(mode, deterministic)
    _no_library(monkeypatch)
    launches = ba_lm.ba_lm_pose.launches
    got = TB.ba_solve(cfg, CAM, prob)
    _equal(got, TB.lm_loop(cfg.ba, CAM, prob))
    assert ba_lm._lib is None and ba_lm.ba_lm_pose.launches == launches


@pytest.mark.parametrize("mode", ["pose_only", "regate"])
def test_operator_on_cpu_is_the_plain_version(monkeypatch, mode):
    cfg, prob = _case(mode)
    _no_library(monkeypatch)
    assert hasattr(torch.ops.mvo, "ba_lm_pose")
    T, pts, costs = ba_lm.ba_lm_pose(cfg.ba, CAM, prob)
    want = TB.lm_loop(cfg.ba, CAM, prob)
    _equal((T, costs), (want[0], want[2]))
    assert pts is prob.pts and costs.shape == (cfg.ba.iterations,)


@pytest.mark.parametrize("batch", [1, 3])
def test_vmap_rule_runs_each_stream_on_its_own(monkeypatch, batch):
    """``torch.func.vmap`` of the operator goes through its vmap rule (an op
    without one raises under vmap here: the slow fallback is off), and each
    stream equals its own call."""
    cfg, _ = _case("regate")
    probs = [_case("regate", seed=10 + b)[1] for b in range(batch)]
    _no_library(monkeypatch)
    stacked = [torch.stack(f) for f in zip(*probs)]
    solve = lambda *f: ba_lm.ba_lm_pose(cfg.ba, CAM, TB.BAProblem(*f))
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        T, _, costs = torch.func.vmap(solve)(*stacked)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)
    for b, p in enumerate(probs):
        one = ba_lm.ba_lm_pose(cfg.ba, CAM, p)
        _equal((T[b], costs[b]), (one[0], one[2]))


def test_vmap_rule_expands_an_unbatched_input(monkeypatch):
    cfg, prob = _case("pose_only")
    _no_library(monkeypatch)
    uv = torch.stack([prob.obs_uv, prob.obs_uv + 0.25])
    solve = lambda u: ba_lm.ba_lm_pose(cfg.ba, CAM, prob._replace(obs_uv=u))
    T, _, costs = torch.func.vmap(solve)(uv)
    for b in range(2):
        one = ba_lm.ba_lm_pose(cfg.ba, CAM, prob._replace(obs_uv=uv[b]))
        _equal((T[b], costs[b]), (one[0], one[2]))


def test_wrapper_refuses_the_joint_mode():
    cfg, prob = _case("pose_only")
    joint = dataclasses.replace(cfg.ba, fix_map_points=False)
    with pytest.raises(ValueError, match="fix_map_points"):
        ba_lm.ba_lm_pose(joint, CAM, prob)


def test_launch_refuses_cpu_tensors_before_loading(monkeypatch):
    cfg, prob = _case("pose_only")
    monkeypatch.setattr(build, "load", lambda *a: pytest.fail("loaded the library"))
    args = [getattr(prob, f)[None] for f in ("T_c_w", "obs_uv", "obs_pid", "obs_valid", "pts",
                                             "frame_valid")]
    with pytest.raises(ValueError, match="unsupported device"):
        ba_lm._launch(*args, ba_lm._params(cfg.ba, CAM), cfg.ba.iterations, False)


def test_a_replay_counts_the_kernel():
    """The captured programs move ``ba_lm_pose.launches`` on each replay, as
    they move the other counters."""
    assert capture.COUNTERS["ba_lm_pose"] == (ba_lm.ba_lm_pose, "launches")
