"""Port parity: windowed bundle adjustment (``models/ba.py``) of the PyTorch
package against the JAX package (CPU).

Each mode's problem is built as ``tests/test_ba.py`` builds it and handed
to both packages through ``convert.problem_from_numpy``.

- ``deterministic=True`` runs both LMs in float64 (JAX under
  ``jax.enable_x64``), so both take the same accept/reject path; both return
  float32, so the cost traces, poses and points agree to float32 rounding of
  the same float64 iterates (rtol 1e-6, atol 1e-7).
- In float32 the port meets each bound of the matching JAX test, and its
  final poses are within 1e-4 (translation) of JAX's.

The window's slot bookkeeping is checked on constructed ring states, among
them the one where the keyframe window names the current slot twice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.models import ba as JB
from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.ops.camera import Camera as JCam
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.ops.camera import Camera as TCam
from test_ba import _make_problem, _pose_errs

TCAM = TCam.create(615.0, 615.0, 320.0, 240.0)


def _cfg(**ba):
    cfg = JConfig()
    return cfg.replace(ba=dataclasses.replace(cfg.ba, **ba))


def _biased(prob, seed, frac, sigma):
    """Corrupt ``frac`` of each frame's observations with N(0, sigma) px."""
    rng = np.random.default_rng(seed)
    uv = np.asarray(prob.obs_uv).copy()
    W, K, _ = uv.shape
    for w in range(W):
        bad = rng.choice(K, int(K * frac), replace=False)
        uv[w, bad] += rng.normal(0, sigma, (len(bad), 2))
    return prob._replace(obs_uv=jnp.asarray(uv))


def _outliers(prob):
    """Corrupt 10% of the observations grossly (30-80 px)."""
    uv = np.asarray(prob.obs_uv).copy()
    rng = np.random.default_rng(0)
    for w in range(uv.shape[0]):
        bad = rng.choice(uv.shape[1], uv.shape[1] // 10, replace=False)
        uv[w, bad] += rng.uniform(30, 80, (len(bad), 2))
    return prob._replace(obs_uv=jnp.asarray(uv))


def _mode(name):
    """(problem, cfg, check(T_opt, pts_opt, costs, prob, T_gt, pts_gt), T_gt,
    pts_gt) with the problem, config and bounds of the matching test in
    tests/test_ba.py."""
    if name == "pose_only":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=0.5, pose_noise=0.03)

        def check(T, pts, c, prob, T_gt, pts_gt):
            assert _pose_errs(T, T_gt).max() < 0.01
            assert c[-1] <= c[0]
            np.testing.assert_array_equal(pts, np.asarray(prob.pts))
        return prob, _cfg(fix_map_points=True, iterations=20), check, T_gt, pts_gt
    if name == "joint":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=0.0, pose_noise=0.02, pt_noise=0.05)
        T_init = np.asarray(prob.T_c_w).copy()
        T_init[3:] = T_gt[3:]   # the gauge anchor (oldest two) starts exact
        prob = prob._replace(T_c_w=jnp.asarray(T_init, jnp.float32))

        def check(T, pts, c, prob, T_gt, pts_gt):
            assert _pose_errs(T, T_gt).max() < 5e-3
            used = np.asarray(prob.pt_used)
            err = np.linalg.norm(pts[used] - pts_gt[used], axis=1)
            before = np.linalg.norm(np.asarray(prob.pts)[used] - pts_gt[used], axis=1)
            assert np.median(err) < np.median(before) * 0.3
        return prob, _cfg(fix_map_points=False, iterations=30), check, T_gt, pts_gt
    if name == "joint_noise":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=1.0, pose_noise=0.02, pt_noise=0.03,
                                              seed=3)

        def check(T, pts, c, prob, T_gt, pts_gt):
            assert np.isfinite(c[-1]) and c[-1] < 3.3 and c[-1] <= c[0], c
        return prob, _cfg(fix_map_points=False, iterations=60), check, T_gt, pts_gt
    if name == "regate":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=0.3, pose_noise=0.02, seed=3)
        prob = _biased(prob, 7, 0.2, 6.0)

        def check(T, pts, c, prob, T_gt, pts_gt):
            T_no = TB.ba_solve(convert.config_to_torch(dataclasses.asdict(
                _cfg(fix_map_points=True, iterations=20, regate_px=0.0))), TCAM,
                convert.problem_from_numpy(jax.device_get(prob), "cpu"))[0]
            err_re, err_no = _pose_errs(T, T_gt).max(), _pose_errs(T_no.numpy(), T_gt).max()
            assert err_re < err_no and err_re < 5e-3, (err_re, err_no)
        return prob, _cfg(fix_map_points=True, iterations=20, regate_px=3.0), check, T_gt, pts_gt
    if name == "regate_min_links":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=0.0, pose_noise=0.0)
        from monocular_visual_odometry_tpu.ops import lie as jlie
        T = np.asarray(prob.T_c_w).copy()
        T[2] = np.asarray(jlie.se3_exp(jnp.asarray([0.5, 0.4, 0.0, 0.0, 0.0, 0.0]))) @ T[2]
        prob = prob._replace(T_c_w=jnp.asarray(T))

        def check(T, pts, c, prob, T_gt, pts_gt):
            assert _pose_errs(T, T_gt)[2] < 1e-2
        return prob, _cfg(fix_map_points=True, iterations=20, regate_px=3.0), check, T_gt, pts_gt
    if name == "invalid_frames":
        prob, _, T_gt, pts_gt = _make_problem()
        fv = jnp.asarray([True, True, True, False, False])
        prob = prob._replace(frame_valid=fv, obs_valid=prob.obs_valid & fv[:, None])

        def check(T, pts, c, prob, T_gt, pts_gt):
            np.testing.assert_array_equal(T[3:], np.asarray(prob.T_c_w)[3:])
        return prob, _cfg(fix_map_points=True, iterations=20), check, T_gt, pts_gt
    if name == "huber_outliers":
        prob, _, T_gt, pts_gt = _make_problem(noise_px=0.3, pose_noise=0.02, seed=5)
        prob = _outliers(prob)

        def check(T, pts, c, prob, T_gt, pts_gt):
            assert _pose_errs(T, T_gt).max() < 0.02
        return prob, _cfg(fix_map_points=True, iterations=20), check, T_gt, pts_gt
    raise KeyError(name)


MODES = ["pose_only", "joint", "joint_noise", "regate", "regate_min_links",
         "invalid_frames", "huber_outliers"]


def _solve_both(name, deterministic):
    prob, jcfg, check, T_gt, pts_gt = _mode(name)
    jcfg = jcfg.replace(ba=dataclasses.replace(jcfg.ba, deterministic=deterministic))
    jcam = JCam.create(615.0, 615.0, 320.0, 240.0)
    with jax.enable_x64(deterministic):
        Tj, pj, cj = (np.asarray(a) for a in JB.ba_solve(jcfg, jcam, prob))
    tcfg = convert.config_to_torch(dataclasses.asdict(jcfg))
    Tt, pt, ct = (a.numpy() for a in TB.ba_solve(
        tcfg, TCAM, convert.problem_from_numpy(jax.device_get(prob), "cpu")))
    return (Tj, pj, cj), (Tt, pt, ct), lambda: check(Tt, pt, ct, prob, T_gt, pts_gt)


@pytest.mark.parametrize("mode", MODES)
def test_ba_solve_float32_meets_jax_bounds(mode):
    (Tj, pj, cj), (Tt, pt, ct), check = _solve_both(mode, False)
    assert Tt.dtype == np.float32 and ct.shape == cj.shape
    check()
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_ba_solve_deterministic_matches_jax(mode):
    (Tj, pj, cj), (Tt, pt, ct), _ = _solve_both(mode, True)
    assert Tj.dtype == Tt.dtype == np.float32
    for got, want in ((ct, cj), (Tt, Tj), (pt, pj)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# gather and write-back on constructed ring states
# ---------------------------------------------------------------------------


def _ring_state(cfg, frame_idx, kf_frames, links=False):
    """A JAX state whose ring holds frames 0..frame_idx-1, pose x = frame id,
    keyframes at ``kf_frames``, T_w_c = the last frame's pose. With
    ``links``, map points sit in front of every frame and each frame links
    its first keypoints to them, at pixels 0.5 px off their projection."""
    st = JS.init_state(cfg)
    F, M = cfg.map.frame_buffer, cfg.map.max_map_points
    rng = np.random.default_rng(0)
    n_pts = 48
    pts = np.stack([rng.uniform(-2, 2 + frame_idx, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 8, n_pts)], axis=1).astype(np.float32)
    map_pts = np.asarray(st.map.pts).copy()
    map_valid = np.asarray(st.map.valid).copy()
    if links:
        map_pts[:n_pts], map_valid[:n_pts] = pts, True
    ring = st.ring
    pose = np.eye(4, dtype=np.float32)
    for i in range(frame_idx):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = float(i)
        kpts = np.zeros(np.asarray(st.ring.kpts[0]).shape, np.float32)
        mp = np.full(kpts.shape[0], -1, np.int32)
        if links:
            p = pts - pose[:3, 3]
            uv = p[:, :2] / p[:, 2:3] * 615.0 + [320.0, 240.0]
            kpts[:n_pts] = uv + rng.normal(0, 0.5, uv.shape)
            mp[:n_pts] = np.arange(n_pts)
        ring = ring.push(i % F, jnp.asarray(pose), jnp.asarray(kpts), jnp.asarray(mp),
                         is_kf=(i in kf_frames))
    return st._replace(ring=ring, frame_idx=jnp.asarray(frame_idx, jnp.int32),
                       T_w_c=jnp.asarray(pose),
                       map=st.map._replace(pts=jnp.asarray(map_pts),
                                           valid=jnp.asarray(map_valid)))


def _to_port(cfg, st):
    return (convert.config_to_torch(dataclasses.asdict(cfg)),
            convert.state_from_numpy(jax.device_get(st._asdict()), "cpu"))


def _assert_problems_equal(pt, pj):
    pj = jax.device_get(pj)
    for f in TB.BAProblem._fields:
        got, want = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        if want.dtype == bool or want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=f)


GATHERS = {
    "keyframe_window": (dict(keyframe_window=True, window=4), 10, {0, 3, 6, 8}),
    "current_is_keyframe": (dict(keyframe_window=True, window=3), 6, {2, 4, 5}),
    "too_few_keyframes": (dict(keyframe_window=True, window=5), 3, {0}),
    "duplicated_slot": (dict(keyframe_window=True, window=5), 20, {0, 1}),
    "last_frames": (dict(keyframe_window=False, window=5), 23, {0, 1}),
    "ring_start": (dict(keyframe_window=False, window=5), 2, {0}),
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_gather_window_matches_jax(case):
    ba, frame_idx, kfs = GATHERS[case]
    cfg = _cfg(**ba)
    st = _ring_state(cfg, frame_idx, kfs, links=True)
    jcam = JCam.create(615.0, 615.0, 320.0, 240.0)
    pj, sj = JB.gather_window(cfg, st, jcam)
    tcfg, tst = _to_port(cfg, st)
    pt, s_t = TB.gather_window(tcfg, tst, TCAM)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
    _assert_problems_equal(pt, pj)


def test_duplicated_slot_keeps_the_tracked_ring_pose():
    """frame_idx 20 with keyframes only in slots 0 and 1: the keyframe window
    is slots [19, 1, 0, 19, 18], the second 19 invalid. XLA lets the last
    write win, so the ring keeps slot 19's tracked pose while T_w_c takes
    the solved one; the port must give the same on every run."""
    cfg = _cfg(keyframe_window=True, window=5)
    st = _ring_state(cfg, 20, {0, 1})
    prob_j, slots_j = JB.gather_window(cfg, st)
    assert np.asarray(slots_j).tolist() == [19, 1, 0, 19, 18]
    assert np.asarray(prob_j.frame_valid).tolist() == [True, True, True, False, False]
    # a solved window whose current pose moved 0.01 (inside the trust region)
    T_c_w = np.asarray(prob_j.T_c_w).copy()
    T_c_w[0, 0, 3] -= 0.01
    new_j = JB.write_back(cfg, st, prob_j, slots_j, jnp.asarray(T_c_w), st.map.pts)
    tcfg, tst = _to_port(cfg, st)
    prob_t, slots_t = TB.gather_window(tcfg, tst)
    assert slots_t.tolist() == [19, 1, 0, 19, 18]
    new_t = TB.write_back(tcfg, tst, prob_t, slots_t, torch.from_numpy(T_c_w), tst.map.pts)
    tracked = np.asarray(st.ring.poses)[19]
    np.testing.assert_array_equal(np.asarray(new_j.ring.poses)[19], tracked)
    np.testing.assert_array_equal(new_t.ring.poses[19].numpy(), tracked)
    assert abs(float(new_t.T_w_c[0, 3]) - 19.01) < 1e-5
    np.testing.assert_allclose(new_t.T_w_c.numpy(), np.asarray(new_j.T_w_c), atol=1e-6)
    np.testing.assert_allclose(new_t.ring.poses.numpy(), np.asarray(new_j.ring.poses), atol=1e-6)
    # and through the whole update, on a ring with links
    st = _ring_state(cfg, 20, {0, 1}, links=True)
    jcam = JCam.create(615.0, 615.0, 320.0, 240.0)
    want = jax.device_get(JB.ba_update_state(cfg, jcam, st))
    tcfg, tst = _to_port(cfg, st)
    got = TB.ba_update_state(tcfg, TCAM, tst)
    np.testing.assert_array_equal(got.ring.poses[19].numpy(), np.asarray(st.ring.poses)[19])
    np.testing.assert_allclose(got.T_w_c.numpy(), np.asarray(want.T_w_c), atol=1e-4)
    np.testing.assert_allclose(got.ring.poses.numpy(), np.asarray(want.ring.poses), atol=1e-4)


@pytest.mark.parametrize("shift,rejected", [(0.2, True), (0.01, False)])
def test_trust_region_matches_jax(shift, rejected):
    """write_back rejects a window whose current pose moved beyond
    max_pose_correction (state unchanged, counted) and applies a small one."""
    cfg = JConfig()
    st = _ring_state(cfg, 3, {0, 2})
    prob_j, slots_j = JB.gather_window(cfg, st)
    prob_j = prob_j._replace(frame_valid=jnp.ones(cfg.ba.window, bool))
    T_c_w = np.asarray(prob_j.T_c_w).copy()
    T_c_w[0, 0, 3] -= shift
    want = JB.write_back(cfg, st, prob_j, slots_j, jnp.asarray(T_c_w), st.map.pts)
    tcfg, tst = _to_port(cfg, st)
    prob_t = convert.problem_from_numpy(jax.device_get(prob_j), "cpu")
    got = TB.write_back(tcfg, tst, prob_t, torch.from_numpy(np.asarray(slots_j)).long(),
                        torch.from_numpy(T_c_w), tst.map.pts)
    assert int(got.ba_rejected) == int(want.ba_rejected) == int(rejected)
    for f in ("T_w_c", "ref_pose", "last_keyframe_pose"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.ring.poses.numpy(), np.asarray(want.ring.poses), atol=1e-6)
