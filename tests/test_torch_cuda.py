"""The CUDA matcher kernel against its plain PyTorch version (one call and
one batched launch over B streams), BA, the five-point solver, the batched
tracking step and the general multi-stream step on the card against the
same calls on the CPU.

Marked ``cuda``: here, without a card, every test skips. On a machine with
one (which has no JAX, so the JAX-importing ``conftest.py`` is left out):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The outputs are Hamming distances, 1e9 sentinels and indices, so the kernel
must equal the plain version exactly (``torch.equal``), the lowest-index
tie rule and the union radius gate included. ``CASES`` also feeds the
plain version against the JAX kernel in ``test_torch_matching.py``;
``RAGGED_CASES`` hold shapes that kernel does not take (K1 not a multiple
of 128, K2 not a multiple of 512), which ``test_torch_matching.py`` holds
against the JAX XLA route instead. The kernel stages the train set in
1024-point stages through a two-buffer ring: the ``stages_*`` cases cross
stage boundaries, the ragged ones end a stage off the 16-byte grid of its
bulk copies and leave the last block of queries part-empty.

A batched launch matches each stream's queries against its own train set:
stream b must equal the plain version of stream b (``BATCHED_CASES``:
the batched tracking step's shapes at B=8, and B=3 with ragged K1 and K2,
one stream with no valid query, one with a single valid train point, and
K2=1).

BA's scatter-adds are atomics on the card, so float32 sums differ from the
CPU's in the last bits: poses agree to 1e-4, and with ``deterministic=True``
(float64) to float32 rounding (rtol 1e-6). With the landmarks fixed the LM
is one kernel on the card (``csrc/ba_lm_pose.cu``): it is held against its
plain version (``lm_loop``) on the card at the main path's windows, under
vmap (one launch; each stream its own launch exactly), and its wrapper's
refusals; it launches once per BA call, per replay on the graph route. The five-point solver is compared
in float64, as a solution set (see ``test_torch_fivepoint.py``). A state
checkpoint saved on the card resumes there. ``VOEngine``'s graph route (one
replay of a captured stage program per frame) equals the eager ``step``
over 12 frames, the five-point configuration's too (its init a graph),
waits once per frame, and a replay runs the kernel; a program that reads a
value back fails to capture and raises. The sharded BA
(``parallel/dist_ba.py``) runs in a one-rank NCCL world against ``ba_solve``
on the card, once on the mesh route without a host sync, and on the
captured mesh route (the tracking graph replaying its collectives) against
the eager mesh step.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from monocular_visual_odometry_tpu_torch.data import synthetic as TSYN
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops import fivepoint as TF
from monocular_visual_odometry_tpu_torch.ops import lie as TL
from monocular_visual_odometry_tpu_torch.ops import matching as TM
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH
from monocular_visual_odometry_tpu_torch.utils import logging as LG
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig


def _inputs(k1, k2, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    return dict(
        d1=rng.integers(0, 256, (k1, 32), dtype=np.uint8),
        d2=rng.integers(0, 256, (k2, 32), dtype=np.uint8),
        uv1=rng.uniform(0, 400, (k1, 2)).astype(np.float32),
        uv2=rng.uniform(0, 400, (k2, 2)).astype(np.float32),
        v1=rng.uniform(size=k1) >= invalid,
        v2=rng.uniform(size=k2) >= invalid,
        alt=None,
    )


def _union_case():
    """Train i carries query i's descriptor, reachable only from the alt position."""
    x = _inputs(128, 512, 5, invalid=0.0)
    x["d2"][:128] = x["d1"]
    x["uv2"] = np.random.default_rng(6).uniform(0, 640, (512, 2)).astype(np.float32)
    x["uv1"] = x["uv2"][:128] + 500.0
    x["alt"] = x["uv2"][:128].copy()
    return x


def _tie_case():
    """Each train descriptor appears four times: best == second, lowest index wins."""
    x = _inputs(128, 512, 7, invalid=0.0)
    x["d2"] = np.tile(x["d2"][:128], (4, 1))
    x["uv2"] = np.tile(x["uv2"][:128], (4, 1))
    return x


CASES = {
    "random": (lambda: _inputs(256, 512, 0), 120.0),
    "radius_zero": (lambda: _inputs(256, 512, 1), 0.0),
    "all_invalid": (lambda: {**_inputs(256, 512, 2), "v1": np.zeros(256, bool)}, 1e6),
    "multi_tile": (lambda: _inputs(128, 1024, 3), 1e6),
    "union_gate": (_union_case, 50.0),
    "forced_tie": (_tie_case, 1e6),
    "stages_2560": (lambda: _inputs(128, 2560, 8), 60.0),
    "stages_4608": (lambda: _inputs(128, 4608, 9), 1e6),  # every valid pair gated in
}

RAGGED_CASES = {
    "k2_1001": (lambda: _inputs(200, 1001, 20), 80.0),
    "k1_1003_k2_2049": (lambda: _inputs(1003, 2049, 21), 60.0),
    "k1_1": (lambda: _inputs(1, 1024, 22, invalid=0.0), 1e6),
    "k2_1": (lambda: _inputs(1000, 1, 23, invalid=0.0), 1e6),
    "k1_1_k2_1": (lambda: _inputs(1, 1, 24, invalid=0.0), 1e6),
}


def _on_card(x):
    return {k: None if v is None else torch.from_numpy(np.array(v)).cuda() for k, v in x.items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + sorted(RAGGED_CASES))
def test_kernel_equals_plain_version(card, case):
    make, r = {**CASES, **RAGGED_CASES}[case]
    x = _on_card(make())
    args = (x["d1"], x["uv1"], x["v1"], x["d2"], x["uv2"], x["v2"], r)
    before = TH.hamming_nn_top2.launches
    got = TH.hamming_nn_top2(*args, uv1_alt=x["alt"])
    want = TH.hamming_nn_top2_reference(*args, uv1_alt=x["alt"])
    torch.cuda.synchronize()
    assert TH.hamming_nn_top2.launches == before + 1
    for g, w, what in zip(got, want, ("best", "second", "idx")):
        assert torch.equal(g, w), what


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 2, 3])
def test_match_features_on_card_equals_cpu(card, method):
    x = CASES["union_gate"][0]()
    keys = ("d1", "d2", "v1", "v2", "uv1", "uv2")
    cpu = [torch.from_numpy(np.array(x[k])) for k in keys]
    alt = torch.from_numpy(x["alt"]) if method == 3 else None
    want = TM.match_features(*cpu, method=method, kpts1_alt=alt)
    before = TH.hamming_nn_top2.launches
    got = TM.match_features(*(t.cuda() for t in cpu), method=method,
                            kpts1_alt=None if alt is None else alt.cuda())
    assert TH.hamming_nn_top2.launches == before + 1
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = _on_card(CASES["random"][0]())
    args = [x["d1"], x["uv1"], x["v1"], x["d2"], x["uv2"], x["v2"], 50.0]
    with pytest.raises(ValueError):
        TH.hamming_nn_top2(x["d1"][:, :16], *args[1:])
    with pytest.raises(TypeError):
        TH.hamming_nn_top2(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        TH.hamming_nn_top2(args[0], args[1].cpu(), *args[2:])


def _batched(b, k1, k2, seed, alt=False, r=50.0):
    """B streams of ``_inputs`` stacked; stream 1 of a ragged case has no
    valid query and stream 2 a single valid train point."""
    xs = [_inputs(k1, k2, seed + i) for i in range(b)]
    if b == 3:
        xs[1]["v1"][:] = False
        xs[2]["v2"][:] = False
        xs[2]["v2"][k2 // 2] = True
    out = {k: np.stack([x[k] for x in xs]) for k in ("d1", "d2", "uv1", "uv2", "v1", "v2")}
    out["alt"] = (out["uv1"] + np.random.default_rng(seed).normal(0, 30, out["uv1"].shape)
                  ).astype(np.float32) if alt else None
    return out, r


BATCHED_CASES = {
    "track_b8": lambda: _batched(8, 1536, 1024, 30, alt=True, r=50.0),
    "keyframe_b8": lambda: _batched(8, 1024, 1024, 40, r=100.0),
    "ragged_b3": lambda: _batched(3, 1003, 777, 50, alt=True, r=80.0),
    "k2_1_b3": lambda: _batched(3, 1003, 1, 60, r=1e6),
    "stages_b2": lambda: _batched(2, 129, 2049, 70, r=1e6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_launch_equals_plain_version_per_stream(card, case):
    x, r = BATCHED_CASES[case]()
    x = _on_card(x)
    args = (x["d1"], x["uv1"], x["v1"], x["d2"], x["uv2"], x["v2"], r)
    before = TH.hamming_nn_top2.launches
    got = TH.hamming_nn_top2_batched(*args, uv1_alt=x["alt"])
    # vmap of the one-stream call goes through the same single launch
    call = lambda d1, p1, v1, d2, p2, v2, pa: TH.hamming_nn_top2(
        d1, p1, v1, d2, p2, v2, r, uv1_alt=None if x["alt"] is None else pa)
    got_vmap = torch.func.vmap(call)(*args[:6], x["uv1"] if x["alt"] is None else x["alt"])
    torch.cuda.synchronize()
    assert TH.hamming_nn_top2.launches == before + 2
    for b in range(x["d1"].shape[0]):
        want = TH.hamming_nn_top2_reference(*(a[b] for a in args[:6]), r,
                                            uv1_alt=None if x["alt"] is None else x["alt"][b])
        for g, gv, w, what in zip(got, got_vmap, want, ("best", "second", "idx")):
            assert torch.equal(g[b], w) and torch.equal(gv[b], w), (b, what)


def _warm_streams(cfg, n_streams, warm, steps, device):
    """Engines on ``device`` warmed up over ``warm`` frames of sequences
    seed 0.. n_streams-1; returns (stacked states, frames [B,steps,H,W])."""
    sts, frames = [], []
    for seed in range(n_streams):
        seq, _ = TSYN.render_sequence_arrays(warm + steps, seed=seed, translation_step=0.05)
        eng = TV.VOEngine(cfg, 480, 640, device=device)
        for f in seq[:warm]:
            eng.add_frame(f)
        assert int(eng.state.stage) == TS.STAGE_TRACKING
        sts.append(eng.state)
        frames.append(seq[warm:])
    return TS.stack_states(sts), np.stack(frames)


def _small_cfg():
    cfg = VOConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048))


@pytest.mark.cuda
def test_batched_step_on_card_matches_cpu_and_never_waits(card):
    """One B=2 step on the card, its body under set_sync_debug_mode("error"),
    against the same step on a CPU copy fed the card's draws: the counts
    that follow from the matches within 5% (the card's features round
    differently, so a near-tied keypoint can move a match), the other
    integer outputs equal, poses within 1e-3 (pose_distance)."""
    cfg = _small_cfg()
    sts, frames = _warm_streams(cfg, 2, 12, 1, "cuda")
    imgs = torch.from_numpy(frames[:, 0]).float().cuda()
    draws = TV.draw_batched(cfg, sts.rng, "cuda")
    before = TH.hamming_nn_top2.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TV.tracking_batched_body(cfg, CAM, sts, imgs, draws, height=480, width=640)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TH.hamming_nn_top2.launches == before + 2   # tracking and keyframe update
    _, got = TV.step_tracking_batched(cfg, CAM, sts, imgs, height=480, width=640, draws=draws)
    _, want = TV.step_tracking_batched(
        cfg, CAM, TS.state_to(sts, "cpu"), imgs.cpu(), height=480, width=640,
        draws=TV.BatchedDraws(*(None if d is None else d.cpu() for d in draws)))
    for f in ("stage", "n_keypoints", "n_candidates", "is_keyframe", "tracking_ok",
              "ba_rejected_total"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("n_matches", "n_inliers", "n_map_points"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        assert ((g - w).abs() <= 0.05 * w).all(), f
    for b in range(2):
        assert float(TL.pose_distance(got.T_w_c[b].cpu(), want.T_w_c[b])) < 1e-3


@pytest.mark.cuda
def test_features_under_vmap_do_not_depend_on_the_batch(card):
    """The frontend vmapped over B copies of a frame gives each copy exactly
    what it gives at B=1 (the pyramid's taps, not a GEMM whose kernel cuBLAS
    picks by the batch)."""
    cfg = VOConfig()
    seq, _ = TSYN.render_sequence_arrays(1, seed=0, translation_step=0.05)
    img = torch.from_numpy(seq[0]).float().cuda()
    feats = lambda x: tuple(TV.features_from_config(x, cfg.orb))
    one = torch.func.vmap(feats)(img[None])
    for b in (2, 4, 8):
        many = torch.func.vmap(feats)(img[None].expand(b, -1, -1).contiguous())
        for f, g in zip(one, many):
            assert all(torch.equal(g[i], f[0]) for i in range(b)), b


@pytest.mark.cuda
def test_general_step_on_card_matches_cpu_and_never_waits(card):
    """One mixed-stage general step (streams blank, initializing, tracking,
    tracking on a blank frame) on the card, its body under
    set_sync_debug_mode("error") with one batched launch per match (init,
    tracking, keyframe update), against the same step on a CPU copy fed the
    card's draws, with the budgets of the batched tracking step above; each
    stream's next key as ``step`` leaves it."""
    cfg = _small_cfg()
    seq, _ = TSYN.render_sequence_arrays(10, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    states = [eng.state]
    for f in seq[:8]:
        eng.add_frame(f)
        states.append(eng.state)
    assert int(states[8].stage) == TS.STAGE_TRACKING
    picked = [states[0], states[1], states[8], states[8]]
    sts = TS.stack_states(picked)
    imgs = torch.from_numpy(np.stack([seq[0], seq[1], seq[8], np.zeros_like(seq[0])]))
    imgs = imgs.float().cuda()
    draws = TV.draw_general(cfg, sts.rng, "cuda")
    before = TH.hamming_nn_top2.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TV.general_batched_body(cfg, CAM, sts, imgs, draws, height=480, width=640)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TH.hamming_nn_top2.launches == before + 3
    new, got = TV.step_general_batched(cfg, CAM, sts, imgs, height=480, width=640,
                                       draws=draws)
    _, want = TV.step_general_batched(
        cfg, CAM, TS.state_to(sts, "cpu"), imgs.cpu(), height=480, width=640,
        draws=TV.BatchedDraws(*(None if d is None else d.cpu() for d in draws)))
    for f in ("stage", "n_keypoints", "n_candidates", "is_keyframe", "tracking_ok",
              "ba_rejected_total"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("n_matches", "n_inliers", "n_map_points"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        assert ((g - w).abs() <= 0.05 * w).all(), f
    assert got.tracking_ok.tolist() == [True, True, True, False]
    for b, (st, img) in enumerate(zip(picked, imgs)):
        assert float(TL.pose_distance(got.T_w_c[b].cpu(), want.T_w_c[b])) < 1e-3
        want_st, _ = TV.step(cfg, CAM, st, img, height=480, width=640)
        assert int(new.rng[b]) == int(want_st.rng)


# ---------------------------------------------------------------------------
# BA and the five-point solver: card against CPU
# ---------------------------------------------------------------------------

CAM = Camera.create(615.0, 615.0, 320.0, 240.0)


def _ba_problem(noise_px=0.5, pose_noise=0.02, pt_noise=0.0, seed=0, W=5, K=64, M=256):
    """W cameras observing M points, as tests/test_ba.py builds its problems."""
    rng = np.random.default_rng(seed)
    pts_gt = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 9, M)], 1)
    T_w_c = np.tile(np.eye(4), (W, 1, 1))
    for w in range(W):
        T_w_c[w, :3, :3] = Rotation.from_euler("yxz", rng.uniform(-0.05, 0.05, 3)).as_matrix()
        T_w_c[w, :3, 3] = [0.1 * w, 0.02 * w, 0.05 * w]
    T_c_w = np.linalg.inv(T_w_c)
    obs_uv = np.zeros((W, K, 2), np.float32)
    obs_pid = np.zeros((W, K), np.int32)
    obs_valid = np.zeros((W, K), bool)
    for w in range(W):
        pid = rng.choice(M, K, replace=False)
        p_c = pts_gt @ T_c_w[w, :3, :3].T + T_c_w[w, :3, 3]
        uv = p_c[:, :2] / p_c[:, 2:3] * 615 + [320, 240]
        obs_uv[w] = uv[pid] + rng.normal(0, noise_px, (K, 2))
        obs_pid[w] = pid
        obs_valid[w] = p_c[pid, 2] > 0.5
    xi = np.concatenate([rng.normal(0, pose_noise, (W, 3)), rng.normal(0, pose_noise / 2, (W, 3))], 1)
    T_init = TL.se3_exp(torch.from_numpy(xi.astype(np.float32))) @ torch.from_numpy(T_c_w).float()
    T_init[3:] = torch.from_numpy(T_c_w[3:]).float()   # a gauge anchor that starts exact
    pt_used = np.zeros(M, bool)
    pt_used[np.unique(obs_pid)] = True
    return TB.BAProblem(
        T_c_w=T_init, obs_uv=torch.from_numpy(obs_uv), obs_pid=torch.from_numpy(obs_pid),
        obs_valid=torch.from_numpy(obs_valid),
        pts=torch.from_numpy((pts_gt + rng.normal(0, pt_noise, pts_gt.shape)).astype(np.float32)),
        pt_used=torch.from_numpy(pt_used), frame_valid=torch.ones(W, dtype=torch.bool))


BA_MODES = {
    "pose_only": (dict(), dict(fix_map_points=True, iterations=20)),
    "joint": (dict(noise_px=0.0, pt_noise=0.05), dict(fix_map_points=False, iterations=30)),
    "regate": (dict(noise_px=0.3, seed=3), dict(fix_map_points=True, iterations=20, regate_px=3.0)),
    "invalid_frames": (dict(seed=1), dict(fix_map_points=True, iterations=20)),
    "huber_outliers": (dict(noise_px=0.3, seed=5), dict(fix_map_points=True, iterations=20)),
}


def _on(prob, dev):
    return TB.BAProblem(*(t.to(dev) for t in prob))


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", sorted(BA_MODES))
def test_ba_solve_on_card_equals_cpu(card, mode, deterministic):
    prob_kw, ba_kw = BA_MODES[mode]
    prob = _ba_problem(**prob_kw)
    if mode == "invalid_frames":
        fv = torch.tensor([True, True, True, False, False])
        prob = prob._replace(frame_valid=fv, obs_valid=prob.obs_valid & fv[:, None])
    if mode == "huber_outliers":
        uv = prob.obs_uv.clone()
        uv[:, ::10] += 50.0
        prob = prob._replace(obs_uv=uv)
    cfg = VOConfig()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, deterministic=deterministic, **ba_kw))
    want = TB.ba_solve(cfg, CAM, prob)
    got = [t.cpu() for t in TB.ba_solve(cfg, CAM, _on(prob, "cuda"))]
    if deterministic:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    else:
        torch.testing.assert_close(got[0][:, :3, 3], want[0][:, :3, 3], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)


def _linked_state(cfg, frame_idx=12, kf_frames=(0, 4, 8, 11), n_pts=48):
    """A state whose ring holds frames 0..frame_idx-1 (pose x = frame id),
    each linking n_pts map points at pixels 0.5 px off their projection."""
    st = TS.init_state(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 2 + frame_idx, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    map_pts, map_valid = st.map.pts.clone(), st.map.valid.clone()
    map_pts[:n_pts], map_valid[:n_pts] = torch.from_numpy(pts), True
    ring, K = st.ring, st.ring.kpts.shape[1]
    for i in range(frame_idx):
        pose = torch.eye(4)
        pose[0, 3] = float(i)
        uv = (pts[:, :2] - [i, 0.0]) / pts[:, 2:3] * 615.0 + [320.0, 240.0]
        kpts = torch.zeros(K, 2)
        kpts[:n_pts] = torch.from_numpy((uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32))
        mp = torch.full((K,), -1, dtype=torch.int32)
        mp[:n_pts] = torch.arange(n_pts, dtype=torch.int32)
        ring = ring.push(i % cfg.map.frame_buffer, pose, kpts, mp, is_kf=i in kf_frames)
    return st._replace(ring=ring, frame_idx=torch.tensor(frame_idx, dtype=torch.int32),
                       T_w_c=pose, map=st.map._replace(pts=map_pts, valid=map_valid))


@pytest.mark.cuda
def test_ba_update_state_on_card_never_waits_on_the_host(card):
    cfg = VOConfig()
    st = _linked_state(cfg)
    want = TB.ba_update_state(cfg, CAM, st)
    st_dev = TS.state_to(st, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TB.ba_update_state(cfg, CAM, st_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f in ("T_w_c", "ref_pose", "last_keyframe_pose"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f), rtol=0, atol=1e-4)
    torch.testing.assert_close(got.ring.poses.cpu(), want.ring.poses, rtol=0, atol=1e-4)
    assert int(got.ba_rejected) == int(want.ba_rejected)


# the BA LM kernel (csrc/ba_lm_pose.cu) at the main path's windows: (W, K,
# which frames are out of the window, whether every observation is invalid);
# W=8 K=1,536 holds more observations than the kernel stages in shared
# memory (float32), so the rest come from global memory
BA_LM_CASES = {
    "W5_K1024": (5, 1024, (), False),
    "W5_K1500": (5, 1500, (), False),
    "W8_K1024": (8, 1024, (), False),
    "W8_K1536": (8, 1536, (), False),
    "W5_K1024_empty_frames": (5, 1024, (1, 4), False),
    "W5_K1024_all_invalid": (5, 1024, (), True),
}


def _ba_lm_case(case, seed=0):
    W, K, empty, invalid = BA_LM_CASES[case]
    prob = _ba_problem(W=W, K=K, M=4096, seed=seed)
    fv = torch.tensor([w not in empty for w in range(W)])
    valid = prob.obs_valid & fv[:, None] & (not invalid)
    return prob._replace(frame_valid=fv, obs_valid=valid)


def _ba_lm_cfg(deterministic=False, **kw):
    cfg = VOConfig()
    return cfg.replace(ba=dataclasses.replace(cfg.ba, deterministic=deterministic, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(BA_LM_CASES))
def test_ba_lm_kernel_equals_plain_version(card, case, deterministic):
    """``ba_solve`` (landmarks fixed: the kernel, one launch) against its
    plain version ``lm_loop`` on the same card tensors: poses within 1e-4
    and costs within 1e-4 relative in float32 (sums in another order), rtol
    1e-6 in float64; out-of-window frames unmoved, and with every
    observation invalid nothing moves and the costs are 0."""
    cfg = _ba_lm_cfg(deterministic)
    prob = _on(_ba_lm_case(case), "cuda")
    launches = TB.ba_lm.ba_lm_pose.launches
    got = TB.ba_solve(cfg, CAM, prob)
    assert TB.ba_lm.ba_lm_pose.launches == launches + 1
    want = TB.lm_loop(cfg.ba, CAM, prob)
    if deterministic:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-6)
    assert got[1] is prob.pts
    out = ~prob.frame_valid
    assert torch.equal(got[0][out], prob.T_c_w[out])
    if BA_LM_CASES[case][3]:
        assert torch.equal(got[0], prob.T_c_w) and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 25])
def test_ba_lm_kernel_under_vmap_equals_its_single_launch(card, batch):
    """``torch.func.vmap`` of ``ba_solve`` is one launch, one block per
    stream; each stream equals its own launch exactly (a block's sums run in
    a fixed order), the re-gate included."""
    cfg = _ba_lm_cfg(regate_px=3.0)
    probs = [_on(_ba_lm_case("W5_K1024", seed=20 + b), "cuda") for b in range(batch)]
    stacked = [torch.stack(f) for f in zip(*probs)]
    launches = TB.ba_lm.ba_lm_pose.launches
    T, _, costs = torch.func.vmap(lambda *f: TB.ba_solve(cfg, CAM, TB.BAProblem(*f)))(*stacked)
    assert TB.ba_lm.ba_lm_pose.launches == launches + 1
    for b, p in enumerate(probs):
        one = TB.ba_solve(cfg, CAM, p)
        assert torch.equal(T[b], one[0]) and torch.equal(costs[b], one[2]), b


@pytest.mark.cuda
def test_ba_lm_wrapper_rejects_what_the_kernel_does_not_take(card):
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm

    cfg = _ba_lm_cfg()
    prob = _on(_ba_lm_case("W5_K1024"), "cuda")
    with pytest.raises(ValueError, match="fix_map_points"):
        ba_lm.ba_lm_pose(dataclasses.replace(cfg.ba, fix_map_points=False), CAM, prob)
    bad = {"device": (ValueError, prob._replace(obs_uv=prob.obs_uv.cpu())),
           "dtype": (TypeError, prob._replace(T_c_w=prob.T_c_w.double())),
           "pid dtype": (TypeError, prob._replace(obs_pid=prob.obs_pid.long())),
           "shape": (ValueError, prob._replace(obs_valid=prob.obs_valid[:, :-1])),
           "contiguity": (ValueError, prob._replace(
               obs_uv=prob.obs_uv.transpose(0, 1).contiguous().transpose(0, 1)))}
    for what, (err, p) in bad.items():
        with pytest.raises(err):
            ba_lm.ba_lm_pose(cfg.ba, CAM, p)
    big = _on(_ba_problem(W=8, K=40000, M=40000), "cuda")
    with pytest.raises(ValueError, match="does not fit"):
        ba_lm.ba_lm_pose(cfg.ba, CAM, big)


@pytest.mark.cuda
def test_ba_lm_kernel_runs_once_per_ba_call_and_per_replay(card):
    """Over 12 frames on the graph route and the eager step, ``ba_lm_pose``
    launches once per ``ba_update_state`` call (counted per replay), and the
    profile of one replayed tracking frame shows the kernel once."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(12, seed=0, translation_step=0.05)
    launches, calls = TB.ba_lm.ba_lm_pose.launches, TB.ba_update_state.calls
    eng, _, _ = _graph_and_eager(cfg, frames[:11])
    assert TB.ba_update_state.calls - calls >= 3
    assert TB.ba_lm.ba_lm_pose.launches - launches == TB.ba_update_state.calls - calls
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.add_frame(frames[11])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("ba_lm_pose" in n for n in names) == 1, len(names)


def _five_point_samples(n=64, nb=32, seed=0):
    """Clean minimal samples of a random two-view scene (normalized plane)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    R = Rotation.from_euler("yxz", rng.uniform(-0.1, 0.1, 3)).as_matrix()
    X2 = X @ R.T + [0.3, 0.05, 0.1]
    x1, x2 = X[:, :2] / X[:, 2:], X2[:, :2] / X2[:, 2:]
    idx = np.stack([rng.choice(n, 5, replace=False) for _ in range(nb)])
    G = rng.normal(size=(nb, 4, 4))
    return torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]), torch.from_numpy(G)


@pytest.mark.cuda
def test_five_point_on_card_equals_cpu(card):
    """float64: in the same remixed basis the card's candidates equal the
    CPU's slot for slot (to 1e-7: near a double root the LU's rounding is
    amplified); with each device's own eigh basis the sets agree up to roots
    one chart misses."""
    x1, x2, G = _five_point_samples()
    A = torch.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
                     x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
                     x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0])], -1)
    basis = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :4]
    basis = basis @ torch.linalg.qr(G).Q
    E_cpu, ok_cpu = TF._candidates(basis)
    E_dev, ok_dev = (t.cpu() for t in TF._candidates(basis.cuda()))
    assert torch.equal(ok_dev, ok_cpu) and ok_cpu.any(1).all()
    mask = ok_cpu[..., None, None]
    torch.testing.assert_close(torch.where(mask, E_dev, 0.0), torch.where(mask, E_cpu, 0.0),
                               rtol=0, atol=1e-7)
    E_cpu, ok_cpu = TF.five_point_essential(x1, x2, G=G)
    E_dev, ok_dev = (t.cpu() for t in TF.five_point_essential(x1.cuda(), x2.cuda(), G=G.cuda()))
    for Ea, oka, Eb, okb in ((E_cpu, ok_cpu, E_dev, ok_dev), (E_dev, ok_dev, E_cpu, ok_cpu)):
        d = []
        for b in range(Ea.shape[0]):
            others = Eb[b][okb[b]]
            for E in Ea[b][oka[b]]:
                dist = torch.minimum((others - E).flatten(1).norm(dim=1),
                                     (others + E).flatten(1).norm(dim=1))
                d.append(float(dist.min()) if len(others) else float("inf"))
        assert np.mean(np.asarray(d) < 1e-6) >= 0.9, sorted(d)[-10:]


@pytest.mark.cuda
def test_checkpoint_on_card_resumes(card, tmp_path):
    """A state saved from the card loads onto the card (every tensor there,
    the key on the CPU) and the next frame from it is the run's: the same
    decisions and counts, poses and keypoints to 1e-4 (BA's atomics)."""
    from monocular_visual_odometry_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(8, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    for f in frames[:-1]:
        eng.add_frame(f)
    save_state(str(tmp_path / "s.npz"), eng.state)
    want = eng.add_frame(frames[-1])
    back = TV.VOEngine(cfg, 480, 640, seed=9, device="cuda")
    back.state = load_state(str(tmp_path / "s.npz"), back.state)
    assert back.state.rng.device.type == "cpu"
    assert back.state.map.pts.device.type == "cuda" and back.state.ring.kpts.is_cuda
    got = back.add_frame(frames[-1])
    for name, g, w in zip(got._fields, got, want):
        if g.is_floating_point():
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0, msg=name)
        else:
            assert torch.equal(g, w), name


def _sync_warnings(fn):
    """(fn(), the synchronizing CUDA calls ``fn`` made), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the first use of the mode also warns that it is a prototype feature)
    return out, sum(str(w.message).startswith("called a synchronizing CUDA operation")
                    for w in caught)


@pytest.mark.cuda
def test_add_frame_reads_the_output_back_with_one_wait(card):
    """After ``step`` returns, the readback of its StepOutput waits on the
    stream once (one ``.cpu()`` per field waited once per field) and returns
    every field with its dtype and value."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(12, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    for f in frames:
        img = torch.from_numpy(f).cuda().float()
        eng.state, out = TV.step(cfg, eng.cam, eng.state, img, height=480, width=640)
        got, n_new = _sync_warnings(lambda: TV.output_to_host(out))
        want, n_old = _sync_warnings(lambda: TS.StepOutput(*(t.cpu() for t in out)))
        assert n_new == 1 and n_old == sum(t.is_cuda for t in out) > 1, (n_new, n_old)
        for name, g, w in zip(got._fields, got, want):
            assert g.device.type == "cpu" and g.dtype == w.dtype and torch.equal(g, w), name
    assert int(out.stage) == TS.STAGE_TRACKING


# ---------------------------------------------------------------------------
# the graph route: VOEngine's stage programs as CUDA graphs
# ---------------------------------------------------------------------------


def _graph_and_eager(cfg, frames):
    """``VOEngine`` (one graph replay per frame) and the eager host-branch
    ``step`` over the same frames: (engine, its outputs, step's outputs)."""
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    got = [eng.add_frame(f) for f in frames]
    st, want = TS.init_state(cfg, 0, "cuda"), []
    for f in frames:
        st, out = TV.step(cfg, eng.cam, st, torch.from_numpy(f).float().cuda(), height=480,
                          width=640)
        want.append(TV.output_to_host(out))
    return eng, got, want


@pytest.mark.cuda
def test_graph_route_equals_eager_step(card):
    """12 frames (init at frame 6, then tracking): every stage, keyframe and
    tracking decision and count of the graph route equal the eager step's,
    poses within 1e-4 (pose_distance); one replay per frame, the kernel's
    launches counted per replay (2 per tracking frame, 1 per init attempt)
    and BA once per tracking frame."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(12, seed=0, translation_step=0.05)
    launches, calls = TH.hamming_nn_top2.launches, TB.ba_update_state.calls
    eng, got, want = _graph_and_eager(cfg, frames)
    stages = [TS.STAGE_BLANK] + [int(o.stage) for o in got[:-1]]
    n_track = stages.count(TS.STAGE_TRACKING)
    assert n_track >= 3 and eng.captured_stages == (0, 1, 2)
    for g, w in zip(got, want):
        for f in ("stage", "is_keyframe", "tracking_ok", "n_keypoints", "n_matches",
                  "n_inliers", "n_map_points", "n_candidates"):
            assert int(getattr(g, f)) == int(getattr(w, f)), f
        assert float(TL.pose_distance(g.T_w_c, w.T_w_c)) <= 1e-4
    progs = eng.stages.programs
    assert sum(p.replays for p in progs.values()) == len(frames)
    assert progs[TS.STAGE_TRACKING].per_call == {"hamming_nn_top2": 2, "ba_lm_pose": 1,
                                                 "ba_update_state": 1, "ba_update_state_dist": 0}
    # the eager run added its own: 1 per init attempt, 1 + is_keyframe per
    # tracking frame, BA where tracking held
    eager_launches = sum({0: 0, 1: 1}.get(s, 1 + int(bool(o.is_keyframe)))
                         for s, o in zip(stages, want))
    eager_ba = sum(s == TS.STAGE_TRACKING and bool(o.tracking_ok) for s, o in zip(stages, want))
    graph_launches = stages.count(TS.STAGE_INITIALIZING) + 2 * n_track
    assert TH.hamming_nn_top2.launches - launches == graph_launches + eager_launches
    assert TB.ba_update_state.calls - calls == n_track + eager_ba


@pytest.mark.cuda
def test_five_point_init_captured_equals_eager_on_card(card):
    """The five-point configuration: every stage a graph (the init's
    ``eigh`` is the Jacobi there), one replay per frame, and every decision
    and count equal to the eager step's over 14 frames, poses within 1e-4;
    the init program's replay reads nothing back."""
    cfg = VOConfig()
    cfg = cfg.replace(ransac=dataclasses.replace(cfg.ransac, essential_minimal="5pt"))
    frames, _ = TSYN.render_sequence_arrays(14, seed=0, translation_step=0.05)
    eng, got, want = _graph_and_eager(cfg, frames)
    assert eng.captured_stages == (0, 1, 2)
    progs = eng.stages.programs
    assert sum(p.replays for p in progs.values()) == len(frames)
    assert progs[TS.STAGE_INITIALIZING].replays >= 2
    for g, w in zip(got, want):
        for f in ("stage", "is_keyframe", "tracking_ok", "used_homography", "n_matches",
                  "n_inliers", "n_map_points"):
            assert int(getattr(g, f)) == int(getattr(w, f)), f
        assert float(TL.pose_distance(g.T_w_c, w.T_w_c)) <= 1e-4
    assert int(got[-1].stage) == TS.STAGE_TRACKING
    st = TS.init_state(cfg, 0, "cuda")
    for f in frames[:2]:
        st, _ = TV.step(cfg, eng.cam, st, torch.from_numpy(f).float().cuda(), height=480,
                        width=640)
    img = torch.from_numpy(frames[2]).float().cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.stages(st, img, TS.STAGE_INITIALIZING, int(st.rng))
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_graph_route_waits_once_per_frame(card):
    """After each stage's capture, a frame through ``add_frame`` (upload,
    draws, copies in, replay, readback) waits on the stream once."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(12, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    for f in frames[:9]:
        eng.add_frame(f)
    waits = [_sync_warnings(lambda f=f: eng.add_frame(f))[1] for f in frames[9:]]
    assert waits == [1, 1, 1]


@pytest.mark.cuda
def test_a_replay_of_the_tracking_graph_runs_the_kernel(card):
    """The profile of one replayed tracking frame shows ``hamming_nn_top2``
    twice (tracking and the keyframe update)."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(10, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda")
    for f in frames[:9]:
        eng.add_frame(f)
    assert eng.stages.programs[TS.STAGE_TRACKING].replays >= 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.add_frame(frames[9])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("hamming_nn_top2" in n for n in names) == 2, len(names)


@pytest.mark.cuda
def test_span_markers_time_a_replay_in_stream_order(card):
    """With spans on, one replayed tracking frame shows its marker kernels
    in a profile, none overlapping another kernel, the matcher's two
    launches inside the match and keyframe spans; the slots' spans
    (``%globaltimer``) add up to the profile's time from the first marker to
    the last."""
    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(10, seed=0, translation_step=0.05)
    with LG.spans(True):
        eng = TV.VOEngine(cfg, 480, 640, device="cuda")
        for f in frames[:9]:
            eng.add_frame(f)
        assert eng._stage == TS.STAGE_TRACKING
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(256):   # a profile may lose the device records at its start
                torch.cuda._sleep(100)
            eng.add_frame(frames[9])
            torch.cuda.synchronize()
        spans = LG.last_marks()
    ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.name())
    marks = [(a, b) for a, b, n in ev if "span_mark" in n]
    assert list(spans) == list(TV.TRACK_SPANS) and len(marks) == len(spans) + 1
    others = [(a, b) for a, b, n in ev if "span_mark" not in n]
    assert not [m for m in marks for o in others if o[0] < m[1] and m[0] < o[1]]
    ham = [a for a, _, n in ev if "hamming_nn_top2" in n]
    assert len(ham) == 2
    assert marks[1][0] < ham[0] < marks[2][0] and marks[4][0] < ham[1] < marks[5][0]
    between = (marks[-1][0] - marks[0][0]) / 1e6
    assert sum(spans.values()) == pytest.approx(between, rel=0.02, abs=0.05)


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL world over a file store, and its ``points`` mesh."""
    import torch.distributed as dist

    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

    PM.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", timeout_s=120.0)
    try:
        yield PM.points_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["pose_only", "joint", "regate"])
def test_dist_ba_solve_one_rank_on_card_equals_ba_solve(nccl_mesh, mode, deterministic):
    """The sharded LM in a one-rank NCCL world against ``ba_solve``, both on
    the card: poses and points within 1e-4 in float32, rtol 1e-6 in float64
    (ROADMAP §3 item 9: the scatter-adds are atomics on the card)."""
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    prob_kw, ba_kw = BA_MODES[mode]
    prob = _on(_ba_problem(**prob_kw), "cuda")
    cfg = VOConfig()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, deterministic=deterministic, **ba_kw))
    want = [t.cpu() for t in TB.ba_solve(cfg, CAM, prob)]
    got = [t.cpu() for t in dist_ba.dist_ba_solve(cfg, CAM, nccl_mesh, prob)]
    if deterministic:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    else:
        torch.testing.assert_close(got[0][:, :3, 3], want[0][:, :3, 3], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fix_map_points", [True, False], ids=["fixed", "joint"])
def test_mesh_route_ba_never_waits_on_the_host(nccl_mesh, fix_map_points):
    """One ``ba_update_state_dist`` in a one-rank NCCL world under
    ``set_sync_debug_mode("error")``: neither the LM nor its collectives read
    a value back (the first call, which sets up the communicator, runs
    before); the state equals ``ba_update_state``'s to 1e-4."""
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    cfg = VOConfig()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, fix_map_points=fix_map_points))
    st = TS.state_to(_linked_state(cfg), "cuda")
    want = TB.ba_update_state(cfg, CAM, st)
    dist_ba.ba_update_state_dist(cfg, CAM, nccl_mesh, st)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dist_ba.ba_update_state_dist(cfg, CAM, nccl_mesh, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f in ("T_w_c", "ref_pose", "last_keyframe_pose"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f).cpu(), rtol=0,
                                   atol=1e-4)
    torch.testing.assert_close(got.ring.poses.cpu(), want.ring.poses.cpu(), rtol=0, atol=1e-4)
    torch.testing.assert_close(got.map.pts.cpu(), want.map.pts.cpu(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mesh_route_captured_equals_eager_on_card(nccl_mesh):
    """``VOEngine(mesh=...)`` in a one-rank NCCL world: every stage a graph,
    the tracking graph replaying the sharded BA's collectives; one replay
    per frame, ``ba_update_state_dist`` once per tracking frame, the same
    collectives on each frame as the eager ``step(mesh=...)`` and every
    decision equal, poses within 1e-4 over 12 frames."""
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    cfg = VOConfig()
    frames, _ = TSYN.render_sequence_arrays(12, seed=0, translation_step=0.05)
    eng = TV.VOEngine(cfg, 480, 640, device="cuda", mesh=nccl_mesh)
    calls = dist_ba.ba_update_state_dist.calls
    got, got_rec = [], []
    for f in frames:
        n = len(nccl_mesh.record)
        got.append(eng.add_frame(f))
        got_rec.append(nccl_mesh.record[n:])
    graph_calls = dist_ba.ba_update_state_dist.calls - calls
    st, want, want_rec = TS.init_state(cfg, 0, "cuda"), [], []
    for f in frames:
        n = len(nccl_mesh.record)
        st, out = TV.step(cfg, eng.cam, st, torch.from_numpy(f).float().cuda(), height=480,
                          width=640, mesh=nccl_mesh)
        want.append(TV.output_to_host(out))
        want_rec.append(nccl_mesh.record[n:])
    assert eng.captured_stages == (0, 1, 2)
    assert sum(p.replays for p in eng.stages.programs.values()) == len(frames)
    stages = [TS.STAGE_BLANK] + [int(o.stage) for o in got[:-1]]
    n_track = stages.count(TS.STAGE_TRACKING)
    assert n_track >= 3 and graph_calls == n_track
    assert got_rec == want_rec and all(bool(r) == (s == TS.STAGE_TRACKING)
                                       for r, s in zip(got_rec, stages))
    for g, w in zip(got, want):
        for f in ("stage", "is_keyframe", "tracking_ok", "n_matches", "n_inliers",
                  "n_map_points"):
            assert int(getattr(g, f)) == int(getattr(w, f)), f
        assert float(TL.pose_distance(g.T_w_c, w.T_w_c)) <= 1e-4


@pytest.mark.cuda
def test_a_failed_capture_raises(card):
    """A program that reads a value back cannot be captured: the first call
    raises, and there is no eager fallback. (Last in the file: a failed
    capture can leave the CUDA context in an error state.)"""
    from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep

    prog = CapturedStep(lambda st, x: (st * float(x.sum()), x))
    with pytest.raises(RuntimeError):
        prog(torch.ones(4, device="cuda"), torch.ones(4, device="cuda"))
    torch.cuda.synchronize()
