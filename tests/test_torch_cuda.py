"""The CUDA matcher kernel against its plain PyTorch version, and BA and the
five-point solver on the card against the same calls on the CPU.

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

BA's scatter-adds are atomics on the card, so float32 sums differ from the
CPU's in the last bits: poses agree to 1e-4, and with ``deterministic=True``
(float64) to float32 rounding (rtol 1e-6). The five-point solver is compared
in float64, as a solution set (see ``test_torch_fivepoint.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.ops import fivepoint as TF
from monocular_visual_odometry_tpu_torch.ops import lie as TL
from monocular_visual_odometry_tpu_torch.ops import matching as TM
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH
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
