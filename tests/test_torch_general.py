"""The port's general multi-stream step (``step_general_batched``,
``run_sequences_general``: B streams in any stage under one
``torch.func.vmap``), its branch-free init stage and the staged route
``VOEngine(fused=False)``, on the CPU.

Against the port's own single-stream ``step`` the draws are the same (each
stream's come from its key as ``step`` splits it), so the results agree up
to the rounding of the batched ops: one mixed-stage step within 1e-5
(poses), the stages, keyframe and tracking decisions, counts and next keys
equal; a whole 10-frame run from fresh states within 1e-4 (poses), every
decision and key equal. The init pose sets the budget: under vmap the 3x3
products of the E and H decompositions round differently (6e-8), and the
Sampson LM that refines the candidates carries that to ~3e-6 (a
first-frame or tracking pose lands within 1e-7). The branch-free init
equals the host-branch form it replaces field for field, and the staged
route equals the fused one.

Against JAX the random draws differ, so the first-frame outputs (computed
before any draw) are compared exactly, both packages stay initializing
until the first of them initializes, every stream tracks by the end and
the Sim(3) ATE lands within max(0.02, half JAX's): the band of
``test_torch_batched.py``. From one converted JAX state with JAX's frame
features and JAX's own minimal sets, the init stage matches JAX's: the same
decision, matches and inliers, pose within 1e-3.

Every test runs with vmap's slow fallback off (an op without a batch rule
raises) and one torch thread.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models import vo as JV
from monocular_visual_odometry_tpu.ops import features as JF
from monocular_visual_odometry_tpu.ops import matching as JM
from monocular_visual_odometry_tpu.ops import ransac as JR
from monocular_visual_odometry_tpu.ops.camera import Camera as JCamera
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops import lie as tlie
from monocular_visual_odometry_tpu_torch.ops import twoview as TT
from monocular_visual_odometry_tpu_torch.ops.features import FrameFeatures
from monocular_visual_odometry_tpu_torch.ops.ransac import split_key
from monocular_visual_odometry_tpu_torch.utils import metrics as tmetrics

H, W = 480, 640
N = 10                  # frames per stream: initializing from frame 1, tracking from 6
STEP_TOL = 1e-5         # one mixed-stage step against step, poses
RUN_TOL = 1e-4          # a whole run against step runs, poses
INIT_JAX_TOL = 1e-3     # the init stage against JAX's on the same inputs, pose


def _small_cfg():
    """The capacity-reduced config of tests/test_torch_batched.py, BA on."""
    cfg = JConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, enabled=True),
    )


CFG = convert.config_to_torch(dataclasses.asdict(_small_cfg()))
CAM = TV.VOEngine(CFG, H, W, device="cpu").cam


@pytest.fixture(scope="module", autouse=True)
def no_vmap_fallback():
    """vmap's slow fallback off; one intra-op thread (see test_torch_batched.py)."""
    was, threads = torch._C._functorch._is_vmap_fallback_enabled(), torch.get_num_threads()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    torch.set_num_threads(1)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(was)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sequences():
    """Two rendered sequences (seeds 0 and 1): frames [2,N,H,W], poses [2,N,4,4]."""
    runs = [tsyn.render_sequence_arrays(N, seed=s, translation_step=0.05) for s in (0, 1)]
    return np.stack([f for f, _ in runs]), np.stack([g for _, g in runs])


def _frame(a):
    return torch.from_numpy(np.asarray(a)).float()


@pytest.fixture(scope="module")
def singles(sequences):
    """Per stream b (key b): ``VOEngine`` (the fused route, ``step``) over its
    frames from a fresh state; [(state after the frame, output)]."""
    frames, _ = sequences
    out = []
    for b, seq in enumerate(frames):
        eng = TV.VOEngine(CFG, H, W, seed=b, device="cpu")
        run = []
        for f in seq:
            o = eng.add_frame(f)
            run.append((eng.state, o))
        assert [int(o.stage) for _, o in run] == [1] * 6 + [2] * 4
        out.append(run)
    return out


def _assert_equal(got, want, what=""):
    """Every tensor of two records equal, dtype and value."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _assert_equal(getattr(got, f), getattr(want, f), f"{what}.{f}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), what


def _column(outs, f, b):
    """Stream b's ``f`` over a run's steps ([N,B] outputs), as ints."""
    return [int(v) for v in getattr(outs, f)[:, b]]


def _assert_decisions_equal(got, want):
    for f in ("stage", "is_keyframe", "tracking_ok", "n_matches", "n_inliers",
              "n_map_points", "n_keypoints", "ba_rejected_total"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f


# ---------------------------------------------------------------------------
# the init stage's draws and its branch-free form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("minimal", ["8pt", "5pt"])
def test_relative_pose_draws_made_outside_equal_the_key(minimal):
    """``draw_general``'s init draws for a stream with key r, handed in as
    ``u_e`` / ``u_h`` (/ ``G_e``), give what the key ``k_est`` (r's first
    split's second child) gives alone."""
    cfg = CFG.replace(orb=dataclasses.replace(CFG.orb, max_keypoints=256),
                      ransac=dataclasses.replace(CFG.ransac, n_hypotheses=64,
                                                 essential_minimal=minimal))
    sc = tsyn.synthesize_two_view(n=200, seed=3, noise_px=0.5, outlier_frac=0.1)
    uv1, uv2 = (torch.zeros(256, 2) for _ in range(2))
    uv1[:200], uv2[:200] = torch.from_numpy(sc.uv1), torch.from_numpy(sc.uv2)
    valid = torch.arange(256) < 200
    r = 98765
    d = TV.draw_general(cfg, torch.tensor([r]), "cpu")
    assert (d.init_G is not None) == (minimal == "5pt")
    kw = dict(n_hypotheses=64, essential_minimal=minimal)
    want = TT.estimate_relative_pose(uv1, uv2, valid, CAM, split_key(r)[1], **kw)
    got = TT.estimate_relative_pose(uv1, uv2, valid, CAM, None, u_e=d.init_e[0],
                                    u_h=d.init_h[0],
                                    G_e=None if d.init_G is None else d.init_G[0], **kw)
    _assert_equal(got, want)
    assert int(got.inliers.sum()) > 120


def test_five_point_general_program_is_captured_and_equals_the_body(singles, sequences,
                                                                    monkeypatch):
    """The general batched program under the five-point solver is a graph on
    a card too (``CapturedStep(graph=True)``; here it runs on its buffers).
    One mixed step (a succeeding init attempt, tracking) on the card's route
    (``lie.card_route`` forced: Jacobi ``eigh`` under vmap with the slow
    fallback off) through ``step_general_batched`` equals the eager vmapped
    body on the same draws, field by field."""
    cfg = CFG.replace(ransac=dataclasses.replace(CFG.ransac, essential_minimal="5pt"))
    states, imgs = _mixed(singles, sequences)
    picked = [2, 3]
    sts = TS.stack_states([states[i] for i in picked])
    imgs = torch.from_numpy(np.stack([imgs[i] for i in picked])).float()
    monkeypatch.setattr(tlie, "card_route", lambda t: True)
    draws = TV.draw_general(cfg, sts.rng, "cpu")
    new, out = TV.step_general_batched(cfg, CAM, sts, imgs, height=H, width=W, draws=draws)
    prog = TV._batched_program("general", cfg, CAM, len(picked), H, W, "cpu")
    assert prog.graph and prog.calls == 1
    want_st, want = TV.general_batched_body(cfg, CAM, sts, imgs, draws, height=H, width=W)
    _assert_equal(out, want)
    for f in want_st._fields:
        if f != "rng":   # the body leaves the keys to the host
            _assert_equal(getattr(new, f), getattr(want_st, f), f)
    assert out.stage.tolist() == [2, 2] and out.tracking_ok.tolist() == [True] * 2


def _host_branch_init(cfg, cam, st, img):
    """The init stage as the port ran it before it was made branch-free:
    the quality gate read back on the host, then one branch or the other."""
    dev = img.device
    feats = TV.features_from_config(img, cfg.orb)
    rng, k_est = TV._next_key(st)
    ref = st.ref_feats
    m = TV._match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts, feats.kpts,
                  cfg.match.max_pixel_dist_init)
    tv = TT.estimate_relative_pose(
        ref.kpts[m.query_idx], feats.kpts[m.train_idx], m.valid, cam, k_est,
        threshold_px=cfg.ransac.threshold_px, n_hypotheses=cfg.ransac.n_hypotheses,
        use_reference_selection=cfg.init.use_reference_selection,
        essential_minimal=cfg.ransac.essential_minimal)
    T_2_1 = tlie.rt_to_T(tv.R, tv.t)
    angles = TT.triangulation_angles(tv.pts3d_c1, T_2_1)
    good = TV._angle_filter(angles, tv.inliers, cfg)
    n_good = torch.sum(good)
    mean_disp = TV.matching.mean_pixel_displacement(ref.kpts, feats.kpts,
                                                    m._replace(valid=good))
    is_good = bool((n_good >= cfg.init.min_inlier_matches)
                   & (mean_disp > cfg.init.min_pixel_dist)
                   & (TV._masked_median(angles, good)
                      > cfg.init.min_median_triang_angle_deg * TV._DEG))
    k = cfg.orb.max_keypoints
    no_links = torch.full((k,), -1, dtype=torch.int32, device=dev)
    if is_good:
        pts_c2 = tlie.transform_points(T_2_1, tv.pts3d_c1)
        mean_depth = (torch.sum(torch.where(good, pts_c2[:, 2], torch.zeros_like(angles)))
                      / torch.clamp(n_good, min=1))
        scale = cfg.init.assumed_mean_depth / torch.clamp(mean_depth, min=1e-6)
        T_w_c2 = st.ref_pose @ tlie.inv_T(tlie.rt_to_T(tv.R, tv.t * scale))
        pts_w = tlie.transform_points(st.ref_pose, tv.pts3d_c1 * scale)
        new_map, slots = TS.insert_map_points(
            st.map, pts_w, feats.desc[m.train_idx], TV._unit_normals(pts_w, T_w_c2[:3, 3]),
            good, frame_idx=st.frame_idx, gray=feats.gray[m.train_idx])
        curr_mp = TV.scatter_links(no_links, m.train_idx,
                                   torch.where(good, slots, torch.full_like(slots, -1)))
        pose_out = T_w_c2
        new = TS.push_keyframe(st._replace(
            stage=torch.tensor(TS.STAGE_TRACKING, dtype=torch.int32), T_w_c=T_w_c2,
            ref_feats=feats, ref_pose=T_w_c2, ref_mp_idx=curr_mp, ref_frame_idx=st.frame_idx,
            last_keyframe_pose=T_w_c2, map=new_map), T_w_c2)
        kpt_inlier = TV.scatter_links(torch.zeros(k, dtype=torch.bool), m.train_idx, good)
    else:
        curr_mp, pose_out = no_links, st.ref_pose
        new = st._replace(T_w_c=st.ref_pose)
        kpt_inlier = torch.zeros(k, dtype=torch.bool)
    ring = st.ring.push(st.frame_idx % cfg.map.frame_buffer, pose_out, feats.kpts, curr_mp,
                        is_kf=is_good)
    new = new._replace(frame_idx=st.frame_idx + 1, ring=ring, rng=rng)
    out = TS.StepOutput(
        T_w_c=pose_out, stage=new.stage, n_keypoints=feats.n_valid, n_matches=m.n_valid,
        n_inliers=n_good.to(torch.int32), is_keyframe=torch.tensor(is_good),
        tracking_ok=torch.tensor(True), used_homography=tv.used_homography,
        n_map_points=new.map.n_valid, kpts=feats.kpts, kpt_valid=feats.valid,
        kpt_inlier=kpt_inlier, ba_rejected_total=st.ba_rejected,
        n_candidates=torch.tensor(0, dtype=torch.int32))
    return new, out


@pytest.mark.parametrize("attempt", ["failing", "succeeding"])
def test_branch_free_init_equals_the_host_branch(attempt, singles, sequences):
    """A failing attempt (frame 1 against frame 0) and a succeeding one
    (frame 6): every field of the state, the map included, and of the
    output equal."""
    frames, _ = sequences
    b, i = (0, 1) if attempt == "failing" else (1, 6)
    st, img = singles[b][i - 1][0], _frame(frames[b, i])
    got_st, got = TV.step_init(CFG, CAM, st, img)
    want_st, want = _host_branch_init(CFG, CAM, st, img)
    assert bool(got.is_keyframe) == (attempt == "succeeding")
    _assert_equal(got_st, want_st)
    _assert_equal(got, want)


def _svd_cases():
    """3x3 matrices of the kinds the init factors: Gaussian, essential
    (singular values 1, 1, 0) with and without noise, near-rotation
    homographies, ill-conditioned, rank 1 and zero."""
    g = torch.Generator().manual_seed(0)
    n = 4000
    Q1, Q2 = (torch.linalg.qr(torch.randn(n, 3, 3, generator=g)).Q for _ in range(2))
    with_s = lambda s: (Q1 * torch.tensor(s)) @ Q2.mT
    ess = with_s([1.0, 1.0, 0.0])
    rank1 = torch.randn(n, 3, 1, generator=g) @ torch.randn(n, 1, 3, generator=g)
    return {"gaussian": torch.randn(n, 3, 3, generator=g), "essential": ess,
            "essential_noisy": ess + 1e-4 * torch.randn(n, 3, 3, generator=g),
            "near_rotation": with_s([1.02, 1.0, 0.99]), "ill_conditioned": with_s([3.0, 1e-3, 1e-6]),
            "rank_1": rank1, "zero": torch.zeros(4, 3, 3)}


@pytest.mark.parametrize("kind", sorted(_svd_cases()))
def test_jacobi_svd_matches_lapack(kind):
    """``lie.svd3_jacobi`` (the card's factorization, plain tensor ops, here
    on the CPU) against LAPACK's: U and V orthonormal and U S V' = M to
    2e-6 of the largest singular value, the singular values to 1e-6 of it."""
    M = _svd_cases()[kind]
    U, S, Vt = tlie.svd3_jacobi(M)
    S0 = torch.linalg.svdvals(M.double())
    scale = S0[:, :1].clamp(min=1e-30)
    eye = torch.eye(3, dtype=torch.float64)
    assert float(((U.double().mT @ U.double()) - eye).abs().max()) < 2e-6
    assert float(((Vt.double() @ Vt.double().mT) - eye).abs().max()) < 2e-6
    rec = (U.double() * S.double()[:, None, :]) @ Vt.double()
    assert float(((rec - M.double()).abs() / scale[:, :, None]).max()) < 2e-6
    assert float(((S.double() - S0).abs() / scale).max()) < 1e-6


def test_pyramid_taps_are_the_interpolation_matrices():
    """The card's pyramid (two taps per output) uses exactly the weights of
    the CPU's interpolation matrices, and on the CPU lands within a few ulps
    of their product."""
    from monocular_visual_odometry_tpu_torch.ops import features as TF
    for n_out, n_in in ((400, 480), (533, 640), (333, 400), (3, 7), (5, 5)):
        A = TF._interp_matrix(n_out, n_in)
        j0, j1, w0, w1 = TF._taps(A)
        back = np.zeros_like(A)
        np.add.at(back, (np.arange(n_out), j0), w0)
        np.add.at(back, (np.arange(n_out), j1), w1)
        np.testing.assert_array_equal(back, A)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (480, 640)).astype(np.float32))
    c = TF._atlas_constants(480, 640, 4, 1.2, 16, "cpu")
    (Ar, AcT), ((j0, j1, w0, w1), (k0, k1, v0, v1)) = c["resize"][0], c["taps"][0]
    y = x[j0] * w0[:, None] + x[j1] * w1[:, None]
    torch.testing.assert_close(y[:, k0] * v0 + y[:, k1] * v1, Ar @ x @ AcT, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the staged route
# ---------------------------------------------------------------------------


def test_staged_route_equals_fused_route(singles, sequences):
    """``VOEngine(fused=False)`` (the stage entry points one after another)
    gives every output field of the fused route over the 10 frames."""
    frames, _ = sequences
    eng = TV.VOEngine(CFG, H, W, seed=0, device="cpu", fused=False)
    for f, (st, want) in zip(frames[0], singles[0]):
        _assert_equal(eng.add_frame(f), want)
    _assert_equal(eng.state, st)


def test_staged_route_refuses_a_mesh():
    with pytest.raises(ValueError, match="fused"):
        TV.VOEngine(CFG, H, W, device="cpu", fused=False, mesh=object())


# ---------------------------------------------------------------------------
# the general step against step
# ---------------------------------------------------------------------------


def _mixed(singles, sequences):
    """Five streams, one in each situation, and their frames: blank (frame
    0), initializing with a failing attempt (frame 1) and a succeeding one
    (frame 6), tracking (frame 8), tracking on a blank frame (fails)."""
    frames, _ = sequences
    blank = np.zeros_like(frames[0, 0])
    states = [TS.init_state(CFG, 0, "cpu"), singles[0][0][0], singles[1][5][0],
              singles[0][7][0], singles[1][7][0]]
    imgs = [frames[0, 0], frames[0, 1], frames[1, 6], frames[0, 8], blank]
    return states, imgs


def test_one_mixed_stage_step_equals_step_per_stream(singles, sequences):
    states, imgs = _mixed(singles, sequences)
    new, out = TV.step_general_batched(CFG, CAM, TS.stack_states(states),
                                       torch.from_numpy(np.stack(imgs)), height=H, width=W)
    for b, (st, img) in enumerate(zip(states, imgs)):
        want_st, want = TV.step(CFG, CAM, st, _frame(img), height=H, width=W)
        got = TS.StepOutput(*(t[b] for t in out))
        _assert_decisions_equal(got, want)
        torch.testing.assert_close(got.T_w_c, want.T_w_c, rtol=0, atol=STEP_TOL)
        torch.testing.assert_close(new.T_w_c[b], want_st.T_w_c, rtol=0, atol=STEP_TOL)
        assert int(new.stage[b]) == int(want_st.stage)
        assert int(new.rng[b]) == int(want_st.rng), b
    assert out.stage.tolist() == [1, 1, 2, 2, 2]
    assert out.is_keyframe[:3].tolist() == [True, False, True]
    assert out.tracking_ok.tolist() == [True, True, True, True, False]


@pytest.fixture(scope="module")
def general_runs(sequences):
    """``run_sequences_general`` from fresh states keyed 0..B-1, B = 1, 2."""
    frames, _ = sequences
    return {nb: TV.run_sequences_general(
        CFG, CAM, TS.stack_states([TS.init_state(CFG, b, "cpu") for b in range(nb)]),
        frames[:nb], height=H, width=W) for nb in (1, 2)}


@pytest.mark.parametrize("nb", [1, 2])
def test_general_run_equals_single_stream_runs(nb, general_runs, singles):
    final, outs = general_runs[nb]
    assert outs.T_w_c.shape == (N, nb, 4, 4)   # scan-major, as run_sequences_batched
    for b in range(nb):
        run = singles[b]
        want = torch.stack([o.T_w_c for _, o in run])
        torch.testing.assert_close(outs.T_w_c[:, b], want, rtol=0, atol=RUN_TOL)
        for f in ("stage", "is_keyframe", "tracking_ok"):
            assert _column(outs, f, b) == [int(getattr(o, f)) for _, o in run], f
        assert int(final.rng[b]) == int(run[-1][0].rng)
        assert int(final.stage[b]) == TS.STAGE_TRACKING


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


def test_general_body_reads_nothing_back(singles, sequences):
    """Streams blank, initializing and tracking: the body issues no readback
    (``_local_scalar_dense``, ``nonzero``), no tensor built from host data
    (``lift_fresh``) and no copy between devices, and one BA for the batch."""
    states, imgs = _mixed(singles, sequences)
    sts = TS.stack_states([states[0], states[1], states[3]])
    draws = TV.draw_general(CFG, sts.rng, "cpu")
    imgs = torch.from_numpy(np.stack([imgs[0], imgs[1], imgs[3]])).float()
    calls = TB.ba_update_state.calls
    with _Ops() as mode:
        TV.general_batched_body(CFG, CAM, sts, imgs, draws, height=H, width=W)
    assert TB.ba_update_state.calls == calls + 1
    found = {k: mode.ops[k] for k in ("_local_scalar_dense.default", "nonzero.default",
                                      "lift_fresh.default", "_to_copy to another device")}
    assert sum(found.values()) == 0, found


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


JCFG = _small_cfg()
JCAM = JCamera.create(615.0, 615.0, 320.0, 240.0)


@pytest.fixture(scope="module")
def jax_general(sequences):
    """JAX's ``vmap(run_sequence)`` from ``vmap(init_state)`` over both
    sequences, as ``profile_throughput.py`` runs its general protocol."""
    frames, _ = sequences

    @jax.jit
    def run(f):
        st0 = jax.vmap(lambda i: JS.init_state(JCFG, seed=i))(jnp.arange(f.shape[0]))
        return jax.vmap(lambda s, x: JV.run_sequence(JCFG, JCAM, s, x, height=H, width=W))(
            st0, f)

    return jax.device_get(run(jnp.asarray(frames.astype(np.float32))))


def test_general_run_against_jax(sequences, general_runs, jax_general):
    _, gt = sequences
    _, outs = general_runs[2]
    _, outs_j = jax_general
    for f in ("stage", "n_keypoints", "n_matches", "n_inliers", "n_map_points",
              "is_keyframe", "tracking_ok", "T_w_c"):   # frame 0: nothing drawn yet
        np.testing.assert_array_equal(getattr(outs, f)[0].numpy(), getattr(outs_j, f)[:, 0],
                                      err_msg=f)
    for b in range(2):
        st_t, st_j = _column(outs, "stage", b), [int(s) for s in outs_j.stage[b]]
        first = min(st_t.index(TS.STAGE_TRACKING), st_j.index(JS.STAGE_TRACKING))
        assert st_t[:first] == st_j[:first] == [TS.STAGE_INITIALIZING] * first
        assert st_t[-1] == st_j[-1] == TS.STAGE_TRACKING
        ate_t = tmetrics.ate_rmse(outs.T_w_c[:, b].numpy().astype(np.float64), gt[b])
        ate_j = tmetrics.ate_rmse(np.asarray(outs_j.T_w_c[b], np.float64), gt[b])
        assert abs(ate_t - ate_j) <= max(0.02, 0.5 * ate_j), (ate_t, ate_j)


def _uniforms_for(idx: np.ndarray, k: int) -> torch.Tensor:
    """Uniforms [n, k] from which ``sample_minimal_sets`` draws exactly the
    index sets ``idx`` [n, s], in their order (each set's entries rank
    first, in sequence; every other entry draws 0)."""
    u = torch.zeros(idx.shape[0], k)
    rank = 1.0 - torch.arange(idx.shape[1], dtype=torch.float32) / (2 * idx.shape[1])
    u.scatter_(1, torch.from_numpy(idx.astype(np.int64)), rank.expand(idx.shape))
    return u


@pytest.fixture(scope="module")
def jax_init(sequences):
    """JAX's first frame of sequence 0 (an initializing state), the init
    attempt on frame 6 from it, the frame's features and the minimal sets
    that attempt drew."""
    frames, _ = sequences
    f0, f6 = (jnp.asarray(frames[0, i].astype(np.float32)) for i in (0, 6))
    st1, _ = JV.step_first(JCFG, JCAM, JS.init_state(JCFG, seed=0), f0)
    st2, out = JV.step_init(JCFG, JCAM, st1, f6)
    feats = JF.features_from_config(f6, JCFG.orb)
    ref = st1.ref_feats
    m = JM.match_features(ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts, feats.kpts,
                          method=JCFG.match.method_index,
                          max_pixel_dist=JCFG.match.max_pixel_dist_init,
                          xiang_gao_ratio=JCFG.match.xiang_gao_match_ratio,
                          lowe_ratio=JCFG.match.lowe_dist_ratio,
                          ambiguity_ratio=JCFG.match.method3_ambiguity_ratio)
    _, k_est = jax.random.split(st1.rng)
    k_e, k_h = jax.random.split(k_est)
    n = JCFG.ransac.n_hypotheses
    idx_e = JR.sample_minimal_sets(k_e, m.valid, n, 8)
    idx_h = JR.sample_minimal_sets(k_h, m.valid, n, 4)
    return jax.device_get((st1, st2, out, feats, idx_e, idx_h))


def test_init_stage_against_jax_with_its_samples(jax_init, sequences):
    """The port's ``step_init`` from JAX's state converted, on JAX's frame
    features, with JAX's minimal sets (as uniforms that draw them)."""
    frames, _ = sequences
    st1, st2_j, out_j, feats_j, idx_e, idx_h = jax_init
    st = convert.state_from_numpy(st1._asdict(), device="cpu")
    feats = FrameFeatures(*(torch.from_numpy(np.array(f)) for f in feats_j))
    k = CFG.orb.max_keypoints
    new, out = TV.step_init(CFG, CAM, st, _frame(frames[0, 6]),
                            u_e=_uniforms_for(np.asarray(idx_e), k),
                            u_h=_uniforms_for(np.asarray(idx_h), k), feats=feats)
    assert bool(out_j.is_keyframe) and bool(out.is_keyframe)
    for f in ("stage", "n_matches", "n_inliers", "used_homography", "n_map_points"):
        assert int(getattr(out, f)) == int(getattr(out_j, f)), f
    assert float(tlie.pose_distance(out.T_w_c, torch.from_numpy(out_j.T_w_c))) < INIT_JAX_TOL
    torch.testing.assert_close(out.T_w_c[:3, :3], torch.from_numpy(out_j.T_w_c[:3, :3]),
                               rtol=0, atol=INIT_JAX_TOL)
    np.testing.assert_array_equal(new.map.valid.numpy(), st2_j.map.valid)


def test_batched_jax_state_in_mixed_stages_carries_over(jax_init, jax_general, sequences):
    """A JAX state stacked from streams in three stages (blank, after the
    first frame, tracking at the end of the vmapped run) converts with
    ``batched=True`` to the stack of the streams converted one by one, and
    one general step from it equals ``step`` per stream."""
    frames, _ = sequences
    st1 = jax_init[0]
    final_j, _ = jax_general
    singles_j = [jax.device_get(JS.init_state(JCFG, seed=5)), st1,
                 jax.tree.map(lambda x: x[0], final_j)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *singles_j)
    got = convert.state_from_numpy(stacked._asdict(), device="cpu", batched=True)
    ports = [convert.state_from_numpy(s._asdict(), device="cpu") for s in singles_j]
    for g, w in zip(tree_leaves(tuple(got)), tree_leaves(tuple(TS.stack_states(ports)))):
        assert torch.equal(g, w)
    imgs = [frames[0, 0], frames[0, 6], frames[0, N - 1]]
    new, out = TV.step_general_batched(CFG, CAM, got, torch.from_numpy(np.stack(imgs)),
                                       height=H, width=W)
    for b, (st, img) in enumerate(zip(ports, imgs)):
        want_st, want = TV.step(CFG, CAM, st, _frame(img), height=H, width=W)
        _assert_decisions_equal(TS.StepOutput(*(t[b] for t in out)), want)
        torch.testing.assert_close(new.T_w_c[b], want_st.T_w_c, rtol=0, atol=STEP_TOL)
        assert int(new.rng[b]) == int(want_st.rng)
