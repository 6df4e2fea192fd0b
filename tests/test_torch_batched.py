"""The port's multi-stream tracking mode (``step_tracking_batched``,
``run_sequences_batched``) against its own single-stream ``step`` and
against the JAX package's batched mode, on the CPU.

The batched step is ``torch.func.vmap`` of a per-stream body in which BA
and the keyframe update run unconditionally and are applied by per-stream
selects; the single-stream step branches on the host instead. From the
same state, frame and key the two must agree: counts and flags equal, poses,
the ring and map points within 1e-4 (the batched ops sum in another order).
Over 12 steps the poses stay within 2e-3 of the single-stream run and two
identical streams within 1e-6 of each other: the budgets of the JAX
package's own batched test (``tests/test_fused_step.py:118,120``).

Against JAX the random draws differ, so only what is computed before any
draw is equal (the first step's candidate count); the first pose lands
within 1e-3 (pose_distance) and the ATE of the batched steps within
max(0.02, half JAX's).

Every test here runs with vmap's slow fallback off (an op without a batch
rule raises), so the body batches every op it issues.
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
from monocular_visual_odometry_tpu.ops.camera import Camera as JCamera
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops import lie as tlie
from monocular_visual_odometry_tpu_torch.ops import ransac as tran
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH
from monocular_visual_odometry_tpu_torch.utils import metrics as tmetrics

H, W = 480, 640
WARM, STEPS = 12, 12


def _small_cfg(**ba):
    """The capacity-reduced config of tests/test_torch_vo.py, BA on."""
    cfg = JConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, enabled=True, **ba),
    )


def _port_cfg(**ba):
    return convert.config_to_torch(dataclasses.asdict(_small_cfg(**ba)))


CFG = _port_cfg()
CAM = TV.VOEngine(CFG, H, W, device="cpu").cam


@pytest.fixture(scope="module", autouse=True)
def no_vmap_fallback():
    """vmap's slow fallback off; one intra-op thread (the ops are small, and
    beside other test workers a pool of threads per process only contends)."""
    was, threads = torch._C._functorch._is_vmap_fallback_enabled(), torch.get_num_threads()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    torch.set_num_threads(1)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(was)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sequences():
    """Two rendered sequences (seeds 0 and 1): frames [2,N,H,W], poses [2,N,4,4]."""
    runs = [tsyn.render_sequence_arrays(WARM + STEPS, seed=s, translation_step=0.05)
            for s in (0, 1)]
    return np.stack([f for f, _ in runs]), np.stack([g for _, g in runs])


def _single(st, frames):
    """``step`` frame by frame: [(state, output)] after each frame."""
    out = []
    for f in frames:
        st, o = TV.step(CFG, CAM, st, torch.from_numpy(f).float(), height=H, width=W)
        out.append((st, o))
    return out


@pytest.fixture(scope="module")
def streams(sequences):
    """Per sequence: the state after WARM frames (engine on the CPU), then
    the single-stream run over the next STEPS frames."""
    frames, _ = sequences
    out = []
    for seq in frames:
        eng = TV.VOEngine(CFG, H, W, device="cpu")
        for f in seq[:WARM]:
            eng.add_frame(f)
        assert int(eng.state.stage) == TS.STAGE_TRACKING
        out.append((eng.state, _single(eng.state, seq[WARM:])))
    return out


def _assert_state_close(got, want, what="", pts_tol=1e-4):
    """Every field: integers and flags equal, floats within 1e-4 (map
    points within ``pts_tol``)."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _assert_state_close(getattr(got, f), getattr(want, f), f"{what}.{f}", pts_tol)
    elif want.dtype.is_floating_point:
        tol = pts_tol if what == ".map.pts" else 1e-4
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=what)
    else:
        assert torch.equal(got, want), what


def _assert_outputs_equal(got, want):
    for f in ("n_matches", "n_inliers", "n_candidates", "is_keyframe", "tracking_ok",
              "n_map_points", "ba_rejected_total", "stage"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.T_w_c, want.T_w_c, rtol=0, atol=1e-4)


def _batched_step(cfg, states, frames):
    sts = TS.stack_states(states)
    return TV.step_tracking_batched(cfg, CAM, sts, torch.from_numpy(np.stack(frames)).float(),
                                    height=H, width=W)


def _check_against_single(cfg, states, frames, pts_tol=1e-4):
    new, out = _batched_step(cfg, states, frames)
    for b, (st, f) in enumerate(zip(states, frames)):
        want_st, want_out = TV.step(cfg, CAM, st, torch.from_numpy(f).float(), height=H, width=W)
        _assert_outputs_equal(TS.StepOutput(*(t[b] for t in out)), want_out)
        _assert_state_close(TS.unstack_state(new, b), want_st, pts_tol=pts_tol)
    return out


def test_draws_made_outside_equal_the_draws_made_inside():
    valid = torch.from_numpy(np.random.default_rng(0).uniform(size=700) > 0.3)
    u = tran.uniforms(1234, (64, 700), "cpu")
    assert torch.equal(tran.sample_minimal_sets(None, valid, 64, 3, u),
                       tran.sample_minimal_sets(1234, valid, 64, 3))


def test_one_batched_step_equals_step_per_stream(streams, sequences):
    frames, _ = sequences
    _check_against_single(CFG, [s for s, _ in streams], [frames[0, WARM], frames[1, WARM]])


def test_batched_run_against_single_stream_runs(streams, sequences):
    """Streams [A, A, B] over STEPS steps: A against its single-stream run
    (2e-3), the copy of A against A (1e-6), B against its own run; the
    keyframe decision differs across the batch at least once."""
    frames, _ = sequences
    (st_a, run_a), (st_b, run_b) = streams
    sts = TS.stack_states([st_a, st_a, st_b])
    final, outs = TV.run_sequences_batched(CFG, CAM, sts, frames[[0, 0, 1], WARM:],
                                           height=H, width=W)
    assert outs.T_w_c.shape == (STEPS, 3, 4, 4)   # scan-major, as the JAX function
    for b, run in ((0, run_a), (2, run_b)):
        want = torch.stack([o.T_w_c for _, o in run])
        torch.testing.assert_close(outs.T_w_c[:, b], want, rtol=0, atol=2e-3)
        assert torch.equal(outs.is_keyframe[:, b], torch.stack([o.is_keyframe for _, o in run]))
        assert torch.equal(outs.tracking_ok[:, b], torch.stack([o.tracking_ok for _, o in run]))
        assert torch.equal(final.rng[b], run[-1][0].rng)
    torch.testing.assert_close(outs.T_w_c[:, 1], outs.T_w_c[:, 0], rtol=0, atol=1e-6)
    assert bool((outs.is_keyframe[:, 0] != outs.is_keyframe[:, 2]).any())
    assert bool((final.stage == TS.STAGE_TRACKING).all())


def test_failing_stream_keeps_what_step_gives(streams, sequences):
    """[real frame, blank frame]: the blank stream fails tracking, so BA and
    the keyframe update are computed for it but not applied."""
    frames, _ = sequences
    st = streams[0][0]
    blank = np.zeros_like(frames[0, WARM])
    out = _check_against_single(CFG, [st, st], [frames[0, WARM], blank])
    assert bool(out.tracking_ok[0]) and not bool(out.tracking_ok[1])


def test_joint_ba_batched_step(streams, sequences):
    frames, _ = sequences
    _check_against_single(_port_cfg(fix_map_points=False), [s for s, _ in streams],
                          [frames[0, WARM], frames[1, WARM]])


def test_keyframe_ransac_filter_batched_step(streams, sequences):
    """From the state before stream A's first keyframe in its single run, so
    the filter's E-RANSAC draws decide what the update keeps. The points it
    triangulates there hold to 1e-3: the ~0.8-unit-deep points seen over a
    few centimetres of baseline amplify the 1e-7 rounding differences of the
    poses about a thousandfold (2.2e-4 at most; the same with the filter
    off)."""
    frames, _ = sequences
    (st_a, run_a), (st_b, run_b) = streams
    i = next(i for i, (_, o) in enumerate(run_a) if bool(o.is_keyframe))
    before = lambda st0, run: st0 if i == 0 else run[i - 1][0]
    cfg = CFG.replace(ransac=dataclasses.replace(CFG.ransac, keyframe_use_ransac_filter=True))
    out = _check_against_single(cfg, [before(st_a, run_a), before(st_b, run_b)],
                                [frames[0, WARM + i], frames[1, WARM + i]], pts_tol=1e-3)
    assert bool(out.is_keyframe[0])


def test_batched_step_refuses_a_stream_that_is_not_tracking(streams, sequences):
    frames, _ = sequences
    blank = TS.init_state(CFG, 0, "cpu")
    with pytest.raises(ValueError, match="tracking"):
        _batched_step(CFG, [streams[0][0], blank], [frames[0, WARM], frames[1, WARM]])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.__name__] += 1
        if func.__name__.startswith("_to_copy") and (kwargs or {}).get("device") is not None:
            self.ops["_to_copy with a device"] += 1
        return func(*args, **(kwargs or {}))


def test_batched_body_reads_nothing_back(streams, sequences):
    """On a card these would wait on the stream: a value read back
    (``_local_scalar_dense``, ``nonzero``), a tensor built from host data
    (``lift_fresh``) or moved between devices. The body issues none."""
    frames, _ = sequences
    sts = TS.stack_states([s for s, _ in streams])
    imgs = torch.from_numpy(frames[:, WARM]).float()
    draws = TV.draw_batched(CFG, sts.rng, "cpu")
    calls = TB.ba_update_state.calls
    with _Ops() as mode:
        TV.tracking_batched_body(CFG, CAM, sts, imgs, draws, height=H, width=W)
    assert TB.ba_update_state.calls == calls + 1        # one BA for the batch
    found = {k: mode.ops[k] for k in ("_local_scalar_dense.default", "nonzero.default",
                                      "lift_fresh.default", "_to_copy with a device")}
    assert sum(found.values()) == 0, found


def _matcher_inputs(b, k1, k2, seed, alt=True):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.integers(0, 256, (b, k1, 32), dtype=np.uint8)),
            t(rng.uniform(0, 640, (b, k1, 2)).astype(np.float32)),
            t(rng.uniform(size=(b, k1)) > 0.1),
            t(rng.integers(0, 256, (b, k2, 32), dtype=np.uint8)),
            t(rng.uniform(0, 640, (b, k2, 2)).astype(np.float32)),
            t(rng.uniform(size=(b, k2)) > 0.1),
            t(rng.uniform(0, 640, (b, k1, 2)).astype(np.float32)) if alt else None)


@pytest.mark.parametrize("alt", [False, True], ids=["single_gate", "union_gate"])
def test_matcher_under_vmap_is_the_plain_version_per_stream(alt):
    """vmap of the operator goes through its vmap rule (the fallback is
    off): per stream the plain version; a kernel launch only on a card."""
    d1, p1, v1, d2, p2, v2, pa = _matcher_inputs(3, 200, 301, 0, alt)
    launches = TH.hamming_nn_top2.launches
    call = lambda *a: TH.hamming_nn_top2(*a[:6], 60.0, uv1_alt=a[6] if alt else None)
    got = torch.func.vmap(call)(d1, p1, v1, d2, p2, v2, pa if alt else p1)
    # an input the batch shares (in_dims None) is broadcast to every stream
    shared = torch.func.vmap(call, in_dims=(0, 0, 0, None, None, None, 0))(
        d1, p1, v1, d2[0], p2[0], v2[0], pa if alt else p1)
    assert TH.hamming_nn_top2.launches == launches
    for b in range(3):
        want = TH.hamming_nn_top2_reference(d1[b], p1[b], v1[b], d2[b], p2[b], v2[b], 60.0,
                                            uv1_alt=pa[b] if alt else None)
        want0 = TH.hamming_nn_top2_reference(d1[b], p1[b], v1[b], d2[0], p2[0], v2[0], 60.0,
                                             uv1_alt=pa[b] if alt else None)
        for g, s, w, w0 in zip(got, shared, want, want0):
            assert torch.equal(g[b], w) and torch.equal(s[b], w0)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_batched(sequences):
    """JAX: run_sequence over WARM frames, the state stacked twice, then
    run_sequences_batched over the next STEPS frames."""
    frames, _ = sequences
    cfg = _small_cfg()
    cam = JCamera.create(615.0, 615.0, 320.0, 240.0)
    fj = jnp.asarray(frames[0].astype(np.float32))
    warm, _ = JV.run_sequence(cfg, cam, JS.init_state(cfg), fj[:WARM], height=H, width=W)
    assert int(warm.stage) == JS.STAGE_TRACKING
    sts = jax.tree.map(lambda x: jnp.stack([x, x]), warm)
    _, outs = JV.run_sequences_batched(cfg, cam, sts, jnp.stack([fj[WARM:], fj[WARM:]]),
                                       height=H, width=W)
    return jax.device_get(warm), jax.device_get(sts), jax.device_get(outs)


def test_batched_run_against_jax(sequences, jax_batched):
    _, gt = sequences
    _, sts_j, outs_j = jax_batched
    sts = convert.state_from_numpy(sts_j._asdict(), device="cpu", batched=True)
    _, outs = TV.run_sequences_batched(CFG, CAM, sts, np.stack([sequences[0][0, WARM:]] * 2),
                                       height=H, width=W)
    np.testing.assert_array_equal(outs.n_candidates[0].numpy(), outs_j.n_candidates[0])
    tail = gt[0, WARM:]
    for b in range(2):
        dist = float(tlie.pose_distance(outs.T_w_c[0, b], torch.from_numpy(outs_j.T_w_c[0, b])))
        assert dist < 1e-3, dist
        ate_t = tmetrics.ate_rmse(outs.T_w_c[:, b].numpy().astype(np.float64), tail)
        ate_j = tmetrics.ate_rmse(np.asarray(outs_j.T_w_c[:, b], np.float64), tail)
        assert abs(ate_t - ate_j) <= max(0.02, 0.5 * ate_j), (ate_t, ate_j)
    assert bool((outs.tracking_ok).all()) and bool(np.all(outs_j.tracking_ok))


def test_batched_jax_state_carries_over_as_single_states(jax_batched):
    """A stacked JAX state with a distinct key per stream, carried over with
    ``batched=True``, equals the port's stack of the streams carried one by
    one; unstack_state gives each back."""
    warm, sts_j, _ = jax_batched
    keys = np.stack([np.asarray(warm.rng), np.asarray(jax.random.split(warm.rng)[0])])
    sts_j = sts_j._replace(rng=keys)
    got = convert.state_from_numpy(sts_j._asdict(), device="cpu", batched=True)
    singles = [convert.state_from_numpy(jax.tree.map(lambda x: x[b], sts_j)._asdict(),
                                        device="cpu") for b in range(2)]
    want = TS.stack_states(singles)
    assert got.rng.shape == (2,) and got.rng[0] != got.rng[1]
    for g, w in zip(tree_leaves(tuple(got)), tree_leaves(tuple(want))):
        assert torch.equal(g, w)
    for b in range(2):
        for g, w in zip(tree_leaves(tuple(TS.unstack_state(got, b))),
                        tree_leaves(tuple(singles[b]))):
            assert torch.equal(g, w)
