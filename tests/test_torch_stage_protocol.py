"""The stage protocol of ``tests/stage_protocol.py`` on the CPU: what
``chip_smoke.py`` phase 4k profiles on the card, held here to the path it
splits and to the JAX package.

1. The pieces compute what the path computes: prefix d's PnP result is the
   one ``step_track`` computes (its ``solve_pnp_ransac`` tapped), prefix e's
   state and output are ``step_track``'s, and ``gather_window`` ->
   ``ba_solve`` -> ``write_back`` is ``ba_update_state`` (``torch.equal``,
   the same draws).
2. The pieces match JAX's own tools: on a tracking state carried from the
   JAX engine through ``convert.py``, prefix c's matches equal the JAX
   package's composition of features, frustum scan and
   ``matching.match_features`` on the same frame (indices equal): the
   composition of ``profile_bisect.py``'s ``prefix_c`` (stale-pose frustum,
   the whole map as queries) under a configuration where the port's prefix
   is that (no motion model, no compaction), and the default one, which
   adds the motion model, the union gate and the candidate compaction as
   JAX's ``_step_track_impl`` does.
3. The split closes exactly: under ``torch.profiler``, the aten ops of the
   pieces e + ba + keyframe + glue are those of the tracking program's body
   (``vo.StagePrograms``) on the same state and frame, name by name.

Init piece C against the init stage program is held on the card (phase
4k (b), both solvers): here it would add a fifth of the file's time.

The configuration is ``test_torch_vo._small_cfg``'s with BA on (512
keypoints, 256 hypotheses, 2,048 map points); the state is the JAX
engine's after frame STATE_FRAME of ``stage_protocol``'s sequence
(``make_trajectory(17, 0, 0.05)`` over ``default_scene(0)``), tracking since
frame 6. One torch thread.
"""

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stage_protocol as SP
from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models import vo as JV
from monocular_visual_odometry_tpu.models.vo import VOEngine as JEngine
from monocular_visual_odometry_tpu.ops import lie as JL
from monocular_visual_odometry_tpu.ops import matching as JM
from monocular_visual_odometry_tpu.ops.camera import cam2pixel, in_frame
from monocular_visual_odometry_tpu.ops.features import features_from_config as jfeatures
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.ops import pnp

H, W = 480, 640
STATE_FRAME = 9  # the JAX engine's state after this frame is carried across
K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])


def _small_cfg(ba=True, **tracking):
    cfg = JConfig()
    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        tracking=dataclasses.replace(cfg.tracking, **tracking),
        ba=dataclasses.replace(cfg.ba, enabled=ba))


# profile_bisect.py's prefix_c: the stale pose, the whole map as queries
BISECT = dict(tracking=dict(use_motion_model=False, motion_gate_union=False), candidates=0)
DEFAULT = dict(tracking={}, candidates=None)


def _jax_cfg(case):
    cfg = _small_cfg(**case["tracking"])
    if case["candidates"] is not None:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, track_candidates=case["candidates"]))
    return cfg


def _port(jcfg):
    return convert.config_to_torch(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    gt = tsyn.make_trajectory(SP.STATE_FRAMES + 1, 0, translation_step=SP.STATE_STEP)
    scene = tsyn.default_scene(0)
    with ThreadPoolExecutor(max_workers=4) as ex:
        return np.stack(list(ex.map(lambda i: tsyn.render_frame(gt[i], scene, K),
                                    range(STATE_FRAME + 2)))).astype(np.float32)


@pytest.fixture(scope="module")
def carried(frames):
    """The JAX engine's state after frame STATE_FRAME, as numpy (BA off
    there: its program compiles in three quarters of the time)."""
    eng = JEngine(_small_cfg(ba=False), H, W)
    for f in frames[:STATE_FRAME + 1]:
        eng.add_frame(f)
    state = {k: jax.device_get(v) for k, v in eng.state._asdict().items()}
    assert int(state["stage"]) == JS.STAGE_TRACKING
    return state, eng.cam


@pytest.fixture(scope="module")
def setup(frames, carried):
    cfg = _port(_small_cfg())
    cam = TV.VOEngine(cfg, H, W, device="cpu").cam
    st = convert.state_from_numpy(carried[0], device="cpu")
    img = torch.from_numpy(frames[STATE_FRAME + 1])
    record = []  # step_track's PnP result, tapped
    with SP.tap(pnp, "solve_pnp_ransac", record):
        ch = SP.tracking_chain(cfg, cam, st, img, height=H, width=W)
    return cfg, cam, st, img, ch, SP.track_pieces(cfg, cam, ch, height=H, width=W), record


def _leaves_equal(a, b):
    la, lb = torch.utils._pytree.tree_flatten(a)[0], torch.utils._pytree.tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None and y is None) or torch.equal(x, y)


def test_prefix_d_pnp_is_step_tracks(setup):
    *_, pieces, record = setup
    got = pieces["d"]()[3]
    assert len(record) == 1 and bool(got.ok)
    _leaves_equal(got, record[0])


def test_prefix_e_is_step_track(setup):
    ch, pieces = setup[4:6]
    _leaves_equal(pieces["e"](), (ch.new, ch.out, ch.feats, ch.curr_mp))


def test_ba_parts_chain_to_ba_update_state(setup):
    cfg, cam, st, img, ch = setup[:5]
    prob, slots = TB.gather_window(cfg, ch.new, cam)
    T_c_w, pts, _ = TB.ba_solve(cfg, cam, prob)
    _leaves_equal(TB.write_back(cfg, ch.new, prob, slots, T_c_w, pts), ch.solved)
    _leaves_equal(ch.solved, TB.ba_update_state(cfg, cam, ch.new))


def _jax_prefix_c(cfg, cam, st, img):
    """The JAX package's features -> frustum -> ``match_features`` on one
    frame, as ``_step_track_impl`` composes them (``profile_bisect.py``'s
    ``prefix_c`` when there is no motion model and no compaction)."""
    feats = jfeatures(img, cfg.orb)
    use_union = cfg.tracking.use_motion_model and cfg.tracking.motion_gate_union
    T_proj = st.T_w_c @ st.last_rel if cfg.tracking.use_motion_model else st.T_w_c
    p_cam = JL.transform_points(JL.inv_T(T_proj), st.map.pts)
    proj = cam2pixel(p_cam, cam)
    candidates = st.map.valid & (p_cam[:, 2] > 0) & in_frame(proj, H, W)
    proj_s = None
    if use_union:
        p_cam_s = JL.transform_points(JL.inv_T(st.T_w_c), st.map.pts)
        proj_s = cam2pixel(p_cam_s, cam)
        ok_s = (p_cam_s[:, 2] > 0) & in_frame(proj_s, H, W)
        candidates = candidates | (st.map.valid & ok_s)
        proj_s = jnp.where(ok_s[:, None], proj_s, 1e9)
        proj = jnp.where((p_cam[:, 2] > 0)[:, None], proj, 1e9)
    M, C = st.map.pts.shape[0], cfg.map.track_candidates
    if C and C < M:
        comp = JV.compact_mask(candidates, C)
        ok, idx = comp >= 0, jnp.maximum(comp, 0)
        desc, proj, proj_s = st.map.desc[idx], proj[idx], None if proj_s is None else proj_s[idx]
    else:
        ok, desc = candidates, st.map.desc
    return JM.match_features(
        desc, feats.desc, ok, feats.valid, proj, feats.kpts,
        method=cfg.match.method_index, max_pixel_dist=cfg.match.max_pixel_dist_pnp,
        xiang_gao_ratio=cfg.match.xiang_gao_match_ratio, lowe_ratio=cfg.match.lowe_dist_ratio,
        ambiguity_ratio=cfg.match.method3_ambiguity_ratio, kpts1_alt=proj_s)


@pytest.fixture(scope="module")
def jax_prefix_c(frames, carried):
    """JAX's prefix c under both cases, in one jit."""
    state, jcam = carried
    cases = {"bisect": BISECT, "default": DEFAULT}

    def both(st, img):
        with jax.default_matmul_precision("highest"):
            return {k: _jax_prefix_c(_jax_cfg(c), jcam, st, img) for k, c in cases.items()}

    jst = jax.tree.map(jnp.asarray, JS.VOState(**state))
    return jax.device_get(jax.jit(both)(jst, jnp.asarray(frames[STATE_FRAME + 1])))


@pytest.mark.parametrize("case", ["bisect", "default"])
def test_prefix_c_matches_jax(setup, carried, jax_prefix_c, case):
    _, cam, st, img, ch = setup[:5]
    cfg = _port(_jax_cfg({"bisect": BISECT, "default": DEFAULT}[case]))
    _, _, m = SP.prefix_pieces(cfg, cam, ch.st, img, ch.draws, height=H, width=W)["c"]()
    want = jax_prefix_c[case]
    assert int(m.n_valid) > 50
    for f in ("valid", "query_idx", "train_idx"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _aten_ops(fn) -> collections.Counter:
    """The aten ops ``fn()`` dispatches, by name, from the profiler's raw
    events (``prof.events()`` builds a Python record per event: ~20x as
    slow)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.name().startswith("aten::"))


def test_split_closes_in_aten_ops(setup):
    cfg, cam, st, img, ch, pieces = setup[:6]
    # the tracking program as StagePrograms makes it, its buffers loaded
    prog = CapturedStep(TV.StagePrograms(cfg, cam, H, W, "cpu")._fn(TS.STAGE_TRACKING))
    prog.load(ch.st, img, ch.draws)
    whole = _aten_ops(prog.replay)
    split = collections.Counter()
    for name in ("e", "ba", "keyframe", "glue"):
        split += _aten_ops(pieces[name])
    assert sum(whole.values()) > 1000
    assert split == whole, {k: (split[k], whole[k]) for k in split.keys() | whole.keys()
                            if split[k] != whole[k]}
