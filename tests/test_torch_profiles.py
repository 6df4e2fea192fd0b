"""The JAX package's evaluation configurations on the port (CPU), beside
the JAX package: what ``chip_smoke.py`` phase 4j runs on the card at full
depth, here at a small size.

1. The five-point A/B of ``profile_fivepoint_ab.py``
   (``eval_protocol.fivepoint_ab``: ``synthesize_two_view(n=200, noise_px=0.5)``,
   256 hypotheses, each seed's draws made on the host) on the CPU's route
   (LAPACK's ``eigh``) and on the card's route forced onto CPU tensors
   (``lie.eigh_jacobi``, ``lie.svd3_jacobi``), 4 seeds at outlier fractions
   0.2 and 0.4: the card's chart within ``eval_protocol.AB_GATE`` of LAPACK's
   (median rotation error <= 1.25 x + 0.05 deg, median translation-direction
   error <= 1.25 x + 0.5 deg, failures <= + 1). The float32 solver's
   agreement with the float64 one at fraction 0.6, which it missed with its
   Gram matrices formed in float32, is held in
   ``test_torch_twoview_charts.py``.
2. ``eval_protocol.eval_configs`` are the JAX scripts' configurations
   (``profile_robustness_r5.py:55-73``, ``profile_ba_ablation.py:73-81``)
   converted to the port.
3. One tracking step (``step_track``) from the JAX engine's state under each
   non-default tracking profile (``reference_parity``: stale-pose
   projection; ``predict_only``: no union gate, so the matcher's call
   without ``kpts1_alt``; ``robust``: the ambiguity gate on the matcher's
   second-best distance), against JAX's ``step_track`` from the same state:
   the same candidates and keyframe decision, matches within 2%, inliers
   within 5%, pose distance < 1e-3 (the PnP draws differ).
4. The first frames of the ``adv_scene+adv_traj`` row (``adversarial_scene()``,
   ``make_adversarial_trajectory(150)``), which JAX initializes at frame 1
   (``ROBUSTNESS_r05.json``), through both packages' engines: the same init
   frame within one, the ATE within ``test_torch_vo._check_tracks``'s band
   (max(0.02, half the JAX ATE)). Its absolute budget (0.10) is the
   benchmark scene's and is not applied on this scene.

The configuration is ``test_torch_vo._small_cfg``'s (256 hypotheses, 128
PnP hypotheses, 2,048 map points, BA off) at the default 1,024 keypoints:
at 512 the repeated-texture scene initializes late or not at all in both
packages, so the init frame is a coin toss between seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_protocol import AB_GATE, ab_gate, eval_configs, fivepoint_ab
from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models import vo as JV
from monocular_visual_odometry_tpu.models.vo import VOEngine as JEngine
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.models.vo import VOEngine as TEngine
from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.utils import metrics as tmetrics
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig as TConfig

N_FRAMES = 8      # the first frames of the 150-frame adv_scene+adv_traj row
CARRY_FRAME = 5   # the JAX engine's state after this frame is carried across
AB_SEEDS, AB_FRACS = range(4), (0.2, 0.4)
K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])


def _jax_variant(cfg, mm=True, union=True, amb=1.0, minimal="8pt"):
    """``profile_robustness_r5.py``'s ``variant``."""
    return cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, use_motion_model=mm, motion_gate_union=union),
        match=dataclasses.replace(cfg.match, method3_ambiguity_ratio=amb),
        init=dataclasses.replace(cfg.init, use_reference_selection=False),
        ransac=dataclasses.replace(cfg.ransac, essential_minimal=minimal))


def _jax_configs(cfg):
    """The JAX scripts' configurations over ``cfg``, by ``eval_configs``'s
    names."""
    return {
        "reference_parity": _jax_variant(cfg, mm=False, union=False),
        "predict_only": _jax_variant(cfg, union=False),
        "default": _jax_variant(cfg),
        "robust": _jax_variant(cfg, amb=0.8),
        "default_5pt": _jax_variant(cfg, minimal="5pt"),
        "ba_off": cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=False)),
        "ba_on_regate3": cfg.replace(ba=dataclasses.replace(cfg.ba, regate_px=3.0)),
    }


def _small_cfg():
    cfg = JConfig()
    return cfg.replace(
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048),
        ba=dataclasses.replace(cfg.ba, enabled=False))


def _port(jcfg):
    return convert.config_to_torch(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ab_routes():
    """The A/B on the CPU's route and on the card's route forced here."""
    run = lambda: fivepoint_ab("cpu", seeds=AB_SEEDS, fracs=AB_FRACS, minimals=("5pt",))
    lapack = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lie, "card_route", lambda t: True)
        jacobi = run()
    return lapack, jacobi


@pytest.mark.parametrize("frac", AB_FRACS)
def test_fivepoint_ab_card_chart_within_gate(ab_routes, frac):
    lapack, jacobi = ab_routes
    k = f"outliers={frac}:5pt"
    assert ab_gate(jacobi, lapack, (frac,)) == [], (AB_GATE, lapack[k], jacobi[k])
    # the protocol's draws are the same on both routes: with no root lost
    # to a chart, the two pick the same model (rotation within rounding)
    same = np.isclose(lapack[k]["rot_each"], jacobi[k]["rot_each"], atol=0.02)
    assert same.sum() >= len(AB_SEEDS) - 1, (lapack[k]["rot_each"], jacobi[k]["rot_each"])


@pytest.mark.parametrize("name", sorted(_jax_configs(JConfig())))
def test_eval_configs_are_the_jax_scripts(name):
    assert eval_configs(TConfig())[name] == _port(_jax_configs(JConfig())[name])


@pytest.fixture(scope="module")
def sequence():
    gt = tsyn.make_adversarial_trajectory(150)[:N_FRAMES]
    scene = tsyn.adversarial_scene()
    frames = np.stack([tsyn.render_frame(gt[i], scene, K) for i in range(N_FRAMES)])
    return frames.astype(np.float32), gt


@pytest.fixture(scope="module")
def jax_run(sequence):
    eng = JEngine(_small_cfg(), 480, 640)
    outs, carried = [], None
    for i, f in enumerate(sequence[0]):
        outs.append(jax.device_get(eng.add_frame(f)))
        if i == CARRY_FRAME:
            carried = {k: jax.device_get(v) for k, v in eng.state._asdict().items()}
    return outs, carried, eng.cam


@pytest.fixture(scope="module")
def torch_run(sequence):
    eng = TEngine(_port(_small_cfg()), 480, 640, device="cpu")
    return [eng.add_frame(f) for f in sequence[0]]


PROFILES = ("reference_parity", "predict_only", "robust")


@pytest.fixture(scope="module")
def jax_profile_steps(sequence, jax_run):
    """JAX's tracking step (``step_track``'s body at its matmul precision)
    from the carried state under each profile of PROFILES, the three in one
    jit (one compile instead of three)."""
    _, carried, jcam = jax_run
    cfgs = _jax_configs(_small_cfg())

    def steps(st, img):
        with jax.default_matmul_precision("highest"):
            return [JV._step_track_impl(cfgs[p], jcam, st, img, height=480, width=640)[1]
                    for p in PROFILES]

    jst = jax.tree.map(jnp.asarray, JS.VOState(**carried))
    outs = jax.device_get(jax.jit(steps)(jst, jnp.asarray(sequence[0][CARRY_FRAME + 1])))
    return dict(zip(PROFILES, outs))


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_step_from_carried_state(sequence, jax_run, jax_profile_steps, profile):
    carried = jax_run[1]
    assert int(carried["stage"]) == JS.STAGE_TRACKING
    tcfg = _port(_jax_configs(_small_cfg())[profile])
    img = sequence[0][CARRY_FRAME + 1]
    want = jax_profile_steps[profile]
    cam = TEngine(tcfg, 480, 640, device="cpu").cam
    _, got, _, _ = TV.step_track(tcfg, cam, convert.state_from_numpy(carried, device="cpu"),
                                 torch.from_numpy(img), height=480, width=640)
    assert int(got.n_candidates) == int(want.n_candidates) > 0
    assert abs(int(got.n_matches) - int(want.n_matches)) <= 0.02 * int(want.n_matches)
    assert bool(got.tracking_ok) and bool(want.tracking_ok)
    assert bool(got.is_keyframe) == bool(want.is_keyframe)
    dist = float(lie.pose_distance(got.T_w_c, torch.from_numpy(np.array(want.T_w_c))))
    assert dist < 1e-3, dist
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 0.05 * int(want.n_inliers)


def test_adversarial_run_beside_jax(sequence, jax_run, torch_run):
    j_outs, gt = jax_run[0], sequence[1]
    first = lambda outs, s: next(i for i, o in enumerate(outs) if int(o.stage) == s)
    assert int(j_outs[-1].stage) == JS.STAGE_TRACKING
    assert int(torch_run[-1].stage) == TS.STAGE_TRACKING
    assert abs(first(torch_run, TS.STAGE_TRACKING) - first(j_outs, JS.STAGE_TRACKING)) <= 1
    ate = lambda outs: tmetrics.ate_rmse(np.stack([np.asarray(o.T_w_c) for o in outs]), gt)
    ate_j, ate_t = ate(j_outs), ate(torch_run)
    assert np.isfinite(ate_t) and abs(ate_t - ate_j) <= max(0.02, 0.5 * ate_j), (ate_t, ate_j)
