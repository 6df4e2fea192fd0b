"""Port parity for the scene generators: ``data/synthetic.py`` of the port
against the JAX package's on the same seeds (CPU, numpy on both sides).

Everything here is equal, not close. The Euler rotations are held to
scipy's ``Rotation.from_euler(...).as_matrix()`` bit for bit, for every axis
order the generators use, because a frame rendered from a rotation one ulp
off differs after the uint8 rounding. The blur is held to scipy's
``convolve1d(mode="nearest")`` itself at every width from 2 to 11. The JPEG
kind goes through the same einsums as the reference, held at rtol 1e-12.
"""

import numpy as np
import pytest
from scipy.ndimage import convolve1d
from scipy.spatial.transform import Rotation

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn

K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])
KINDS = [("noise", 10.0), ("noise", 6.0), ("blur", 7.0), ("blur", 4.0), ("blur", 1.0),
         ("exposure", 1.0), ("low_contrast", 0.5), ("low_contrast", 0.25), ("jpeg", 2.0),
         ("jpeg", 1.0), ("vignette", 2.0)]


@pytest.mark.parametrize("seq", ["y", "x", "z", "yx", "xy", "yxz", "xyz", "zyx"])
def test_from_euler_equals_scipy_bit_for_bit(seq):
    rng = np.random.default_rng(len(seq) * 7 + ord(seq[0]))
    for i in range(300):
        # angles from tiny to a full turn, the generators' ranges among them
        angles = rng.uniform(-np.pi, np.pi, len(seq)) * [1e-4, 0.08, 0.5, 1.0][i % 4]
        want = Rotation.from_euler(seq, angles if len(seq) > 1 else angles[0]).as_matrix()
        np.testing.assert_array_equal(tsyn._from_euler(seq, angles), want, err_msg=str(angles))


def test_from_euler_rejects_what_it_does_not_compute():
    for seq, angles in (("yx", [0.1]), ("YX", [0.1, 0.2]), ("", [])):
        with pytest.raises(ValueError):
            tsyn._from_euler(seq, angles)


@pytest.mark.parametrize("name,kw", [
    ("make_trajectory", dict(n_frames=150, seed=0, translation_step=0.04)),
    ("make_trajectory", dict(n_frames=60, seed=3, translation_step=0.05)),
    ("make_adversarial_trajectory", dict(n_frames=150)),
    ("make_adversarial_trajectory", dict(n_frames=37, translation_step=0.03)),
    ("make_planar_trajectory", dict(n_frames=40)),
    ("make_planar_trajectory", dict(n_frames=150, lateral_step=0.02)),
])
def test_trajectories_equal_jax(name, kw):
    np.testing.assert_array_equal(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw))


@pytest.mark.parametrize("name,kw", [
    ("_multiscale_texture", dict(size=256)),
    ("_pink_texture", dict()),
    ("_pink_texture", dict(size=256, beta=1.5)),
    ("_repeated_texture", dict()),
    ("_repeated_texture", dict(size=300, period=48)),
])
def test_textures_equal_jax(name, kw):
    got = getattr(tsyn, name)(np.random.default_rng(5), **kw)
    np.testing.assert_array_equal(got, getattr(jsyn, name)(np.random.default_rng(5), **kw))


def _rays(seed, n=4000):
    """Rays from a point inside the scenes' rooms in all directions."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(3, n))
    dirs[2] = np.abs(dirs[2]) + 0.2
    return rng.uniform(-0.5, 0.5, 3), dirs


@pytest.mark.parametrize("kind", ["Sphere", "Box"])
def test_primitives_equal_jax(kind):
    tex = tsyn._multiscale_texture(np.random.default_rng(1), size=256)
    args = (dict(center=np.array([0.3, -0.2, 3.0]), radius=0.9) if kind == "Sphere" else
            dict(p_min=np.array([-0.8, -0.5, 2.5]), p_max=np.array([0.6, 0.7, 3.9])))
    got = getattr(tsyn, kind)(tex=tex, **args)
    want = getattr(jsyn, kind)(tex=tex, **args)
    origin, dirs = _rays(2)
    t_got, t_want = got.intersect(origin, dirs), want.intersect(origin, dirs)
    np.testing.assert_array_equal(t_got, t_want)
    hit = np.isfinite(t_want)
    assert 100 < hit.sum() < hit.size  # some rays hit, some miss
    X = origin[:, None] + dirs[:, hit] * t_want[hit]
    np.testing.assert_array_equal(got.shade(X), want.shade(X))


@pytest.mark.parametrize("scene", ["default_scene", "adversarial_scene", "planar_scene"])
def test_scenes_equal_jax(scene):
    got, want = getattr(tsyn, scene)(), getattr(jsyn, scene)()
    assert [type(o).__name__ for o in got] == [type(o).__name__ for o in want]
    for a, b in zip(got, want):
        for f, v in vars(b).items():
            np.testing.assert_array_equal(getattr(a, f), v, err_msg=f"{scene} {f}")


@pytest.mark.parametrize("scene,trajectory,frames", [
    ("adversarial_scene", "make_adversarial_trajectory", (0, 60, 75, 149)),
    ("planar_scene", "make_planar_trajectory", (0, 20, 39)),
])
def test_rendered_frames_equal_jax(scene, trajectory, frames):
    n = frames[-1] + 1
    gt, objs = getattr(tsyn, trajectory)(n), getattr(tsyn, scene)()
    j_gt, j_objs = getattr(jsyn, trajectory)(n), getattr(jsyn, scene)()
    for i in frames:
        np.testing.assert_array_equal(tsyn.render_frame(gt[i], objs, K),
                                      jsyn.render_frame(j_gt[i], j_objs, K), err_msg=str(i))


@pytest.fixture(scope="module")
def clean_frames():
    gt = tsyn.make_trajectory(4, seed=0, translation_step=0.05)
    scene = tsyn.default_scene(0)
    return np.stack([tsyn.render_frame(g, scene, K, 240, 320) for g in gt])


@pytest.mark.parametrize("kind,severity", KINDS)
def test_perturb_frames_equals_jax(clean_frames, kind, severity):
    for frames in (clean_frames, clean_frames.astype(np.float32)):
        got = tsyn.perturb_frames(frames, kind, severity, seed=3)
        want = jsyn.perturb_frames(frames, kind, severity, seed=3)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        if kind == "jpeg":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
        assert kind == "blur" and severity == 1.0 or not np.array_equal(got, frames)


def test_perturbations_compose_as_in_the_severe_case(clean_frames):
    """The robustness matrix's severe case: low contrast 0.1, then noise 6."""
    got = tsyn.perturb_frames(tsyn.perturb_frames(clean_frames, "low_contrast", 0.1),
                              "noise", 6.0)
    want = jsyn.perturb_frames(jsyn.perturb_frames(clean_frames, "low_contrast", 0.1),
                               "noise", 6.0)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown perturbation"):
        tsyn.perturb_frames(clean_frames, "fog", 1.0)


@pytest.mark.parametrize("k", range(2, 12))
def test_box_blur_equals_scipy_convolve1d(k):
    rng = np.random.default_rng(k)
    for frames in (rng.uniform(0, 255, (2, 17, 41)).astype(np.float32),
                   rng.integers(0, 256, (1, 30, 64)).astype(np.float32)):
        want = convolve1d(frames, np.ones(k, dtype=np.float32) / k, axis=2, mode="nearest")
        np.testing.assert_array_equal(tsyn._box_blur_rows(frames, k), want)


def test_jpeg_artifacts_equal_jax_on_ragged_sizes():
    img = np.random.default_rng(0).uniform(0, 255, (37, 53))
    for severity in (0.5, 1.0, 3.0):
        np.testing.assert_allclose(tsyn._jpeg_artifacts(img, severity),
                                   jsyn._jpeg_artifacts(img, severity), rtol=1e-12, atol=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=4), dict(planar=True), dict(planar=True, seed=2, noise_px=0.5),
    dict(noise_px=1.0, outlier_frac=0.3, seed=3), dict(n=60, baseline=0.1, outlier_frac=0.2),
])
def test_two_view_generator_equals_jax(kw):
    got, want = tsyn.synthesize_two_view(**kw), jsyn.synthesize_two_view(**kw)
    for f in ("pts_w", "uv1", "uv2", "T_w_c1", "T_w_c2", "K", "T_c1_c2"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("kw", [dict(), dict(seed=7, n=50),
                                dict(noise_px=1.0, outlier_frac=0.3, seed=5)])
def test_pnp_generator_equals_jax(kw):
    got, want = tsyn.synthesize_pnp_scene(**kw), jsyn.synthesize_pnp_scene(**kw)
    for f in ("pts_w", "uv", "T_w_c", "K"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_port_has_every_name_of_the_reference_module():
    """Every function, class and constant the reference module defines
    (its imports aside) is in the port's module."""
    home = jsyn.__name__
    defined = {n for n, v in vars(jsyn).items()
               if not n.startswith("__") and getattr(v, "__module__", home) == home
               and not isinstance(v, type(np))}
    assert {"perturb_frames", "_JPEG_Q50", "Sphere", "planar_scene"} <= defined
    assert defined <= set(vars(tsyn)), defined - set(vars(tsyn))
