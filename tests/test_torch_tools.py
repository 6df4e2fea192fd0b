"""Port parity for the offline camera tools (``data/tools.py``) and the op
helpers ``lie.rodrigues``, ``lie.T_to_rt34``, ``camera.pixel2cam`` and
``camera.homogeneous``, against the JAX package on the same inputs (CPU).

The closed-form part of Zhang's calibration, the undistortion pair, the
board coordinates and the renaming are the reference's numpy arithmetic and
are equal (the image pair held at rtol 1e-12). The refinement differs: the
reference calls scipy's MINPACK LM, the port its own f64 LM, and the two
stop at different points of the same minimum. So the refined result is held
by tolerance: noise-free views |dK| < 0.05 px, |d dist| < 1e-4,
|d rms| < 1e-3; views with 0.3 px noise |dK| < 0.5 px; and in both cases
``tests/test_tools.py``'s budgets against the ground truth.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from monocular_visual_odometry_tpu.data import tools as jtools
from monocular_visual_odometry_tpu.ops import camera as jcam
from monocular_visual_odometry_tpu.ops import lie as jlie
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.data import tools as ttools
from monocular_visual_odometry_tpu_torch.ops import camera as tcam
from monocular_visual_odometry_tpu_torch.ops import lie as tlie

# the JAX package's tests, for their view generators (tests/ is on the path)
import test_tools as jtest_tools  # noqa: E402
import test_tools_chain as jtest_chain  # noqa: E402

K_CLEAN = np.array([[600.0, 0, 315], [0, 605, 245], [0, 0, 1]])
DIST_CLEAN = np.array([-0.25, 0.08])
K_NOISY = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
DIST_NOISY = np.array([-0.2, 0.05])


def _noisy_views():
    """``tests/test_tools.py::test_calibration_with_pixel_noise``'s views."""
    obj, img = jtest_tools._synthetic_views(K_NOISY, DIST_NOISY, n_views=8, seed=1)
    rng = np.random.default_rng(2)
    return obj, [i + rng.normal(0, 0.3, i.shape) for i in img]


CALIBRATIONS = {
    # name: (views, |dK| tolerance against JAX, (dist, rms) tolerances or None)
    "clean": (lambda: jtest_tools._synthetic_views(K_CLEAN, DIST_CLEAN), 0.05, (1e-4, 1e-3)),
    "chain_views": (lambda: jtest_chain._chessboard_views(jtest_chain.K_GT, jtest_chain.DIST_GT),
                    0.05, (1e-4, 1e-3)),
    "noisy": (_noisy_views, 0.5, None),
}


@pytest.fixture(scope="module", params=sorted(CALIBRATIONS))
def calibration(request):
    views, k_tol, tols = CALIBRATIONS[request.param]
    obj, img = views()
    return (request.param, k_tol, tols, ttools.calibrate_camera(obj, img, (640, 480)),
            jtools.calibrate_camera(obj, img, (640, 480)))


def test_calibration_is_within_tolerance_of_jax(calibration):
    name, k_tol, tols, (K, dist, rms), (Kj, dj, rj) = calibration
    assert np.abs(K - Kj).max() < k_tol, (name, K, Kj)
    assert K[0, 1] == K[1, 0] == K[2, 0] == K[2, 1] == 0 and K[2, 2] == 1
    if tols is not None:
        assert np.abs(dist - dj).max() < tols[0], (name, dist, dj)
        assert abs(rms - rj) < tols[1], (name, rms, rj)


def test_calibration_meets_the_reference_budgets(calibration):
    """The budgets of ``tests/test_tools.py`` and ``test_tools_chain.py``."""
    name, _, _, (K, dist, rms), _ = calibration
    if name == "clean":
        assert rms < 0.05, rms
        for got, want in ((K[0, 0], 600), (K[1, 1], 605), (K[0, 2], 315), (K[1, 2], 245)):
            assert abs(got - want) < 2.0, K
        assert abs(dist[0] + 0.25) < 0.01 and abs(dist[1] - 0.08) < 0.02, dist
    elif name == "noisy":
        assert rms < 0.6 and abs(K[0, 0] - 600) < 8.0, (rms, K)
    else:
        assert rms < 0.1 and abs(K[0, 0] - jtest_chain.K_GT[0, 0]) < 3.0, (rms, K)


def test_closed_form_calibration_equals_jax():
    """Without the refinement the port runs the reference's numpy arithmetic."""
    obj, img = jtest_tools._synthetic_views(K_CLEAN, DIST_CLEAN)
    got = ttools.calibrate_camera(obj, img, (640, 480), refine=False)
    want = jtools.calibrate_camera(obj, img, (640, 480), refine=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(ttools._homography_dlt(obj[0], img[0]),
                                  jtools._homography_dlt(obj[0], img[0]))
    H = ttools._homography_dlt(obj[1], img[1])
    for i, j in ((0, 1), (0, 0), (1, 1)):
        np.testing.assert_array_equal(ttools._v_ij(H, i, j), jtools._v_ij(H, i, j))


def test_levenberg_marquardt_reaches_the_minimum():
    """Rosenbrock as residuals (10(y - x^2), 1 - x): minimum at (1, 1)."""
    fun = lambda p: torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])
    x = ttools._levenberg_marquardt(fun, torch.tensor([-1.2, 1.0], dtype=torch.float64))
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-7)


@pytest.fixture(scope="module")
def ideal_frame():
    K = np.array([[307.0, 0, 160], [0, 307.0, 120], [0, 0, 1.0]])
    img = tsyn.render_frame(np.eye(4), tsyn.default_scene(0), K, height=240, width=320)
    return K, img.astype(np.float64)


@pytest.mark.parametrize("dist", [[-0.25, 0.08], [-0.3, 0.09, 0.001, -0.002], [0.1]])
def test_distort_and_undistort_equal_jax(ideal_frame, dist):
    K, img = ideal_frame
    d = np.asarray(dist)
    distorted = ttools.distort_image(img, K, d)
    np.testing.assert_allclose(distorted, jtools.distort_image(img, K, d), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ttools.undistort_image(distorted, K, d),
                               jtools.undistort_image(distorted, K, d), rtol=1e-12, atol=0)
    assert ttools._unpack_dist(d) == jtools._unpack_dist(d)


def test_distort_undistort_round_trip(ideal_frame):
    """``tests/test_tools.py::test_distort_undistort_roundtrip``'s gates."""
    K, img = ideal_frame
    dist = np.array([-0.25, 0.08])
    distorted = ttools.distort_image(img, K, dist)
    assert np.abs(distorted - img).mean() > 1.0
    restored = ttools.undistort_image(distorted, K, dist)
    inner = (slice(40, 200), slice(40, 280))
    assert np.median(np.abs(restored[inner] - img[inner])) < 3.0
    a = restored[inner] - restored[inner].mean()
    b = img[inner] - img[inner].mean()
    assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) > 0.95


def test_undistort_identity_and_bilinear_sample():
    img = np.arange(100.0).reshape(10, 10)
    K = np.array([[10.0, 0, 5], [0, 10, 5], [0, 0, 1]])
    np.testing.assert_allclose(ttools.undistort_image(img, K, np.zeros(2)), img, atol=1e-9)
    rng = np.random.default_rng(0)
    u, v = rng.uniform(-2, 11, 500), rng.uniform(-2, 11, 500)
    np.testing.assert_array_equal(ttools._bilinear_sample(img, u, v),
                                  jtools._bilinear_sample(img, u, v))


@pytest.mark.parametrize("pattern,square", [((8, 6), 1.0), ((9, 7), 0.03), ((4, 11), 0.5)])
def test_chessboard_object_points_equal_jax(pattern, square):
    np.testing.assert_array_equal(ttools.chessboard_object_points(pattern, square),
                                  jtools.chessboard_object_points(pattern, square))


def test_rename(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ["b.png", "a.png", "c.jpg", "D.JPEG", "notes.txt"]:
        (src / name).write_bytes(name.encode())
    got = ttools.rename_image_filenames(str(src), str(tmp_path / "port"), start_index=3)
    want = jtools.rename_image_filenames(str(src), str(tmp_path / "jax"), start_index=3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "rgb_00003.png", "rgb_00004.png", "rgb_00005.png", "rgb_00006.png"]
    assert [open(p, "rb").read() for p in got] == [b"D.JPEG", b"a.png", b"b.png", b"c.jpg"]


def _chessboard_image():
    """A rendered 9x7-square board (8x6 inner corners) on a gray margin."""
    img = np.full((240, 320), 128, np.uint8)
    for r in range(7):
        for c in range(9):
            img[30 + 25 * r:55 + 25 * r, 45 + 25 * c:70 + 25 * c] = 255 * ((r + c) % 2)
    return img


def test_find_chessboard_corners_without_opencv_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(NotImplementedError, match="opencv"):
        ttools.find_chessboard_corners(_chessboard_image())


def test_find_chessboard_corners_equals_jax_with_opencv():
    pytest.importorskip("cv2")
    img = _chessboard_image()
    got, want = ttools.find_chessboard_corners(img), jtools.find_chessboard_corners(img)
    assert got is not None and got.shape == (48, 2)
    np.testing.assert_array_equal(got, want)
    assert ttools.find_chessboard_corners(np.full((60, 80), 128, np.uint8)) is None


def test_rodrigues_and_T_to_rt34_equal_jax():
    rng = np.random.default_rng(0)
    rvec = np.concatenate([rng.normal(0, 1, (64, 3)), rng.normal(0, 1e-6, (8, 3)),
                           np.zeros((1, 3))]).astype(np.float32)
    got = tlie.rodrigues(torch.from_numpy(rvec)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.rodrigues(jnp.asarray(rvec))),
                               atol=2e-6, rtol=0)
    want = Rotation.from_rotvec(rvec.astype(np.float64)).as_matrix()
    r64 = tlie.rodrigues(torch.from_numpy(rvec.astype(np.float64))).numpy()
    np.testing.assert_allclose(r64, want, atol=1e-12, rtol=0)
    T = rng.normal(size=(5, 2, 4, 4)).astype(np.float32)
    got = tlie.T_to_rt34(torch.from_numpy(T))
    assert got.shape == (5, 2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlie.T_to_rt34(jnp.asarray(T))))


def test_pixel2cam_and_homogeneous_equal_jax():
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 640, (3, 50, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 9.0, (3, 50)).astype(np.float32)
    tc = tcam.Camera.create(615.0, 612.5, 320.3, 239.7)
    jc = jcam.Camera.create(615.0, 612.5, 320.3, 239.7)
    got = tcam.pixel2cam(torch.from_numpy(uv), tc, torch.from_numpy(depth)).numpy()
    want = np.asarray(jcam.pixel2cam(jnp.asarray(uv), jc, jnp.asarray(depth)))
    np.testing.assert_allclose(got, want, atol=0, rtol=1e-6)
    back = tcam.cam2pixel(torch.from_numpy(got), tc).numpy()
    np.testing.assert_allclose(back, uv, atol=1e-3)
    p = rng.normal(size=(4, 7, 3)).astype(np.float32)
    h = tcam.homogeneous(torch.from_numpy(p))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jcam.homogeneous(jnp.asarray(p))))
    assert h.dtype == torch.float32 and h.shape == (4, 7, 4)
