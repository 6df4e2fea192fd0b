"""Port parity: two-view and PnP geometry of the PyTorch package against the
JAX package (CPU), with the JAX-drawn minimal sets handed to the port.

JAX's Gumbel draws cannot be reproduced in torch, so each test draws the
minimal sets with JAX's ``sample_minimal_sets`` under the key splits the
JAX functions use (``twoview.py``: ``k_e, k_h = split(key)``; E-RANSAC and
PnP sample with their key directly) and passes them to the port as
``idx``. With the same samples the winning model, the inlier masks and the
pose must agree: masks exactly, R and t within 1e-4 (fp32 solves of the
same systems through different LAPACK builds and summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu.ops import epipolar as JE
from monocular_visual_odometry_tpu.ops import pnp as JP
from monocular_visual_odometry_tpu.ops import ransac as JR
from monocular_visual_odometry_tpu.ops import twoview as JT
from monocular_visual_odometry_tpu.ops.camera import Camera as JCam
from monocular_visual_odometry_tpu_torch.ops import epipolar as TE
from monocular_visual_odometry_tpu_torch.ops import pnp as TP
from monocular_visual_odometry_tpu_torch.ops import ransac as TR
from monocular_visual_odometry_tpu_torch.ops import twoview as TT
from monocular_visual_odometry_tpu_torch.ops.camera import Camera as TCam

TOL = 1e-4
CAP = 256  # fixed capacity; the tail is invalid padding
JCAM = JCam.create(615.0, 615.0, 320.0, 240.0)
TCAM = TCam.create(615.0, 615.0, 320.0, 240.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pad(a, n=CAP):
    out = np.zeros((n,) + a.shape[1:], np.float32)
    out[: len(a)] = a
    return out


def _two_view(seed, planar=False, outliers=0.1):
    sc = jsyn.synthesize_two_view(n=200, seed=seed, planar=planar, noise_px=0.5,
                                  outlier_frac=outliers)
    valid = np.arange(CAP) < 200
    return _pad(sc.uv1), _pad(sc.uv2), valid, sc


@pytest.mark.parametrize("seed,planar", [(0, False), (1, False), (2, True)])
def test_estimate_relative_pose_same_samples(seed, planar):
    uv1, uv2, valid, _ = _two_view(seed, planar)
    key = jax.random.PRNGKey(seed)
    n_hyp = 64
    k_e, k_h = jax.random.split(key)
    idx_e = np.asarray(JR.sample_minimal_sets(k_e, jnp.asarray(valid), n_hyp, 8))
    idx_h = np.asarray(JR.sample_minimal_sets(k_h, jnp.asarray(valid), n_hyp, 4))
    with jax.default_matmul_precision("highest"):
        rj = JT.estimate_relative_pose(jnp.asarray(uv1), jnp.asarray(uv2),
                                       jnp.asarray(valid), JCAM, key, n_hypotheses=n_hyp)
    rt = TT.estimate_relative_pose(_t(uv1), _t(uv2), _t(valid), TCAM, seed,
                                   n_hypotheses=n_hyp, idx_e=_t(idx_e).long(),
                                   idx_h=_t(idx_h).long())
    assert bool(rt.used_homography) == bool(rj.used_homography)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=TOL, rtol=0)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=TOL, rtol=0)
    assert int(rt.inliers.sum()) > 120


def test_essential_ransac_same_samples():
    uv1, uv2, valid, _ = _two_view(3)
    x1 = (uv1 - [320.0, 240.0]) / 615.0
    x2 = (uv2 - [320.0, 240.0]) / 615.0
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = np.asarray(JR.sample_minimal_sets(key, jnp.asarray(valid), 64, 8))
    th = 1.0 / 615.0
    with jax.default_matmul_precision("highest"):
        mj = JE.estimate_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                   key, threshold=th, n_hypotheses=64)
    mt = TE.estimate_essential(_t(x1), _t(x2), _t(valid), 0, threshold=th,
                               n_hypotheses=64, idx=_t(idx).long())
    np.testing.assert_array_equal(mt.inliers.numpy(), np.asarray(mj.inliers))
    # E is defined up to sign and scale. The consensus refit takes the null
    # vector of a Gram matrix of ~180 noisy rows, which squares the condition
    # number of the 8-point system, so fp32 through two LAPACK builds agrees
    # to ~2e-4 of |E| (measured), not to 1e-4: compare at 1e-3 of |E|.
    Ej, Et = np.asarray(mj.model), mt.model.numpy()
    s = np.sign(np.sum(Ej * Et))
    scale = np.linalg.norm(Ej)
    np.testing.assert_allclose(Et * s / scale, Ej / scale, atol=1e-3, rtol=0)


def test_known_pose_filter_and_triangulation():
    uv1, uv2, valid, sc = _two_view(4, outliers=0.2)
    T1 = sc.T_w_c1.astype(np.float32)
    T2 = sc.T_w_c2.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        fj = JT.epipolar_filter_known_pose(jnp.asarray(uv1), jnp.asarray(uv2),
                                           jnp.asarray(valid), JCAM, jnp.asarray(T1),
                                           jnp.asarray(T2), threshold_px=1.0)
        pj, okj = JT.triangulate_with_pose(jnp.asarray(uv1), jnp.asarray(uv2), fj, JCAM,
                                           jnp.asarray(T1), jnp.asarray(T2))
    ft = TT.epipolar_filter_known_pose(_t(uv1), _t(uv2), _t(valid), TCAM, _t(T1), _t(T2),
                                       threshold_px=1.0)
    pt, okt = TT.triangulate_with_pose(_t(uv1), _t(uv2), ft, TCAM, _t(T1), _t(T2))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = okt.numpy()
    assert ok.sum() > 120
    # points at depth 2.5-9: compare relative to their scale
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.2)])
def test_solve_pnp_ransac_same_samples(seed, outliers):
    sc = jsyn.synthesize_pnp_scene(n=150, seed=seed, noise_px=0.5, outlier_frac=outliers)
    pts, uv = _pad(sc.pts_w), _pad(sc.uv)
    valid = np.arange(CAP) < 150
    key = jax.random.PRNGKey(10 + seed)
    idx = np.asarray(JR.sample_minimal_sets(key, jnp.asarray(valid), 128, 3))
    with jax.default_matmul_precision("highest"):
        rj = JP.solve_pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                                 JCAM, key, n_hypotheses=128)
    rt = TP.solve_pnp_ransac(_t(pts), _t(uv), _t(valid), TCAM, 0, n_hypotheses=128,
                             idx=_t(idx).long())
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert bool(rt.ok) and int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.T_c_w.numpy(), np.asarray(rj.T_c_w), atol=TOL, rtol=0)


def test_p3p_and_nullspace_match_jax():
    sc = jsyn.synthesize_pnp_scene(n=60, seed=5)
    pts = sc.pts_w.astype(np.float32)
    uvn = ((sc.uv - [320.0, 240.0]) / 615.0).astype(np.float32)
    idx = np.random.default_rng(0).integers(0, 60, (32, 3))
    Rj, tj, okj = JP.p3p_grunert(jnp.asarray(pts[idx]), jnp.asarray(uvn[idx]))
    Rt, tt, okt = TP.p3p_grunert(_t(pts[idx]), _t(uvn[idx]))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    # Near a double root of Grunert's quartic an ulp of difference in the
    # coefficients moves the root by ~sqrt(eps); there the fp32 solve is
    # itself inaccurate and both packages land on different wrong poses.
    # Compare the solutions that JAX's own pose reprojects the three points
    # within 1e-4 (normalised units, 0.06 px), and require at least 80% of
    # the solutions to be such (54 of 65 here).
    Rj, tj = np.asarray(Rj), np.asarray(tj)
    cam = np.einsum("bsij,bkj->bski", Rj, pts[idx]) + tj[:, :, None, :]
    with np.errstate(invalid="ignore", divide="ignore"):  # slots that hold no solution
        reproj = np.abs(cam[..., :2] / cam[..., 2:] - uvn[idx][:, None]).max(axis=(-1, -2))
    sharp = okj & (reproj < 1e-4)
    assert sharp.sum() >= 0.8 * okj.sum()
    np.testing.assert_allclose(Rt.numpy()[sharp], Rj[sharp], atol=TOL, rtol=0)
    # an error in R moves t by as much times the points' distance (up to
    # 17 units): t within 1e-4 of the farthest point's distance
    t_err = np.abs(tt.numpy()[sharp] - tj[sharp]).max(axis=-1)
    assert np.all(t_err <= TOL * np.linalg.norm(cam, axis=-1).max(axis=-1)[sharp])
    A = np.random.default_rng(1).normal(size=(16, 8, 9)).astype(np.float32)
    vj = np.asarray(JR.nullspace(jnp.asarray(A)))
    vt = TR.nullspace(_t(A)).numpy()
    sign = np.sign(np.sum(vj * vt, axis=-1, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=TOL, rtol=0)


def test_eigh_nullspace_and_epipolar_residuals_match_jax():
    """Two solvers the main path does not call: the eigh nullspace and the
    algebraic epipolar residual."""
    A = np.random.default_rng(2).normal(size=(16, 8, 9)).astype(np.float32)
    vj = np.asarray(JR.nullspace_via_eigh(jnp.asarray(A)))
    vt = TR.nullspace_via_eigh(_t(A)).numpy()
    sign = np.sign(np.sum(vj * vt, axis=-1, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=TOL, rtol=0)

    uv1, uv2, _, sc2 = _two_view(7)
    x1 = ((uv1 - [320.0, 240.0]) / 615.0).astype(np.float32)
    x2 = ((uv2 - [320.0, 240.0]) / 615.0).astype(np.float32)
    T21 = (np.linalg.inv(sc2.T_w_c2) @ sc2.T_w_c1).astype(np.float32)
    rj = np.asarray(JE.epipolar_residuals(jnp.asarray(x1), jnp.asarray(x2),
                                          jnp.asarray(T21[:3, :3]), jnp.asarray(T21[:3, 3])))
    rt = TE.epipolar_residuals(_t(x1), _t(x2), _t(T21[:3, :3]), _t(T21[:3, 3])).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-6, rtol=1e-5)
