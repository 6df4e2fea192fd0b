"""Port parity: Lie-group and camera functions of the PyTorch package against
the JAX package on the same random batches (CPU).

Tolerance 1e-6 (absolute on values of order 1, relative on larger ones):
both sides compute the same fp32 formulas; only the order of a few sums and
the libm transcendental implementations differ, which moves the last bits.
The one SVD-based function gets 2e-6: the two packages reach different
LAPACK builds, whose iterative SVDs agree to a few fp32 ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.ops import camera as jcam
from monocular_visual_odometry_tpu.ops import lie as jlie
from monocular_visual_odometry_tpu_torch.ops import camera as tcam
from monocular_visual_odometry_tpu_torch.ops import lie as tlie

TOL = 1e-6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jlie, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(tlie, fn_name)(*[torch.from_numpy(np.array(a)) for a in arrays])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("fn,shape,scale", [
    ("hat", (16, 3), 1.0), ("vee", (16, 3, 3), 1.0),
    ("so3_exp", (64, 3), 1.0), ("so3_exp", (64, 3), 1e-5),
    ("se3_exp", (64, 6), 0.5),
])
def test_elementwise_maps(fn, shape, scale):
    a = _rand(shape, 0, scale)
    j, t = _both(fn, a)
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0)


def _rotations(n, seed):
    return np.asarray(jlie.so3_exp(jnp.asarray(_rand((n, 3), seed, 0.8))))


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.8], -1)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi.astype(np.float32))))


def test_so3_log_and_se3_log():
    R = _rotations(64, 1)
    j, t = _both("so3_log", R)
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0)
    T = _poses(64, 2)
    j, t = _both("se3_log", T)
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0)


def test_pose_algebra():
    T1, T2 = _poses(32, 3), _poses(32, 4)
    pts = _rand((32, 20, 3), 5, 3.0)
    for fn, args in [("inv_T", (T1,)), ("relative_T", (T1, T2)),
                     ("transform_points", (T1, pts)), ("pose_distance", (T1, T2)),
                     ("rt_to_T", (T1[:, :3, :3], T1[:, :3, 3]))]:
        j, t = _both(fn, *args)
        np.testing.assert_allclose(t, j, atol=TOL, rtol=TOL, err_msg=fn)


def test_project_onto_so3():
    M = _rotations(32, 6) + _rand((32, 3, 3), 7, 0.01)
    j, t = _both("project_onto_so3", M)
    np.testing.assert_allclose(t, j, atol=2 * TOL, rtol=0)


def test_camera_functions():
    cj = jcam.Camera.create(615.0, 615.0, 320.0, 240.0)
    ct = tcam.Camera.create(615.0, 615.0, 320.0, 240.0)
    rng = np.random.default_rng(8)
    uv = rng.uniform([-50, -50], [700, 530], (200, 2)).astype(np.float32)
    p = np.concatenate([rng.normal(size=(200, 2)), rng.uniform(0.5, 8, (200, 1))], -1)
    p = p.astype(np.float32)
    np.testing.assert_allclose(tcam.pixel2cam_norm_plane(torch.from_numpy(uv), ct).numpy(),
                               np.asarray(jcam.pixel2cam_norm_plane(jnp.asarray(uv), cj)),
                               atol=TOL, rtol=0)
    # pixels are O(1e3): compare at the same relative precision
    np.testing.assert_allclose(tcam.cam2pixel(torch.from_numpy(p), ct).numpy(),
                               np.asarray(jcam.cam2pixel(jnp.asarray(p), cj)),
                               atol=0, rtol=TOL)
    np.testing.assert_array_equal(tcam.in_frame(torch.from_numpy(uv), 480, 640).numpy(),
                                  np.asarray(jcam.in_frame(jnp.asarray(uv), 480, 640)))
    np.testing.assert_array_equal(ct.K().numpy(), np.asarray(cj.K))
