"""Port parity: the ORB-class frontend of the PyTorch package against the JAX
package on the same inputs (CPU).

The filters are compared exactly where both sides do the same fp32
operations in the same order (the blocked prefix sum, FAST, NMS, per-cell
top-k). On a rendered frame the keypoint sets may differ by a few
near-tied corners: the pyramid resize is a matrix product whose summation
order differs between the two BLAS builds, which moves Harris scores by a
few ulps. Budgets: >= 98% identical keypoints, >= 99% equal descriptor bits
on the shared keypoints, and the shared keypoints in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu.ops import features as JF
from monocular_visual_odometry_tpu_torch.ops import features as TF


def test_brief_pool_is_the_jax_pattern():
    np.testing.assert_array_equal(TF._POOL_PTS, JF._POOL_PTS)
    np.testing.assert_array_equal(TF._PAIR_I, JF._PAIR_I)
    np.testing.assert_array_equal(TF._PAIR_J, JF._PAIR_J)


def test_atlas_geometry_and_resize_matrices():
    assert TF.atlas_geometry(480, 640, 4, 1.2) == JF.atlas_geometry(480, 640, 4, 1.2)
    for n_out, n_in in [(400, 480), (533, 640), (278, 333)]:
        np.testing.assert_array_equal(TF._interp_matrix(n_out, n_in),
                                      JF._interp_matrix(n_out, n_in))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("r", [2, 3, 15])
def test_box_filter_bit_exact(axis, r):
    img = np.random.default_rng(r).uniform(0, 255, (96, 300)).astype(np.float32) ** 2
    want = np.asarray(JF._box1d(jnp.asarray(img), r, axis))
    got = TF._box1d(torch.from_numpy(img), r, axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_harris_nms_cells_bit_exact():
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (128, 256)) > 0.5).astype(np.float32) * 200 + \
        rng.uniform(0, 30, (128, 256)).astype(np.float32)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    np.testing.assert_array_equal(TF.fast_corner_mask(timg, 20.0).numpy(),
                                  np.asarray(JF.fast_corner_mask(jimg, 20.0)))
    hj = np.array(JF.harris_response(jimg))
    ht = TF.harris_response(timg).numpy()
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(TF._nms3(torch.from_numpy(hj)).numpy(),
                                  np.asarray(JF._nms3(jnp.asarray(hj))))
    score = np.where(np.asarray(JF._nms3(jnp.asarray(hj))), hj, -np.inf).astype(np.float32)
    for a, b in zip(TF.cell_topk(torch.from_numpy(score), 16, 8),
                    JF.cell_topk(jnp.asarray(score), 16, 8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def frame_features():
    planes = jsyn.default_scene(0)
    K = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])
    pose = jsyn.make_trajectory(10, seed=0, translation_step=0.05)[3]
    img = jsyn.render_frame(pose, planes, K).astype(np.float32)
    fj = JF.detect_and_describe(jnp.asarray(img), max_keypoints=512)
    ft = TF.detect_and_describe(torch.from_numpy(img), max_keypoints=512)
    return fj, ft


def test_rendered_frame_keypoints(frame_features):
    fj, ft = frame_features
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() == vt.sum() == 512
    kj = [tuple(p) for p in np.asarray(fj.kpts)[vj]]
    kt = [tuple(p) for p in ft.kpts.numpy()[vt]]
    shared = set(kj) & set(kt)
    assert len(shared) >= 0.98 * len(kj), len(shared) / len(kj)
    # the global top-K keeps the JAX order: shared keypoints in the same sequence
    in_j = [p for p in kj if p in shared]
    in_t = [p for p in kt if p in shared]
    assert np.mean([a == b for a, b in zip(in_j, in_t)]) >= 0.98


def test_rendered_frame_descriptors(frame_features):
    fj, ft = frame_features
    kj, kt = np.asarray(fj.kpts), ft.kpts.numpy()
    pos_t = {tuple(p): i for i, p in enumerate(kt)}
    pairs = [(i, pos_t[tuple(p)]) for i, p in enumerate(kj)
             if np.asarray(fj.valid)[i] and tuple(p) in pos_t]
    ij, it = np.asarray(pairs).T
    dj, dt = np.asarray(fj.desc)[ij], ft.desc.numpy()[it]
    assert dt.dtype == np.uint8 and dt.shape[1] == 32
    bits_equal = np.unpackbits(dj ^ dt, axis=1) == 0
    assert bits_equal.mean() >= 0.99, bits_equal.mean()
    # two pyramid levels can map a corner to the same level-0 position
    assert np.mean(ft.levels.numpy()[it] == np.asarray(fj.levels)[ij]) >= 0.99
