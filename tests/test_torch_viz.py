"""Port parity for the visual exports: annotated frames, the HTML viewer and
the trajectory plots, the PyTorch package against the JAX package.

The annotated frames and the viewer's HTML are equal to the JAX package's;
the plots come from the same matplotlib code and are checked as written
files (the port imports matplotlib inside the functions only).
"""

import numpy as np
from PIL import Image

from monocular_visual_odometry_tpu.viz import draw as jdraw
from monocular_visual_odometry_tpu.viz import viewer as jviewer
from monocular_visual_odometry_tpu_torch.viz import draw as tdraw
from monocular_visual_odometry_tpu_torch.viz import export_viewer
from monocular_visual_odometry_tpu_torch.viz import trajectory as ttraj


def _trajectory(n=24, seed=0):
    rng = np.random.default_rng(seed)
    est = np.tile(np.eye(4), (n, 1, 1))
    est[:, 0, 3] = np.linspace(0, 2, n)
    est[:, 2, 3] = np.linspace(0, 3, n)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    est[:, :3, :3] = q
    gt = est.copy()
    gt[:, :3, 3] = 1.7 * est[:, :3, 3] + rng.normal(0, 0.01, (n, 3))
    return est, gt, rng.uniform(-1, 4, (50, 3)), rng.integers(0, n, 50)


def test_draw_frame_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 80)).astype(np.uint8)
    # inside, on the border and outside the image; some invalid
    kpts = np.concatenate([rng.uniform([0, 0], [80, 60], (40, 2)),
                           [[0.0, 0.0], [79.4, 59.6], [-3.0, 10.0], [85.0, 30.0]]])
    valid = rng.uniform(size=len(kpts)) < 0.8
    inl = rng.uniform(size=len(kpts)) < 0.5
    got = tdraw.draw_frame(img, kpts, valid, inlier_mask=inl,
                           out_path=str(tmp_path / "sub" / "f.png"))
    want = jdraw.draw_frame(img, kpts, valid, inlier_mask=inl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "sub" / "f.png")), want)
    np.testing.assert_array_equal(tdraw.draw_frame(img, kpts, valid),
                                  jdraw.draw_frame(img, kpts, valid))


def test_export_viewer_html_equals_jax(tmp_path):
    est, gt, mp, created = _trajectory()
    gray = np.random.default_rng(1).uniform(0, 300, len(mp))
    kw = dict(map_pts=mp, map_gray=gray, map_created_idx=created,
              keyframe_indices=np.array([0, 5, 11]), title="t")
    a = export_viewer(est, gt, out_path=str(tmp_path / "t" / "v.html"), **kw)
    b = jviewer.export_viewer(est, gt, out_path=str(tmp_path / "j" / "v.html"), **kw)
    assert open(a).read() == open(b).read()
    a = export_viewer(est[:1], out_path=str(tmp_path / "t1.html"))
    b = jviewer.export_viewer(est[:1], out_path=str(tmp_path / "j1.html"))
    assert open(a).read() == open(b).read()


def test_plot_and_animation_written(tmp_path):
    est, gt, mp, created = _trajectory()
    p = ttraj.plot_trajectory(est, gt, mp, keyframes=est[::6], new_pts=mp[:5],
                              map_gray=np.full(len(mp), 128.0),
                              out_path=str(tmp_path / "plot" / "t.png"), title="x")
    assert p == str(tmp_path / "plot" / "t.png")
    assert Image.open(p).size[0] > 500
    g = ttraj.animate_trajectory(est, gt, mp, created, out_path=str(tmp_path / "t.gif"),
                                 max_anim_frames=12)
    im = Image.open(g)
    assert im.format == "GIF" and im.n_frames >= 12
