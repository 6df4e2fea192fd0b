"""The frozen scene generator: the torch renderer the cells use against its
numpy copy on the same textures and poses, and the numpy copy against the
port's generator it was copied from."""

import numpy as np
import pytest
import torch

from harness import scene, traffic

CAM = dict(fx=615.0, fy=615.0, cx=320.0, cy=240.0)
FRAMES = [0, 41, 149]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_torch_renderer_equals_the_numpy_copy(seed):
    poses = scene.make_trajectory(150, 0.04)[FRAMES]
    K = scene.intrinsics(CAM)
    want = np.stack([scene.render_numpy(p, scene.room(seed, scene.texture_numpy), K, 480, 640)
                     for p in poses])
    got = scene.render_torch(poses, scene.room(seed, lambda d: scene.texture_torch(d, "cpu")),
                             K, 480, 640, "cpu").numpy()
    assert np.array_equal(got, want)


def test_numpy_copy_equals_the_ports_generator():
    from monocular_visual_odometry_tpu_torch.data import synthetic

    seed = 7
    poses = scene.make_trajectory(150, 0.04)
    assert np.array_equal(poses, synthetic.make_trajectory(150, seed, 0.04))
    ours, port = scene.room(seed, scene.texture_numpy), synthetic.default_scene(seed)
    for a, b in zip(ours, port):
        assert np.array_equal(a.tex, b.tex) and a.scale == b.scale
        assert all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("p0", "n", "u", "v"))
    K = scene.intrinsics(CAM)
    assert np.array_equal(scene.render_numpy(poses[77], ours, K, 480, 640),
                          synthetic.render_frame(poses[77], port, K, 480, 640))


def test_the_same_seed_gives_the_same_frames_and_keys():
    mix = {"pass_frames": 3, "translation_step": 0.04}
    a = traffic.render(mix, CAM, 480, 640, 2**31 + 5, "cpu", streams=2)
    b = traffic.render(mix, CAM, 480, 640, 2**31 + 5, "cpu", streams=2)
    assert torch.equal(a.frames, b.frames) and not torch.equal(a.frames[0], a.frames[1])
    assert traffic.derive(2**31 + 5, "key", 0, 1) == traffic.derive(2**31 + 5, "key", 0, 1)
    assert 0 <= traffic.derive(2**40, "key", 3, 9) < 2**62
