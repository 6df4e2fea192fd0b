"""Synthetic benchmark sequence with exact ground truth (numpy only).

Copy of the parts of ``monocular_visual_odometry_tpu.data.synthetic`` that
render the benchmark sequence: the textured room of :func:`default_scene`,
the smooth trajectory of :func:`make_trajectory` and the ray-traced
:func:`render_frame`. :func:`render_sequence_arrays` returns the frames in
memory; :func:`render_sequence` writes them as lossless PNGs in the
reference's dataset layout, as the JAX package's ``render_sequence`` does.
The rotations are built in numpy (no scipy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from monocular_visual_odometry_tpu_torch.runtime import write_png
from monocular_visual_odometry_tpu_torch.utils import io as vio


def _multiscale_texture(rng: np.random.Generator, size: int = 1024) -> np.ndarray:
    """High-contrast texture with structure at many scales, [size,size] in [0,1]."""
    tex = np.zeros((size, size), dtype=np.float64)
    for cell in (8, 16, 32, 64):
        n = size // cell
        coarse = rng.uniform(0.0, 1.0, size=(n, n))
        tex += np.kron(coarse, np.ones((cell, cell)))
    tex /= 4.0
    tex = 0.15 + 0.7 * (tex > 0.5) + 0.15 * tex
    return np.clip(tex, 0.0, 1.0)


def _tex_lookup(tex: np.ndarray, tu: np.ndarray, tv: np.ndarray) -> np.ndarray:
    """Bilinear wrap-around texture fetch (tu/tv in texels)."""
    th, tw = tex.shape
    iu = np.mod(tu, tw - 1)
    iv = np.mod(tv, th - 1)
    i0 = np.clip(np.floor(iv).astype(int), 0, th - 2)
    j0 = np.clip(np.floor(iu).astype(int), 0, tw - 2)
    fv, fu = iv - i0, iu - j0
    return (tex[i0, j0] * (1 - fu) * (1 - fv)
            + tex[i0, j0 + 1] * fu * (1 - fv)
            + tex[i0 + 1, j0] * (1 - fu) * fv
            + tex[i0 + 1, j0 + 1] * fu * fv)


@dataclass
class Plane:
    """Textured plane: point p0, unit normal n, in-plane axes (u, v)."""

    p0: np.ndarray
    n: np.ndarray
    u: np.ndarray
    v: np.ndarray
    tex: np.ndarray
    scale: float = 100.0

    def intersect(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        denom = self.n @ dirs
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = ((self.p0 - origin) @ self.n) / denom
        return np.where((np.abs(denom) > 1e-9) & (t_hit > 0.05), t_hit, np.inf)

    def shade(self, X: np.ndarray) -> np.ndarray:
        rel = X - self.p0[:, None]
        return _tex_lookup(self.tex, (self.u @ rel) * self.scale,
                           (self.v @ rel) * self.scale)


def default_scene(seed: int = 0) -> list[Plane]:
    """A room: far wall, floor, ceiling and two side walls."""
    rng = np.random.default_rng(seed)
    mk = lambda: _multiscale_texture(rng)
    z = np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    y = np.array([0.0, 1.0, 0.0])
    return [
        Plane(p0=np.array([0.0, 0.0, 8.0]), n=-z, u=x, v=y, tex=mk(), scale=80.0),
        Plane(p0=np.array([0.0, 1.2, 0.0]), n=-y, u=x, v=z, tex=mk(), scale=100.0),
        Plane(p0=np.array([0.0, -1.5, 0.0]), n=y, u=x, v=z, tex=mk(), scale=100.0),
        Plane(p0=np.array([-2.5, 0.0, 0.0]), n=x, u=z, v=y, tex=mk(), scale=90.0),
        Plane(p0=np.array([2.5, 0.0, 0.0]), n=-x, u=z, v=y, tex=mk(), scale=90.0),
    ]


def _rot_yx(yaw: float, pitch: float) -> np.ndarray:
    """Extrinsic rotation about y by ``yaw``, then about x by ``pitch``,
    bit for bit as scipy's ``Rotation.from_euler("yx", [yaw, pitch])``
    computes it: the quaternion product q_x * q_y (scalar last), then the
    rotation matrix of that quaternion."""
    p = np.array([np.sin(pitch / 2), 0.0, 0.0, np.cos(pitch / 2)])
    q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
    cross = np.cross(p[:3], q[:3])
    x = p[3] * q[0] + q[3] * p[0] + cross[0]
    y = p[3] * q[1] + q[3] * p[1] + cross[1]
    z = p[3] * q[2] + q[3] * p[2] + cross[2]
    w = p[3] * q[3] - p[0] * q[0] - p[1] * q[1] - p[2] * q[2]
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    return np.array([[x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw)],
                     [2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw)],
                     [2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2]])


def make_trajectory(n_frames: int, seed: int = 0, translation_step: float = 0.04,
                    lateral_amp: float = 0.6, yaw_amp: float = 0.08) -> np.ndarray:
    """Smooth forward+lateral trajectory with gentle yaw/pitch, [N,4,4] T_w_c."""
    ts = np.arange(n_frames, dtype=np.float64)
    px = lateral_amp * np.sin(ts * 2 * np.pi / max(n_frames, 60))
    py = 0.08 * np.sin(ts * 2 * np.pi / 37.0)
    pz = ts * translation_step
    yaw = yaw_amp * np.sin(ts * 2 * np.pi / max(n_frames, 80))
    pitch = 0.03 * np.sin(ts * 2 * np.pi / 53.0)
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _rot_yx(yaw[i], pitch[i])
        poses[i, :3, 3] = [px[i], py[i], pz[i]]
        poses[i, 3, 3] = 1.0
    return poses


def render_frame(T_w_c: np.ndarray, objects: list, K: np.ndarray,
                 height: int = 480, width: int = 640) -> np.ndarray:
    """Render one grayscale frame by exact ray tracing with a z-buffer.
    Returns uint8 [H, W]."""
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([us.ravel(), vs.ravel(), np.ones(us.size)], axis=0)
    dirs = T_w_c[:3, :3] @ (Kinv @ pix)
    origin = T_w_c[:3, 3]
    best_t = np.full(us.size, np.inf)
    img = np.zeros(us.size, dtype=np.float64)
    for obj in objects:
        t_hit = obj.intersect(origin, dirs)
        valid = t_hit < best_t
        if not valid.any():
            continue
        X = origin[:, None] + dirs[:, valid] * t_hit[valid]
        img[valid] = obj.shade(X)
        best_t[valid] = t_hit[valid]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(height, width)


def render_sequence_arrays(n_frames: int = 60, seed: int = 0,
                           height: int = 480, width: int = 640,
                           fx: float = 615.0, fy: float = 615.0,
                           cx: float = 320.0, cy: float = 240.0,
                           translation_step: float = 0.04,
                           span: tuple[int, int] | None = None):
    """The benchmark sequence in memory: (frames [N,H,W] uint8, GT poses
    [N,4,4]); the same frames ``render_sequence`` writes to disk. ``span``
    (lo, hi) renders only frames lo..hi-1 (the poses stay all N), so that
    parts of a sequence can be rendered in parallel."""
    planes = default_scene(seed)
    poses = make_trajectory(n_frames, seed, translation_step=translation_step)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    lo, hi = span or (0, n_frames)
    frames = np.stack([render_frame(poses[i], planes, K, height, width)
                       for i in range(lo, hi)])
    return frames, poses


def render_sequence(out_dir: str, n_frames: int = 60, seed: int = 0,
                    height: int = 480, width: int = 640,
                    fx: float = 615.0, fy: float = 615.0,
                    cx: float = 320.0, cy: float = 240.0,
                    translation_step: float = 0.04) -> np.ndarray:
    """Render a full benchmark sequence into ``out_dir`` in the reference's
    dataset layout: ``rgb_%05d.png`` frames + ``cam_traj_truth.txt`` ground
    truth. Returns the [N,4,4] GT poses."""
    os.makedirs(out_dir, exist_ok=True)
    planes = default_scene(seed)
    poses = make_trajectory(n_frames, seed, translation_step=translation_step)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    for i in range(n_frames):
        img = render_frame(poses[i], planes, K, height, width)
        write_png(os.path.join(out_dir, f"rgb_{i:05d}.png"), img)
    vio.write_trajectory(os.path.join(out_dir, "cam_traj_truth.txt"), poses)
    return poses
