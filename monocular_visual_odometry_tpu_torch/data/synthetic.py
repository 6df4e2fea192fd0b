"""Synthetic scenes, sequences and correspondence sets with exact ground
truth (numpy only).

Copy of ``monocular_visual_odometry_tpu.data.synthetic``, draw for draw:

- scenes: the textured room of :func:`default_scene`, the occluders and
  natural/repeated textures of :func:`adversarial_scene`, the single
  dominant plane of :func:`planar_scene` (``Plane``, ``Sphere``, ``Box``);
- trajectories: :func:`make_trajectory`, :func:`make_adversarial_trajectory`,
  :func:`make_planar_trajectory`;
- the ray-traced :func:`render_frame`; :func:`render_sequence_arrays` returns
  the benchmark frames in memory, :func:`render_sequence` writes them as
  lossless PNGs in the reference's dataset layout;
- :func:`perturb_frames`, the photometric perturbations of the robustness
  matrix (noise, blur, exposure, low contrast, JPEG, vignette);
- :func:`synthesize_two_view` / :func:`synthesize_pnp_scene`, exact 2-D/3-D
  correspondence sets for the geometry tests.

No scipy: the Euler rotations (:func:`_from_euler`) and the blur's box
filter are the port's own numpy code, with scipy's arithmetic in scipy's
order, so every frame equals the JAX package's.
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


def _pink_texture(rng: np.random.Generator, size: int = 1024,
                  beta: float = 1.2) -> np.ndarray:
    """Natural-image texture: random phase with a 1/f^beta amplitude
    spectrum (smooth gradients, few sharp corners), [size,size] in [0,1]."""
    f = np.fft.fftfreq(size)
    fx, fy = np.meshgrid(f, f)
    r = np.sqrt(fx * fx + fy * fy)
    r[0, 0] = 1.0 / size
    amp = r ** (-beta)
    phase = rng.uniform(0.0, 2.0 * np.pi, (size, size))
    img = np.real(np.fft.ifft2(amp * np.exp(1j * phase)))
    return (img - img.min()) / (np.ptp(img) + 1e-12)


def _repeated_texture(rng: np.random.Generator, size: int = 1024,
                      period: int = 64) -> np.ndarray:
    """Exact periodic tiling of one random high-contrast patch: every corner,
    and its descriptor, recurs every ``period`` texels. [size,size] in [0,1]."""
    tile = np.zeros((period, period), dtype=np.float64)
    for cell in (4, 8, 16):
        n = max(period // cell, 1)
        tile += np.kron(rng.uniform(0, 1, (n, n)),
                        np.ones((cell, cell)))[:period, :period]
    tile /= 3.0
    tile = 0.15 + 0.7 * (tile > 0.5) + 0.15 * tile
    reps = size // period + 1
    return np.clip(np.tile(tile, (reps, reps))[:size, :size], 0.0, 1.0)


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


@dataclass
class Sphere:
    """Textured sphere: a smooth occluder whose silhouette sweeps across the
    background as the camera moves."""

    center: np.ndarray
    radius: float
    tex: np.ndarray
    scale: float = 200.0   # texels per radian

    def intersect(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        oc = (origin - self.center)[:, None]
        a = np.sum(dirs * dirs, axis=0)
        b = 2.0 * np.sum(oc * dirs, axis=0)
        c = float(oc[:, 0] @ oc[:, 0]) - self.radius * self.radius
        disc = b * b - 4 * a * c
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t0 = (-b - sq) / (2 * a)
            t1 = (-b + sq) / (2 * a)
        t_hit = np.where(t0 > 0.05, t0, t1)
        return np.where((disc > 0) & (t_hit > 0.05), t_hit, np.inf)

    def shade(self, X: np.ndarray) -> np.ndarray:
        d = X - self.center[:, None]
        d = d / (np.linalg.norm(d, axis=0, keepdims=True) + 1e-12)
        theta = np.arctan2(d[1], d[0])
        phi = np.arccos(np.clip(d[2], -1, 1))
        return _tex_lookup(self.tex, theta * self.scale, phi * self.scale)


@dataclass
class Box:
    """Textured axis-aligned box: a hard occluder with sharp silhouette edges."""

    p_min: np.ndarray
    p_max: np.ndarray
    tex: np.ndarray
    scale: float = 150.0   # texels per world unit

    def intersect(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
            t_lo = (self.p_min[:, None] - origin[:, None]) * inv
            t_hi = (self.p_max[:, None] - origin[:, None]) * inv
        t_near = np.max(np.minimum(t_lo, t_hi), axis=0)
        t_far = np.min(np.maximum(t_lo, t_hi), axis=0)
        hit = (t_near <= t_far) & (t_far > 0.05)
        t_hit = np.where(t_near > 0.05, t_near, t_far)
        return np.where(hit, t_hit, np.inf)

    def shade(self, X: np.ndarray) -> np.ndarray:
        """Face-dependent planar UV: the dominant-normal axis is dropped."""
        ctr = (self.p_min + self.p_max) / 2.0
        half = (self.p_max - self.p_min) / 2.0 + 1e-12
        rel = (X - ctr[:, None]) / half[:, None]
        axis = np.argmax(np.abs(rel), axis=0)
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        cols = np.arange(X.shape[1])
        return _tex_lookup(self.tex, X[u_axis, cols] * self.scale,
                           X[v_axis, cols] * self.scale)


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


def adversarial_scene(seed: int = 100) -> list:
    """Scene family B, for evaluation: natural 1/f textures (weak, sparse
    FAST responses), an exactly repeated far wall (aliased descriptors) and
    box/sphere occluders at 1.5-5 units (parallax discontinuities)."""
    rng = np.random.default_rng(seed)
    z = np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    y = np.array([0.0, 1.0, 0.0])
    return [
        Plane(p0=np.array([0.0, 0.0, 9.0]), n=-z, u=x, v=y,
              tex=_repeated_texture(rng, period=64), scale=80.0),
        Plane(p0=np.array([0.0, 1.3, 0.0]), n=-y, u=x, v=z,
              tex=_pink_texture(rng), scale=110.0),
        Plane(p0=np.array([0.0, -1.6, 0.0]), n=y, u=x, v=z,
              tex=_pink_texture(rng), scale=110.0),
        Plane(p0=np.array([-2.8, 0.0, 0.0]), n=x, u=z, v=y,
              tex=_pink_texture(rng, beta=1.5), scale=95.0),
        Plane(p0=np.array([2.8, 0.0, 0.0]), n=-x, u=z, v=y,
              tex=_pink_texture(rng, beta=1.5), scale=95.0),
        Box(p_min=np.array([-1.6, 0.1, 2.6]), p_max=np.array([-0.9, 1.3, 3.4]),
            tex=_multiscale_texture(rng), scale=220.0),
        Box(p_min=np.array([0.7, -0.4, 4.2]), p_max=np.array([1.5, 1.3, 5.1]),
            tex=_pink_texture(rng, beta=0.9), scale=260.0),
        Sphere(center=np.array([-0.2, -0.7, 3.6]), radius=0.45,
               tex=_multiscale_texture(rng), scale=260.0),
        Sphere(center=np.array([1.9, 0.4, 6.5]), radius=0.7,
               tex=_pink_texture(rng, beta=1.0), scale=300.0),
        Box(p_min=np.array([-0.5, 0.6, 5.8]), p_max=np.array([0.4, 1.3, 6.6]),
            tex=_repeated_texture(rng, period=48), scale=240.0),
    ]


def planar_scene(seed: int = 200) -> list:
    """Scene family C: a frontal textured wall at z=6 filling the view (the
    regime where two-view init must go through the homography) and a
    distant floor strip, mostly out of frame."""
    rng = np.random.default_rng(seed)
    z = np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    y = np.array([0.0, 1.0, 0.0])
    return [
        Plane(p0=np.array([0.0, 0.0, 6.0]), n=-z, u=x, v=y,
              tex=_multiscale_texture(rng), scale=90.0),
        Plane(p0=np.array([0.0, 6.0, 0.0]), n=-y, u=x, v=z,
              tex=_multiscale_texture(rng), scale=60.0),
    ]


def _quat_mul(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quaternion product p * q (scalar last), scipy's arithmetic."""
    cross = np.cross(p[:3], q[:3])
    return np.array([p[3] * q[0] + q[3] * p[0] + cross[0],
                     p[3] * q[1] + q[3] * p[1] + cross[1],
                     p[3] * q[2] + q[3] * p[2] + cross[2],
                     p[3] * q[3] - p[0] * q[0] - p[1] * q[1] - p[2] * q[2]])


def _from_euler(seq: str, angles) -> np.ndarray:
    """Extrinsic rotation by ``angles`` about the axes of ``seq`` (lower
    case, e.g. ``"yx"``: about y, then about the fixed x), bit for bit as
    scipy's ``Rotation.from_euler(seq, angles).as_matrix()`` computes it:
    the elementary quaternions composed left to right as q_k * ... * q_1
    (scalar last), then the rotation matrix of that quaternion."""
    angles = np.atleast_1d(np.asarray(angles, dtype=np.float64))
    if not seq or len(seq) != len(angles) or set(seq) - set("xyz"):
        raise ValueError(f"_from_euler: axes {seq!r} for {len(angles)} angle(s)")
    q = None
    for axis, angle in zip(seq, angles):
        e = np.zeros(4)
        e["xyz".index(axis)] = np.sin(angle / 2)
        e[3] = np.cos(angle / 2)
        q = e if q is None else _quat_mul(e, q)
    x, y, z, w = q
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
        poses[i, :3, :3] = _from_euler("yx", [yaw[i], pitch[i]])
        poses[i, :3, 3] = [px[i], py[i], pz[i]]
        poses[i, 3, 3] = 1.0
    return poses


def make_adversarial_trajectory(n_frames: int, seed: int = 0,
                                translation_step: float = 0.05) -> np.ndarray:
    """Three smooth segments, [N,4,4] T_w_c: frames [0, n/3) translation
    dominant; [n/3, 2n/3) rotation dominant (yaw sweeps +/-14 deg on a fixed
    20-frame period, forward step/3); [2n/3, n) low-parallax creep (step/8)."""
    ts = np.arange(n_frames, dtype=np.float64)
    n1, n2 = n_frames // 3, 2 * n_frames // 3
    speed = np.full(n_frames, translation_step)
    speed[n1:n2] = translation_step / 3.0
    speed[n2:] = translation_step / 8.0
    speed = np.convolve(speed, np.ones(7) / 7.0, mode="same")
    pz = np.concatenate([[0.0], np.cumsum(speed)[:-1]])
    px = 0.35 * np.sin(ts * 2 * np.pi / max(n_frames, 60))
    py = 0.06 * np.sin(ts * 2 * np.pi / 41.0)
    yaw = 0.05 * np.sin(ts * 2 * np.pi / 80.0)
    sweep = 0.25 * np.sin((ts - n1) * 2 * np.pi / 20.0)
    ramp = np.clip((ts - n1) / 6.0, 0, 1) * np.clip((n2 - ts) / 6.0, 0, 1)
    yaw = yaw + sweep * ramp
    pitch = 0.025 * np.sin(ts * 2 * np.pi / 57.0)
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _from_euler("yx", [yaw[i], pitch[i]])
        poses[i, :3, 3] = [px[i], py[i], pz[i]]
        poses[i, 3, 3] = 1.0
    return poses


def make_planar_trajectory(n_frames: int, seed: int = 0,
                           lateral_step: float = 0.05) -> np.ndarray:
    """Wall-facing trajectory for :func:`planar_scene`: lateral translation
    with a slow approach sway and gentle yaw, [N,4,4] T_w_c."""
    ts = np.arange(n_frames, dtype=np.float64)
    px = ts * lateral_step * 0.8
    py = 0.05 * np.sin(ts * 2 * np.pi / 43.0)
    pz = 0.4 * np.sin(ts * 2 * np.pi / max(n_frames * 2, 80))
    yaw = 0.06 * np.sin(ts * 2 * np.pi / max(n_frames, 70))
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _from_euler("y", yaw[i])
        poses[i, :3, 3] = [px[i], py[i], pz[i]]
        poses[i, 3, 3] = 1.0
    return poses


def render_frame(T_w_c: np.ndarray, objects: list, K: np.ndarray,
                 height: int = 480, width: int = 640) -> np.ndarray:
    """Render one grayscale frame by exact ray tracing (planes, spheres,
    boxes) with a z-buffer. Returns uint8 [H, W]."""
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


# ---------------------------------------------------------------------------
# photometric perturbations (the robustness matrix)
# ---------------------------------------------------------------------------


def _box_blur_rows(frames: np.ndarray, k: int) -> np.ndarray:
    """``scipy.ndimage.convolve1d(frames, np.ones(k, np.float32) / k, axis=2,
    mode="nearest")`` in numpy, equal to it: the rows are edge-padded and
    summed in f64 in scipy's order (an odd, symmetric box folds the pairs
    about the centre, outermost first; an even one sums left to right after
    its last tap, one pixel to the right of centre), then rounded to f32."""
    w = float(np.float32(1.0) / np.float32(k))
    s1, s2 = k // 2, k - k // 2 - 1
    origin = 0 if k & 1 else -1
    x = np.pad(frames.astype(np.float64), [(0, 0)] * (frames.ndim - 1)
               + [(s1 + origin, s2 - origin)], mode="edge")
    width = frames.shape[-1]
    tap = lambda l: x[..., s1 + l:s1 + l + width]
    if k & 1:
        acc = tap(0) * w
        for l in range(-s1, 0):
            acc = acc + (tap(l) + tap(-l)) * w
    else:
        acc = tap(s2) * w
        for l in range(-s1, s2):
            acc = acc + tap(l) * w
    return acc.astype(np.float32)


def perturb_frames(frames: np.ndarray, kind: str, severity: float,
                   seed: int = 0) -> np.ndarray:
    """Apply a photometric perturbation to an [N,H,W] sequence (float or
    uint8); returns float32 in [0,255].

    - ``noise``       additive Gaussian noise, sigma = ``severity`` gray levels
    - ``blur``        horizontal box blur of width ``severity`` px
    - ``exposure``    per-frame gain 1 +/- 0.5*severity and bias
                      +/- 20*severity gray levels, out of phase
    - ``low_contrast`` squeeze toward the frame mean by factor ``severity``
    - ``jpeg``        blockwise 8x8 DCT quantization, the Q50 luminance table
                      scaled by ``severity``
    - ``vignette``    cos^4 radial falloff raised to ``severity``
    """
    rng = np.random.default_rng(seed)
    out = frames.astype(np.float32).copy()
    n = out.shape[0]
    if kind == "noise":
        out = out + rng.normal(0.0, severity, out.shape).astype(np.float32)
    elif kind == "blur":
        k = max(int(round(severity)), 1)
        if k > 1:
            out = _box_blur_rows(out, k)
    elif kind == "exposure":
        gain = 1.0 + 0.5 * severity * np.sin(np.arange(n) * 0.41)
        bias = 20.0 * severity * np.cos(np.arange(n) * 0.23)
        out = out * gain[:, None, None] + bias[:, None, None]
    elif kind == "low_contrast":
        mean = out.mean(axis=(1, 2), keepdims=True)
        out = mean + float(severity) * (out - mean)
    elif kind == "jpeg":
        out = np.stack([_jpeg_artifacts(f, severity) for f in out])
    elif kind == "vignette":
        H, W = out.shape[1:]
        us, vs = np.meshgrid(np.arange(W) - W / 2, np.arange(H) - H / 2)
        fx = float(W)
        cos_t = fx / np.sqrt(us * us + vs * vs + fx * fx)
        gain = (cos_t ** 4) ** float(severity)
        out = out * gain[None, :, :].astype(np.float32)
    else:
        raise ValueError(f"unknown perturbation kind: {kind}")
    return np.clip(out, 0.0, 255.0).astype(np.float32)


# the JPEG luminance quantization table (Annex K of the JPEG standard), the
# quality-50 baseline; severity scales it
_JPEG_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)


def _jpeg_artifacts(img: np.ndarray, severity: float) -> np.ndarray:
    """Blockwise 8x8 DCT quantization (JPEG's lossy core, no entropy
    coding); ``severity`` scales the Q50 table."""
    H, W = img.shape
    Hp, Wp = (H + 7) // 8 * 8, (W + 7) // 8 * 8
    padded = np.zeros((Hp, Wp), np.float64)
    padded[:H, :W] = img
    padded[H:, :W] = img[-1:, :]
    padded[:, W:] = padded[:, W - 1:W]
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    C[0] /= np.sqrt(2)
    blocks = padded.reshape(Hp // 8, 8, Wp // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ab,ijbc,dc->ijad", C, blocks - 128.0, C)
    q = np.maximum(_JPEG_Q50 * severity, 1.0)
    coef = np.round(coef / q) * q
    rec = np.einsum("ba,ijbc,cd->ijad", C, coef, C) + 128.0
    out = rec.transpose(0, 2, 1, 3).reshape(Hp, Wp)
    return out[:H, :W]


# ---------------------------------------------------------------------------
# exact correspondence generators (geometry tests; no rendering)
# ---------------------------------------------------------------------------


@dataclass
class TwoViewScene:
    """Exact two-view correspondence set with known relative pose."""

    pts_w: np.ndarray      # [N,3] world points
    uv1: np.ndarray        # [N,2] pixels in view 1
    uv2: np.ndarray        # [N,2] pixels in view 2
    T_w_c1: np.ndarray     # [4,4]
    T_w_c2: np.ndarray
    K: np.ndarray          # [3,3]

    @property
    def T_c1_c2(self) -> np.ndarray:
        return np.linalg.inv(self.T_w_c1) @ self.T_w_c2


def _project(pts_w, T_w_c, K):
    Tcw = np.linalg.inv(T_w_c)
    pc = pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3] * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    return uv, pc[:, 2]


def synthesize_two_view(n: int = 200, seed: int = 0, planar: bool = False,
                        noise_px: float = 0.0, outlier_frac: float = 0.0,
                        baseline: float = 0.3) -> TwoViewScene:
    """Random 3-D points (or a tilted plane if ``planar``) seen from two
    poses, in front of both cameras and inside a 640x480 image; optional
    pixel noise and gross outliers."""
    rng = np.random.default_rng(seed)
    K = np.array([[615.0, 0, 320], [0, 615.0, 240], [0, 0, 1]])
    T1 = np.eye(4)
    T2 = np.eye(4)
    T2[:3, :3] = _from_euler("yxz", rng.uniform(-0.08, 0.08, 3))
    T2[:3, 3] = np.array([baseline, 0.05, 0.1]) * (1 + 0.2 * rng.standard_normal(3))

    pts = np.zeros((0, 3))
    while len(pts) < n:
        m = 4 * n
        if planar:
            xy = rng.uniform(-3, 3, size=(m, 2))
            cand = np.stack([xy[:, 0], xy[:, 1], np.full(m, 5.0)], axis=1)
            Rp = _from_euler("xy", [0.3, 0.2])
            cand = (cand - [0, 0, 5.0]) @ Rp.T + [0, 0, 5.0]
        else:
            cand = np.stack(
                [rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(2.5, 9.0, m)],
                axis=1,
            )
        uv1, z1 = _project(cand, T1, K)
        uv2, z2 = _project(cand, T2, K)
        ok = (z1 > 0.2) & (z2 > 0.2)
        for uv in (uv1, uv2):
            ok &= (uv[:, 0] > 5) & (uv[:, 0] < 635) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
        pts = np.concatenate([pts, cand[ok]])[:n]
    uv1, _ = _project(pts, T1, K)
    uv2, _ = _project(pts, T2, K)
    if noise_px > 0:
        uv1 = uv1 + rng.normal(0, noise_px, uv1.shape)
        uv2 = uv2 + rng.normal(0, noise_px, uv2.shape)
    if outlier_frac > 0:
        n_out = int(n * outlier_frac)
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return TwoViewScene(pts, uv1.astype(np.float64), uv2.astype(np.float64), T1, T2, K)


@dataclass
class PnPScene:
    """3-D world points and their pixels in a camera with known pose."""

    pts_w: np.ndarray     # [N,3]
    uv: np.ndarray        # [N,2]
    T_w_c: np.ndarray     # [4,4]
    K: np.ndarray


def synthesize_pnp_scene(n: int = 100, seed: int = 0, noise_px: float = 0.0,
                         outlier_frac: float = 0.0) -> PnPScene:
    """Random 3-D points seen from one random pose; optional pixel noise and
    gross outliers."""
    rng = np.random.default_rng(seed)
    K = np.array([[615.0, 0, 320], [0, 615.0, 240], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = _from_euler("yxz", rng.uniform(-0.3, 0.3, 3))
    T[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    pts = np.zeros((0, 3))
    while len(pts) < n:
        m = 4 * n
        cand = np.stack(
            [rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(2.0, 9.0, m)], axis=1
        )
        uv, z = _project(cand, T, K)
        ok = (z > 0.2) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
        pts = np.concatenate([pts, cand[ok]])[:n]
    uv, _ = _project(pts, T, K)
    if noise_px > 0:
        uv = uv + rng.normal(0, noise_px, uv.shape)
    if outlier_frac > 0:
        n_out = int(n * outlier_frac)
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return PnPScene(pts, uv, T, K)
