"""The benchmark's frames: the plane scene and its trajectory, frozen here.

A copy of the port's ``data/synthetic.py`` parts the cells use (the room of
``default_scene``: five planes with multi-scale textures; ``make_trajectory``;
the ray tracer ``render_frame`` for planes), kept as the yardstick so that a
change to the program's generator cannot change the benchmark's inputs.

Rendering 150 frames of 640x480 in numpy takes about half a minute on one
core, so the cells render with :func:`render_torch`: the same arithmetic in
float64 PyTorch on the card, all pixels of a chunk of frames at once. The
textures come from the seed through numpy's generator exactly as the numpy
copy draws them (:func:`texture_draws`), so both renderers see the same
textures; ``tests/test_vobench_scene.py`` holds one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TEXTURE_SIZE = 1024
TEXTURE_CELLS = (8, 16, 32, 64)


@dataclass
class Plane:
    """Textured plane: point p0, unit normal n, in-plane axes (u, v); the
    texture is [S,S] in [0,1] (numpy or torch)."""

    p0: np.ndarray
    n: np.ndarray
    u: np.ndarray
    v: np.ndarray
    tex: object
    scale: float


def texture_draws(rng: np.random.Generator, size: int = TEXTURE_SIZE) -> list:
    """The coarse uniform grids of one multi-scale texture, in draw order."""
    return [rng.uniform(0.0, 1.0, size=(size // c, size // c)) for c in TEXTURE_CELLS]


def texture_numpy(draws: list, size: int = TEXTURE_SIZE) -> np.ndarray:
    """``data/synthetic.py::_multiscale_texture`` from its draws."""
    tex = np.zeros((size, size), dtype=np.float64)
    for coarse, cell in zip(draws, TEXTURE_CELLS):
        tex += np.kron(coarse, np.ones((cell, cell)))
    tex /= 4.0
    tex = 0.15 + 0.7 * (tex > 0.5) + 0.15 * tex
    return np.clip(tex, 0.0, 1.0)


def texture_torch(draws: list, device) -> torch.Tensor:
    """:func:`texture_numpy` on ``device``, float64, the same values."""
    size = draws[0].shape[0] * TEXTURE_CELLS[0]
    tex = torch.zeros((size, size), dtype=torch.float64, device=device)
    for coarse, cell in zip(draws, TEXTURE_CELLS):
        c = torch.from_numpy(coarse).to(device)
        tex += c.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    tex /= 4.0
    tex = 0.15 + 0.7 * (tex > 0.5).to(torch.float64) + 0.15 * tex
    return torch.clamp(tex, 0.0, 1.0)


_AXES = dict(x=np.array([1.0, 0.0, 0.0]), y=np.array([0.0, 1.0, 0.0]),
             z=np.array([0.0, 0.0, 1.0]))
# default_scene: far wall, floor, ceiling, two side walls (p0, n, u, v, scale)
_ROOM = (((0.0, 0.0, 8.0), "-z", "x", "y", 80.0),
         ((0.0, 1.2, 0.0), "-y", "x", "z", 100.0),
         ((0.0, -1.5, 0.0), "y", "x", "z", 100.0),
         ((-2.5, 0.0, 0.0), "x", "z", "y", 90.0),
         ((2.5, 0.0, 0.0), "-x", "z", "y", 90.0))


def _axis(a: str) -> np.ndarray:
    return -_AXES[a[1]] if a.startswith("-") else _AXES[a]


def room(seed: int, texture) -> list:
    """``default_scene(seed)``: its five planes, each texture made by
    ``texture(draws)`` from the seed's draws in the generator's order."""
    rng = np.random.default_rng(seed)
    planes = []
    for p0, n, u, v, scale in _ROOM:
        planes.append(Plane(np.array(p0), _axis(n), _axis(u), _axis(v),
                            texture(texture_draws(rng)), scale))
    return planes


def _from_euler_yx(yaw: float, pitch: float) -> np.ndarray:
    """scipy's ``Rotation.from_euler("yx", [yaw, pitch]).as_matrix()``, in
    its arithmetic (quaternions composed q_x * q_y, scalar last)."""
    qy = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
    qx = np.array([np.sin(pitch / 2), 0.0, 0.0, np.cos(pitch / 2)])
    p, q = qx, qy
    cross = np.cross(p[:3], q[:3])
    x, y, z, w = (p[3] * q[0] + q[3] * p[0] + cross[0], p[3] * q[1] + q[3] * p[1] + cross[1],
                  p[3] * q[2] + q[3] * p[2] + cross[2],
                  p[3] * q[3] - p[0] * q[0] - p[1] * q[1] - p[2] * q[2])
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    return np.array([[x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw)],
                     [2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw)],
                     [2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2]])


def make_trajectory(n_frames: int, translation_step: float = 0.04,
                    lateral_amp: float = 0.6, yaw_amp: float = 0.08) -> np.ndarray:
    """``data/synthetic.py::make_trajectory``: smooth forward and lateral
    motion with gentle yaw and pitch, [N,4,4] T_w_c (no seed: the path is
    the same for every scene)."""
    ts = np.arange(n_frames, dtype=np.float64)
    px = lateral_amp * np.sin(ts * 2 * np.pi / max(n_frames, 60))
    py = 0.08 * np.sin(ts * 2 * np.pi / 37.0)
    pz = ts * translation_step
    yaw = yaw_amp * np.sin(ts * 2 * np.pi / max(n_frames, 80))
    pitch = 0.03 * np.sin(ts * 2 * np.pi / 53.0)
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _from_euler_yx(yaw[i], pitch[i])
        poses[i, :3, 3] = [px[i], py[i], pz[i]]
        poses[i, 3, 3] = 1.0
    return poses


def intrinsics(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])


# ---------------------------------------------------------------------------
# numpy: the port's render_frame, planes only
# ---------------------------------------------------------------------------


def _lookup_numpy(tex, tu, tv):
    th, tw = tex.shape
    iu = np.mod(tu, tw - 1)
    iv = np.mod(tv, th - 1)
    i0 = np.clip(np.floor(iv).astype(int), 0, th - 2)
    j0 = np.clip(np.floor(iu).astype(int), 0, tw - 2)
    fv, fu = iv - i0, iu - j0
    return (tex[i0, j0] * (1 - fu) * (1 - fv) + tex[i0, j0 + 1] * fu * (1 - fv)
            + tex[i0 + 1, j0] * (1 - fu) * fv + tex[i0 + 1, j0 + 1] * fu * fv)


def render_numpy(T_w_c: np.ndarray, planes: list, K: np.ndarray, height: int,
                 width: int) -> np.ndarray:
    """One uint8 [H,W] frame by exact ray tracing with a z-buffer."""
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([us.ravel(), vs.ravel(), np.ones(us.size)], axis=0)
    dirs = T_w_c[:3, :3] @ (Kinv @ pix)
    origin = T_w_c[:3, 3]
    best_t = np.full(us.size, np.inf)
    img = np.zeros(us.size, dtype=np.float64)
    for pl in planes:
        denom = pl.n @ dirs
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = ((pl.p0 - origin) @ pl.n) / denom
        t_hit = np.where((np.abs(denom) > 1e-9) & (t_hit > 0.05), t_hit, np.inf)
        valid = t_hit < best_t
        if not valid.any():
            continue
        X = origin[:, None] + dirs[:, valid] * t_hit[valid]
        rel = X - pl.p0[:, None]
        img[valid] = _lookup_numpy(pl.tex, (pl.u @ rel) * pl.scale, (pl.v @ rel) * pl.scale)
        best_t[valid] = t_hit[valid]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(height, width)


# ---------------------------------------------------------------------------
# torch: the same arithmetic, float64, frames in chunks
# ---------------------------------------------------------------------------


def _lookup_torch(tex, tu, tv):
    th, tw = tex.shape
    iu = torch.remainder(tu, tw - 1)
    iv = torch.remainder(tv, th - 1)
    i0 = torch.clamp(torch.floor(iv).to(torch.int64), 0, th - 2)
    j0 = torch.clamp(torch.floor(iu).to(torch.int64), 0, tw - 2)
    fv, fu = iv - i0, iu - j0
    flat = tex.reshape(-1)
    at = lambda i, j: flat[i * tw + j]
    return (at(i0, j0) * (1 - fu) * (1 - fv) + at(i0, j0 + 1) * fu * (1 - fv)
            + at(i0 + 1, j0) * (1 - fu) * fv + at(i0 + 1, j0 + 1) * fu * fv)


def _dot3(a, b):
    """sum_i a[i] * b[i] over the first axis, left to right (a: 3 numbers)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def render_torch(poses: np.ndarray, planes: list, K: np.ndarray, height: int, width: int,
                 device, chunk: int = 16) -> torch.Tensor:
    """[N,H,W] uint8 frames on ``device`` at ``poses`` [N,4,4]; the planes'
    textures are torch tensors on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    Kinv = torch.from_numpy(np.linalg.inv(K)).to(**f64)
    vs, us = torch.meshgrid(torch.arange(height, **f64), torch.arange(width, **f64),
                            indexing="ij")
    pix = torch.stack([us.reshape(-1), vs.reshape(-1), torch.ones(height * width, **f64)])
    rays = torch.stack([_dot3(Kinv[i], pix) for i in range(3)])          # [3,P]
    out = torch.empty((len(poses), height, width), dtype=torch.uint8, device=device)
    T = torch.from_numpy(np.asarray(poses, dtype=np.float64)).to(**f64)
    for lo in range(0, len(poses), chunk):
        Tc = T[lo:lo + chunk]                                              # [C,4,4]
        R, origin = Tc[:, :3, :3], Tc[:, :3, 3]
        dirs = torch.stack([_dot3(R[:, i, :].T[:, :, None], rays[:, None, :])
                            for i in range(3)])                            # [3,C,P]
        best_t = torch.full(dirs.shape[1:], float("inf"), **f64)
        img = torch.zeros(dirs.shape[1:], **f64)
        for pl in planes:
            n = torch.from_numpy(pl.n).to(**f64)
            p0 = torch.from_numpy(pl.p0).to(**f64)
            denom = _dot3(n, dirs)
            num = _dot3(n, (p0[:, None] - origin.T))                       # [C]
            t_hit = num[:, None] / denom
            t_hit = torch.where((denom.abs() > 1e-9) & (t_hit > 0.05), t_hit,
                                torch.full_like(t_hit, float("inf")))
            valid = t_hit < best_t
            t_safe = torch.where(valid, t_hit, torch.zeros_like(t_hit))
            rel = [origin[:, k, None] + dirs[k] * t_safe - p0[k] for k in range(3)]
            u = torch.from_numpy(pl.u).to(**f64)
            v = torch.from_numpy(pl.v).to(**f64)
            shade = _lookup_torch(pl.tex, _dot3(u, rel) * pl.scale, _dot3(v, rel) * pl.scale)
            img = torch.where(valid, shade, img)
            best_t = torch.where(valid, t_hit, best_t)
        out[lo:lo + chunk] = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).reshape(-1, height,
                                                                                    width)
    return out


def sequence(seed: int, n_frames: int, translation_step: float, cam: dict, height: int,
             width: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """The frames [N,H,W] uint8 on ``device`` and the GT poses [N,4,4] of one
    scene seed."""
    poses = make_trajectory(n_frames, translation_step)
    planes = room(seed, lambda d: texture_torch(d, device))
    return render_torch(poses, planes, intrinsics(cam), height, width, device), poses
