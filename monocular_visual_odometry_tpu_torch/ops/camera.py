"""Pinhole camera model and pixel/camera-frame transforms.

Port of ``monocular_visual_odometry_tpu.ops.camera``. The intrinsics are
plain Python floats (each exactly representable in fp32 for the usual
values), so they never force a host-device transfer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Pinhole intrinsics (fx, fy, cx, cy), rounded to fp32 like the JAX
    package's 0-d float32 arrays."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx: float, fy: float, cx: float, cy: float) -> "Camera":
        f = lambda v: float(np.float32(v))
        return Camera(f(fx), f(fy), f(cx), f(cy))

    def K(self, device="cpu") -> torch.Tensor:
        """3x3 intrinsic matrix."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def pixel2cam_norm_plane(uv: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Pixels (..., 2) -> normalized image plane (..., 2) at z=1."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)


def cam2pixel(p_cam: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Camera-frame 3-D points (..., 3) -> pixels (..., 2); no clamping."""
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = p_cam[..., 0] / z_safe * cam.fx + cam.cx
    v = p_cam[..., 1] / z_safe * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def in_frame(uv: torch.Tensor, height, width, border: float = 0.0) -> torch.Tensor:
    """Boolean mask of pixels inside the image (with border margin)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < width - border) & (v >= border) & (v < height - border)
