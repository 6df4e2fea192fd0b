"""SE(3)/SO(3) Lie-group operations in PyTorch.

Port of ``monocular_visual_odometry_tpu.ops.lie``: the same conventions
(``T_w_c`` maps camera-frame points to the world; se(3) twists are
``[rho, phi]``), the same Taylor fallbacks near the identity, batched over
leading dimensions.
"""

from __future__ import annotations

import math

import torch

from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)

_EPS = 1e-8


def _eye3(ref: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of a 3-vector (batched)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix (batched)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector (batched); the axis sign is
    arbitrary at exactly pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(sin_t == 0, torch.ones_like(sin_t), sin_t))
    log_generic = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    sym = (R + R.transpose(-1, -2)) * 0.5
    one = torch.ones_like(axis_abs[..., 0])
    sx = one
    sy = torch.where(sym[..., 0, 1] >= 0, one, -one)
    sz = torch.where(sym[..., 0, 2] >= 0, one, -one)
    x_tiny = axis_abs[..., 0] < 1e-3
    sz = torch.where(x_tiny, torch.where(sym[..., 1, 2] >= 0, one, -one), sz)
    axis = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    log_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], log_pi, log_generic)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    sin_h = torch.sin(half)
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(sin_h == 0, torch.ones_like(sin_h), sin_h))
        / (theta2 + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] -> 4x4 transform (batched)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return rt_to_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> se(3) twist [rho, phi] (batched)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Vinv = _so3_left_jacobian_inv(phi)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into a 4x4 T (batched)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] from fills: a tensor built from host data would be copied
    # over and synchronise the stream
    bottom = torch.cat([torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device),
                        torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def T_to_rt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R, t = T_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply T (..., 4, 4) to points (..., N, 3)."""
    R, t = T_to_rt(T)
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def relative_T(T_w_a: torch.Tensor, T_w_b: torch.Tensor) -> torch.Tensor:
    """T_a_b = T_w_a^-1 @ T_w_b."""
    return inv_T(T_w_a) @ T_w_b


def svd(M: torch.Tensor):
    """``torch.linalg.svd`` that, like ``jnp.linalg.svd``, turns a matrix
    with non-finite entries into NaN factors instead of raising."""
    ok = torch.isfinite(M).flatten(-2).all(-1)[..., None, None]
    U, S, Vt = torch.linalg.svd(torch.where(ok, M, torch.zeros_like(M)))
    nan = torch.full((), float("nan"), dtype=M.dtype, device=M.device)
    return (torch.where(ok, U, nan), torch.where(ok[..., 0], S, nan),
            torch.where(ok, Vt, nan))


def project_onto_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (det +1) via SVD."""
    U, _, Vt = svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def angle_between(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two vectors (batched)."""
    num = torch.sum(v1 * v2, dim=-1)
    den = torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)
    return torch.arccos(torch.clamp(num / (den + _EPS), -1.0, 1.0))


def pose_distance(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Translation distance between two poses (keyframe / jump metric)."""
    return torch.linalg.norm(T_a[..., :3, 3] - T_b[..., :3, 3], dim=-1)
