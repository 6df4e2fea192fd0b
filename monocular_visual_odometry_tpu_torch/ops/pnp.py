"""Perspective-n-Point: batched P3P RANSAC + Levenberg-Marquardt polish.

Port of ``monocular_visual_odometry_tpu.ops.pnp``: Grunert P3P minimal
solves (up to 4 poses per 3-point sample), truncated-quadratic scoring of
every hypothesis against every correspondence, then two LM rounds (soft
weights, then hard inliers). The JAX module's 6-point DLT (``_dlt_p6``) is
not ported: nothing calls it, and it does not recover the pose even from
noise-free points.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops.camera import Camera, cam2pixel
from monocular_visual_odometry_tpu_torch.ops.polynomial import (
    polish_quartic_roots,
    quartic_real_roots,
)
from monocular_visual_odometry_tpu_torch.ops.consts import take
from monocular_visual_odometry_tpu_torch.ops.ransac import sample_minimal_sets

_EPS = 1e-9


class PnPResult(NamedTuple):
    T_c_w: torch.Tensor     # [4,4] world -> camera
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor # scalar
    ok: torch.Tensor        # scalar bool


def p3p_grunert(pts: torch.Tensor, uv_n: torch.Tensor):
    """Grunert's P3P: world points [..., 3, 3] + normalized-plane
    observations [..., 3, 2] -> (R [..., 4, 3, 3], t [..., 4, 3], ok [..., 4])."""
    f = torch.cat([uv_n, torch.ones_like(uv_n[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    X1, X2, X3 = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]

    a2 = torch.sum((X2 - X3) ** 2, dim=-1)
    b2 = torch.sum((X1 - X3) ** 2, dim=-1)
    c2 = torch.sum((X1 - X2) ** 2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    b2c = torch.clamp(b2, min=_EPS)
    A = a2 / b2c
    B = c2 / b2c
    AmB = A - B

    A4 = (AmB - 1.0) ** 2 - 4.0 * B * ca * ca
    A3 = 4.0 * (AmB * (1.0 - AmB) * cb - (1.0 - (A + B)) * ca * cg
                + 2.0 * B * ca * ca * cb)
    A2c = 2.0 * (AmB * AmB - 1.0 + 2.0 * AmB * AmB * cb * cb
                 + 2.0 * (1.0 - B) * ca * ca - 4.0 * (A + B) * ca * cb * cg
                 + 2.0 * (1.0 - A) * cg * cg)
    A1 = 4.0 * (-AmB * (1.0 + AmB) * cb + 2.0 * A * cg * cg * cb
                - (1.0 - (A + B)) * ca * cg)
    A0 = (1.0 + AmB) ** 2 - 4.0 * A * cg * cg

    lead = torch.where(torch.abs(A4) < 1e-10,
                       torch.where(A4 >= 0, torch.full_like(A4, 1e-10),
                                   torch.full_like(A4, -1e-10)), A4)
    v, ok = quartic_real_roots(A3 / lead, A2c / lead, A1 / lead, A0 / lead)
    v = polish_quartic_roots(A3 / lead, A2c / lead, A1 / lead, A0 / lead, v, 2)

    AmBe = AmB[..., None]
    cbe, cae, cge = cb[..., None], ca[..., None], cg[..., None]
    den = cge - v * cae
    u = ((-1.0 + AmBe) * v * v - 2.0 * AmBe * cbe * v + 1.0 + AmBe) / (
        2.0 * den + torch.where(torch.abs(den) < _EPS, _EPS, 0.0))
    s1 = torch.sqrt(torch.clamp(
        b2[..., None] / torch.clamp(1.0 + v * v - 2.0 * v * cbe, min=_EPS), min=0.0))
    s2 = u * s1
    s3 = v * s1
    ok = ok & (s1 > 0) & (s2 > 0) & (s3 > 0)

    Y1 = s1[..., None] * f1[..., None, :]
    Y2 = s2[..., None] * f2[..., None, :]
    Y3 = s3[..., None] * f3[..., None, :]

    def triad(P1, P2, P3):
        e1 = P2 - P1
        e1 = e1 / (torch.linalg.norm(e1, dim=-1, keepdim=True) + _EPS)
        n = torch.linalg.cross(e1, P3 - P1)
        e3 = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + _EPS)
        e2 = torch.linalg.cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-1)

    Bx = triad(X1[..., None, :].expand(Y1.shape), X2[..., None, :].expand(Y1.shape),
               X3[..., None, :].expand(Y1.shape))
    By = triad(Y1, Y2, Y3)
    R = By @ Bx.transpose(-1, -2)
    t = Y1 - torch.einsum("...ij,...j->...i", R, X1[..., None, :].expand(Y1.shape))
    return R, t, ok


def _reproj_err2_px(T_c_w: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor,
                    cam: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared pixel reprojection error and camera depth, batched over the
    leading dims of T_c_w."""
    p_c = torch.einsum("...ij,nj->...ni", T_c_w[..., :3, :3], pts_w) + T_c_w[..., None, :3, 3]
    proj = cam2pixel(p_c, cam)
    return torch.sum((proj - uv) ** 2, dim=-1), p_c[..., 2]


def _gn_refine(T0_c_w: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor,
               w: torch.Tensor, cam: Camera, iterations: int = 10,
               init_lambda: float = 1e-3) -> torch.Tensor:
    """LM refinement of one pose over weighted correspondences with the
    left-multiplicative se(3) update T <- exp(delta) @ T."""
    fx, fy, cx, cy = cam
    eye3 = torch.eye(3, dtype=pts_w.dtype, device=pts_w.device)
    eye6 = torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)

    def cost_and_system(T):
        R, t = lie.T_to_rt(T)
        p = pts_w @ R.T + t
        z = torch.clamp(p[:, 2], min=1e-6)
        u = p[:, 0] / z * fx + cx
        v = p[:, 1] / z * fy + cy
        r = torch.stack([u - uv[:, 0], v - uv[:, 1]], dim=-1)
        inv_z = 1.0 / z
        zero = torch.zeros_like(z)
        du_dp = torch.stack([fx * inv_z, zero, -fx * p[:, 0] * inv_z**2], dim=-1)
        dv_dp = torch.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z**2], dim=-1)
        J_proj = torch.stack([du_dp, dv_dp], dim=-2)
        dp_ddelta = torch.cat([eye3.expand(p.shape[0], 3, 3), -lie.hat(p)], dim=-1)
        J = J_proj @ dp_ddelta
        H = torch.einsum("nik,nil->kl", J * w[:, None, None], J)
        g = torch.einsum("nik,ni->k", J, r * w[:, None])
        cost = torch.sum(w * torch.sum(r * r, dim=-1))
        return cost, H, g

    T = T0_c_w
    lam = torch.full((), init_lambda, dtype=T.dtype, device=T.device)
    for _ in range(iterations):
        cost, H, g = cost_and_system(T)
        delta = -torch.linalg.solve_ex(H + lam * eye6, g).result
        T_new = lie.se3_exp(delta) @ T
        cost_new, _, _ = cost_and_system(T_new)
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        lam = torch.where(accept, lam * 0.3, lam * 3.0)
    return T


def solve_pnp_ransac(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
    cam: Camera, key: int | None,
    *, threshold_px: float = 2.0, n_hypotheses: int = 256,
    min_inliers: int = 5, refine_iterations: int = 10,
    idx: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
) -> PnPResult:
    """RANSAC PnP over fixed-capacity masked 3D-2D correspondences; ``idx``
    [B,3] overrides the sampled minimal sets, ``u`` [n_hypotheses, N] the
    uniforms they are drawn from (see ``ransac.sample_minimal_sets``)."""
    uv_n = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    if idx is None:
        idx = sample_minimal_sets(key, valid, n_hypotheses, 3, u)
    R, t, okh = p3p_grunert(pts_w[idx], uv_n[idx])
    Ts = lie.rt_to_T(R.reshape(-1, 3, 3), t.reshape(-1, 3))
    okh = okh.reshape(-1)
    err2, z = _reproj_err2_px(Ts, pts_w, uv, cam)
    th2 = float(np.float32(threshold_px) * np.float32(threshold_px))
    cap = float(np.float32(4.0) * np.float32(th2))
    msac = torch.sum(torch.where(valid[None, :] & (z > 0), torch.clamp(err2, max=cap),
                                 torch.full_like(err2, cap)), dim=-1)
    msac = torch.where(okh & torch.all(torch.isfinite(Ts.reshape(-1, 16)), dim=-1),
                       msac, torch.full_like(msac, float("inf")))
    T_best = take(Ts, torch.argmin(msac))

    half = max(refine_iterations // 2, 3)
    err2b, zb = _reproj_err2_px(T_best, pts_w, uv, cam)
    w_soft = torch.where(valid & (zb > 0), torch.clamp(cap / (err2b + 1e-9), max=1.0),
                         torch.zeros_like(err2b))
    T_best = _gn_refine(T_best, pts_w, uv, w_soft, cam, half)
    err2r, zr = _reproj_err2_px(T_best, pts_w, uv, cam)
    inl_best = (err2r < th2) & (zr > 0) & valid
    T_best = _gn_refine(T_best, pts_w, uv, inl_best.to(pts_w.dtype), cam, half)
    err2f, zf = _reproj_err2_px(T_best, pts_w, uv, cam)
    inl_best = (err2f < th2) & (zf > 0) & valid
    n = torch.sum(inl_best)
    return PnPResult(T_c_w=T_best, inliers=inl_best, n_inliers=n, ok=n >= min_inliers)
