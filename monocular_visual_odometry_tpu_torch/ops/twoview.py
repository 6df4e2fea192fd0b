"""Two-view relative-pose estimation with E/H model selection.

Port of ``monocular_visual_odometry_tpu.ops.twoview``: RANSAC for the
essential matrix and the homography, 1 + 4 candidate poses, the
robust-Sampson tournament (default) or the ORB-SLAM score-ratio rule, the
cheirality sign vote and triangulation of the winner's inliers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import epipolar as epi
from monocular_visual_odometry_tpu_torch.ops import lie, scoring
from monocular_visual_odometry_tpu_torch.ops.camera import Camera, pixel2cam_norm_plane
from monocular_visual_odometry_tpu_torch.ops.ransac import split_key


class TwoViewResult(NamedTuple):
    R: torch.Tensor          # [3,3] rotation frame1 -> frame2 (T_2_1)
    t: torch.Tensor          # [3] unit translation
    inliers: torch.Tensor    # [N] bool
    pts3d_c1: torch.Tensor   # [N,3] triangulated points in camera 1
    used_homography: torch.Tensor
    ratio_prefers_h: torch.Tensor
    score_e: torch.Tensor
    score_h: torch.Tensor
    E: torch.Tensor
    H: torch.Tensor
    plane_normal: torch.Tensor


def _focal(cam: Camera) -> np.float32:
    return (np.float32(cam.fx) + np.float32(cam.fy)) * np.float32(0.5)


def estimate_relative_pose(
    uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
    cam: Camera, key: int,
    *, threshold_px: float = 1.0, h_threshold_px: float = 3.0,
    n_hypotheses: int = 512, sigma: float = 1.0,
    use_reference_selection: bool = False, essential_minimal: str = "8pt",
    idx_e: Optional[torch.Tensor] = None, idx_h: Optional[torch.Tensor] = None,
    G_e: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """E/H dual estimation + model selection on matched pixel
    correspondences. ``key`` is split into the E and H draws as
    ``jax.random.split`` is in the reference; ``idx_e`` / ``idx_h``
    override the draws, and ``G_e`` the five-point basis remix."""
    x1 = pixel2cam_norm_plane(uv1, cam)
    x2 = pixel2cam_norm_plane(uv2, cam)
    K = cam.K(uv1.device).to(uv1.dtype)
    th_n = float(np.float32(threshold_px) / _focal(cam))
    k_e, k_h = split_key(key)

    e_model = epi.estimate_essential(x1, x2, valid, k_e, threshold=th_n,
                                     n_hypotheses=n_hypotheses,
                                     minimal=essential_minimal, idx=idx_e, G=G_e)
    R_e, t_e, _ = epi.recover_pose_from_E(e_model.model, x1, x2, e_model.inliers)

    h_model = epi.estimate_homography(uv1, uv2, valid, k_h,
                                      threshold_px=h_threshold_px,
                                      n_hypotheses=n_hypotheses, idx=idx_h)
    Rs_h, ts_h, ns_h, valid4 = epi.decompose_homography(h_model.model, K)

    Kinv = torch.linalg.inv_ex(K).inverse
    F = Kinv.T @ e_model.model @ Kinv
    se = scoring.essential_score(F, uv1, uv2, e_model.inliers, sigma)
    sh = scoring.homography_score(h_model.model, uv1, uv2, h_model.inliers, sigma)
    ratio_h = scoring.prefer_homography(se.score, sh.score)

    if use_reference_selection:
        vis = epi.homography_visible_filter(ns_h, x1, h_model.inliers)
        h_ok = valid4 & vis
        h_ok = torch.where(torch.any(h_ok), h_ok, valid4)
        h_idx = torch.argmax(torch.where(h_ok, torch.abs(ns_h[:, 2]),
                                         torch.full_like(ns_h[:, 2], -1.0)))
        use_h = ratio_h & torch.any(valid4)
        R = torch.where(use_h, Rs_h[h_idx], R_e)
        t = torch.where(use_h, ts_h[h_idx], t_e)
        best_h_idx = h_idx
    else:
        cand_R = torch.cat([R_e[None], Rs_h], dim=0)   # [5,3,3]
        cand_t = torch.cat([t_e[None], ts_h], dim=0)   # [5,3]
        huber = float(np.float32(2.0) * np.float32(th_n))
        Rs_ref, ts_ref = epi.refine_pose_sampson(cand_R, cand_t, x1, x2, valid,
                                                 iterations=12, huber_delta=huber)
        # MSAC with cheirality after resolving each candidate's t sign by
        # positive-depth vote (see the JAX module for the failure modes)
        T = lie.rt_to_T(Rs_ref, ts_ref)
        z1, z2 = epi.depths_in_two_views(epi.triangulate(x1, x2, T), T)
        n_pos = torch.sum(valid & (z1 > 0) & (z2 > 0), dim=-1)
        n_neg = torch.sum(valid & (z1 < 0) & (z2 < 0), dim=-1)
        flip = n_neg > n_pos
        ts_res = torch.where(flip[:, None], -ts_ref, ts_ref)
        pos = torch.where(flip[:, None], (z1 < 0) & (z2 < 0), (z1 > 0) & (z2 > 0))
        r = epi._sampson_residuals(Rs_ref, ts_res, x1, x2)
        h2 = huber * huber
        c = torch.where(pos, torch.clamp(r * r, max=h2), torch.full_like(r, h2))
        costs = torch.sum(valid * c, dim=-1)
        cand_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=valid.device), valid4])
        costs = torch.where(cand_ok, costs, torch.full_like(costs, float("inf")))
        # E must be meaningfully better than the best H to win; near-tied H
        # candidates resolve by max |n_z|
        ch = costs[1:]
        near_h = ch <= torch.min(ch) * 1.05
        best_h = 1 + torch.argmax(torch.where(near_h, torch.abs(ns_h[:, 2]),
                                              torch.full_like(ch, -1.0)))
        e_wins = costs[0] < 0.95 * costs[best_h]
        best = torch.where(e_wins, torch.zeros_like(best_h), best_h)
        R = Rs_ref[best]
        t = ts_res[best]
        use_h = best > 0
        best_h_idx = torch.clamp(best - 1, min=0)

    # cheirality: resolve the t sign by positive-depth vote
    T_pos = lie.rt_to_T(R, t)
    pts_pos = epi.triangulate(x1, x2, T_pos)
    z1p, z2p = epi.depths_in_two_views(pts_pos, T_pos)
    n_pos = torch.sum(valid & (z1p > 0) & (z2p > 0))
    n_neg = torch.sum(valid & (z1p < 0) & (z2p < 0))
    flip = n_neg > n_pos
    t = torch.where(flip, -t, t)
    T_2_1 = lie.rt_to_T(R, t)
    pts3d = torch.where(flip, -pts_pos, pts_pos)
    z1, z2 = epi.depths_in_two_views(pts3d, T_2_1)

    r_fin = epi._sampson_residuals(R, t, x1, x2)
    inl = valid & (torch.abs(r_fin) < th_n) & (z1 > 0) & (z2 > 0)
    return TwoViewResult(
        R=R, t=t, inliers=inl, pts3d_c1=pts3d,
        used_homography=use_h, ratio_prefers_h=ratio_h,
        score_e=se.score, score_h=sh.score,
        E=e_model.model, H=h_model.model,
        plane_normal=torch.where(use_h, ns_h[best_h_idx], torch.zeros_like(ns_h[0])),
    )


def find_inlier_matches_by_epipolar(
    uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
    cam: Camera, key: int,
    *, threshold_px: float = 1.0, n_hypotheses: int = 256,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """E-RANSAC used purely as an outlier filter. Returns [N] bool."""
    x1 = pixel2cam_norm_plane(uv1, cam)
    x2 = pixel2cam_norm_plane(uv2, cam)
    th_n = float(np.float32(threshold_px) / _focal(cam))
    return epi.estimate_essential(x1, x2, valid, key, threshold=th_n,
                                  n_hypotheses=n_hypotheses, idx=idx).inliers


def epipolar_filter_known_pose(
    uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
    cam: Camera, T_w_c1: torch.Tensor, T_w_c2: torch.Tensor,
    *, threshold_px: float = 1.0,
) -> torch.Tensor:
    """Sampson gate with the tracked relative pose: |r| < threshold."""
    x1 = pixel2cam_norm_plane(uv1, cam)
    x2 = pixel2cam_norm_plane(uv2, cam)
    R, t = lie.T_to_rt(lie.relative_T(T_w_c2, T_w_c1))
    tn = t / (torch.linalg.norm(t) + 1e-9)
    r = epi._sampson_residuals(R, tn, x1, x2)
    return valid & (torch.abs(r) < float(np.float32(threshold_px) / _focal(cam)))


def triangulate_with_pose(
    uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
    cam: Camera, T_w_c1: torch.Tensor, T_w_c2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate with the known relative pose. Returns (world points
    [N,3], ok [N] = valid & positive depth in both views)."""
    x1 = pixel2cam_norm_plane(uv1, cam)
    x2 = pixel2cam_norm_plane(uv2, cam)
    T_2_1 = lie.relative_T(T_w_c2, T_w_c1)
    pts_c1 = epi.triangulate(x1, x2, T_2_1)
    z1, z2 = epi.depths_in_two_views(pts_c1, T_2_1)
    ok = valid & (z1 > 0) & (z2 > 0)
    return lie.transform_points(T_w_c1, pts_c1), ok


def triangulation_angles(pts3d_c1: torch.Tensor, T_2_1: torch.Tensor) -> torch.Tensor:
    """Parallax angle (radians) between the two viewing rays per point."""
    c2 = lie.inv_T(T_2_1)[:3, 3]
    return lie.angle_between(pts3d_c1, pts3d_c1 - c2[None, :])
