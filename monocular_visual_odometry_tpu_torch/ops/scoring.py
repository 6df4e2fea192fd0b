"""ORB-SLAM-style symmetric-transfer-error scores for E vs H selection.

Port of ``monocular_visual_odometry_tpu.ops.scoring``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)

_CHI2_1DOF = 3.841
_CHI2_2DOF = 5.991
_EPS = 1e-9


class ModelScore(NamedTuple):
    score: torch.Tensor     # scalar
    inliers: torch.Tensor   # [N] bool


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _signed_eps(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 0, torch.full_like(w, _EPS), torch.full_like(w, -_EPS))


def essential_score(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                    candidates: torch.Tensor, sigma: float = 1.0) -> ModelScore:
    """Score an essential hypothesis through ``F = K^-T E K^-1`` on pixel
    correspondences (point-to-epipolar-line chi2 in both images)."""
    h1, h2 = _homog(uv1), _homog(uv2)
    inv_sigma2 = 1.0 / (sigma * sigma)
    l2 = h1 @ F.T
    num = torch.sum(h2 * l2, dim=-1)
    d2_img2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + _EPS)
    l1 = h2 @ F
    d2_img1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + _EPS)
    chi1 = d2_img2 * inv_sigma2
    chi2 = d2_img1 * inv_sigma2
    zero = torch.zeros_like(chi1)
    s = (torch.where(chi1 <= _CHI2_1DOF, _CHI2_2DOF - chi1, zero)
         + torch.where(chi2 <= _CHI2_1DOF, _CHI2_2DOF - chi2, zero))
    good = (chi1 <= _CHI2_1DOF) & (chi2 <= _CHI2_1DOF)
    s = torch.where(candidates, s, zero)
    return ModelScore(torch.sum(s), good & candidates)


def homography_score(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                     candidates: torch.Tensor, sigma: float = 1.0) -> ModelScore:
    """Score a homography by symmetric transfer error on pixels."""
    Hinv = torch.linalg.inv_ex(H).inverse
    inv_sigma2 = 1.0 / (sigma * sigma)

    def transfer_err2(M, src, dst):
        q = _homog(src) @ M.T
        w = q[..., 2:3]
        q = q[..., :2] / (w + _signed_eps(w))
        return torch.sum((q - dst) ** 2, dim=-1)

    chi1 = transfer_err2(Hinv, uv2, uv1) * inv_sigma2
    chi2 = transfer_err2(H, uv1, uv2) * inv_sigma2
    zero = torch.zeros_like(chi1)
    s = (torch.where(chi1 <= _CHI2_2DOF, _CHI2_2DOF - chi1, zero)
         + torch.where(chi2 <= _CHI2_2DOF, _CHI2_2DOF - chi2, zero))
    good = (chi1 <= _CHI2_2DOF) & (chi2 <= _CHI2_2DOF)
    s = torch.where(candidates, s, zero)
    return ModelScore(torch.sum(s), good & candidates)


def prefer_homography(score_e: torch.Tensor, score_h: torch.Tensor,
                      ratio: float = 0.5) -> torch.Tensor:
    """H wins when score_H / (score_E + score_H) > ratio."""
    return score_h / (score_e + score_h + _EPS) > ratio
