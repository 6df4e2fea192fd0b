"""Trajectory evaluation: ATE after scale or Sim(3) (Umeyama) alignment, and
the per-frame drift.

Numpy copy of ``monocular_visual_odometry_tpu.utils.metrics``.
"""

from __future__ import annotations

import numpy as np


def _positions(poses: np.ndarray) -> np.ndarray:
    return np.asarray(poses)[:, :3, 3]


def align_scale(est: np.ndarray, gt: np.ndarray) -> float:
    """Least-squares scale s minimizing ||s*p_est - p_gt|| over positions,
    both expressed relative to their first pose."""
    pe = _positions(est) - _positions(est)[0]
    pg = _positions(gt) - _positions(gt)[0]
    denom = float(np.sum(pe * pe))
    if denom < 1e-12:
        return 1.0
    return float(np.sum(pe * pg) / denom)


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Umeyama alignment of estimated positions onto GT positions.
    Returns (s, R, t) with p_gt ~= s * R @ p_est + t."""
    pe = _positions(est)
    pg = _positions(gt)
    mu_e = pe.mean(0)
    mu_g = pg.mean(0)
    xe = pe - mu_e
    xg = pg - mu_g
    cov = xg.T @ xe / len(pe)
    U, d, Vt = np.linalg.svd(cov)
    Ssgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Ssgn[2, 2] = -1
    R = U @ Ssgn @ Vt
    var_e = (xe**2).sum() / len(pe)
    s = float(np.trace(np.diag(d) @ Ssgn) / var_e) if with_scale and var_e > 1e-12 else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "sim3") -> float:
    """RMSE of absolute position error after alignment.

    align: 'none' | 'scale' (scale only, trajectories re-based to the first
    pose) | 'sim3' (full Umeyama).
    """
    est = np.asarray(est)
    gt = np.asarray(gt)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    if align == "scale":
        s = align_scale(est, gt)
        pe = (_positions(est) - _positions(est)[0]) * s
        pg = _positions(gt) - _positions(gt)[0]
    elif align == "sim3":
        s, R, t = align_umeyama(est, gt)
        pe = (_positions(est) @ R.T) * s + t
        pg = _positions(gt)
    elif align == "none":
        pe = _positions(est)
        pg = _positions(gt)
    else:
        raise ValueError(align)
    return float(np.sqrt(np.mean(np.sum((pe - pg) ** 2, axis=1))))


def trajectory_length(poses: np.ndarray) -> float:
    p = _positions(poses)
    return float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1)))


def drift_curve(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-frame absolute position error [N] after Sim(3) alignment of the
    whole trajectory."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    s, R, t = align_umeyama(est, gt)
    pe = (_positions(est) @ R.T) * s + t
    return np.linalg.norm(pe - _positions(gt), axis=1)
