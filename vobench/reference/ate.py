"""Trajectory error against the ground truth: Sim(3) (Umeyama) alignment and
the RMSE of the aligned positions, in numpy. A frozen copy of the
arithmetic of the port's ``utils/metrics.py`` (itself the JAX package's)."""

from __future__ import annotations

import numpy as np


def align_umeyama(pe: np.ndarray, pg: np.ndarray):
    """(s, R, t) with pg ~= s * R @ pe + t for positions [N,3]."""
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    xe, xg = pe - mu_e, pg - mu_g
    cov = xg.T @ xe / len(pe)
    U, d, Vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        sgn[2, 2] = -1
    R = U @ sgn @ Vt
    var_e = (xe ** 2).sum() / len(pe)
    s = float(np.trace(np.diag(d) @ sgn) / var_e) if var_e > 1e-12 else 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the positions of ``est`` [N,4,4] after Sim(3) alignment onto
    ``gt`` [N,4,4]; inf if any estimated position is not finite."""
    pe, pg = np.asarray(est)[:, :3, 3], np.asarray(gt)[:, :3, 3]
    if not np.isfinite(pe).all():
        return float("inf")
    s, R, t = align_umeyama(pe, pg)
    return float(np.sqrt(np.mean(np.sum(((pe @ R.T) * s + t - pg) ** 2, axis=1))))


def path_length(poses: np.ndarray) -> float:
    p = np.asarray(poses)[:, :3, 3]
    return float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1)))


def ate_pct(est: np.ndarray, gt: np.ndarray) -> float:
    """Sim(3) ATE as a share of the ground-truth path length, in %."""
    return 100.0 * ate_rmse(est, gt) / path_length(gt)
