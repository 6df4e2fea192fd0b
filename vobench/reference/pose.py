"""Plain reference of the tracked pose.

With the landmarks fixed, the pose a tracking frame ends with (RANSAC-PnP's
refinement, then the windowed bundle adjustment's, ``models/ba.py``) is the
minimiser of the frame's robust reprojection error over the map points its
keypoints are linked to: a Huber loss of ``huber`` pixels on the residual's
norm, over the links whose residual at the start is under ``gate`` pixels
and whose point lies in front of the camera. :func:`refine` finds that
minimiser in float64 numpy by Levenberg-Marquardt, from the pose it is
given; :func:`gap` is how far a pose lies from it, and :func:`cost` the
loss a pose reaches: a pose's excess over the minimiser's loss says how far
from optimal it is along the directions the links constrain (a pose that
slides along a direction they barely constrain loses almost nothing).
"""

from __future__ import annotations

import numpy as np


def hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """[4,4] exp of (v, w): rotation by Rodrigues, translation by its V."""
    v, w = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    K = hat(w)
    if th < 1e-10:
        R, V = np.eye(3) + K, np.eye(3) + 0.5 * K
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / th ** 2
        R = np.eye(3) + a * K + b * K @ K
        V = np.eye(3) + b * K + (th - np.sin(th)) / th ** 3 * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ v
    return T


def inv(T: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def project(T_c_w: np.ndarray, X: np.ndarray, cam: dict):
    """(pixels [N,2], camera-frame points [N,3]) of world points ``X``."""
    p = X @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    z = p[:, 2:3]
    uv = p[:, :2] / z * np.array([cam["fx"], cam["fy"]]) + np.array([cam["cx"], cam["cy"]])
    return uv, p


def cost(T, X, uv, cam, huber):
    """The Huber loss (px^2) of the links at ``T`` (camera from world)."""
    r = project(T, X, cam)[0] - uv
    e = np.sqrt(np.maximum((r ** 2).sum(1), 1e-24))
    return float(np.where(e <= huber, e ** 2, 2.0 * huber * e - huber ** 2).sum())


def refine(T_c_w: np.ndarray, X: np.ndarray, uv: np.ndarray, cam: dict, *, huber: float = 3.0,
           gate: float = 9.0, iterations: int = 60) -> tuple:
    """(the minimiser [4,4], the links used): Levenberg-Marquardt with IRLS
    Huber weights and left se(3) updates, in float64, from ``T_c_w``."""
    T = np.asarray(T_c_w, np.float64)
    X, uv = np.asarray(X, np.float64), np.asarray(uv, np.float64)
    r0, p0 = project(T, X, cam)
    keep = (p0[:, 2] > 0) & (((r0 - uv) ** 2).sum(1) < gate * gate)
    X, uv = X[keep], uv[keep]
    if len(X) < 6:
        return T, int(len(X))
    f = np.array([cam["fx"], cam["fy"]])
    lam, c_old = 1e-3, cost(T, X, uv, cam, huber)
    for _ in range(iterations):
        pix, p = project(T, X, cam)
        r = (pix - uv).reshape(-1)
        iz = 1.0 / p[:, 2]
        J_proj = np.zeros((len(X), 2, 3))
        J_proj[:, 0, 0] = f[0] * iz
        J_proj[:, 1, 1] = f[1] * iz
        J_proj[:, :, 2] = -f * p[:, :2] * iz[:, None] ** 2
        dp = np.zeros((len(X), 3, 6))
        dp[:, :, :3] = np.eye(3)
        dp[:, :, 3:] = -np.stack([hat(q) for q in p])
        J = (J_proj @ dp).reshape(-1, 6)
        e = np.sqrt(np.maximum((r.reshape(-1, 2) ** 2).sum(1), 1e-24))
        w = np.repeat(np.where(e <= huber, 1.0, huber / e), 2)
        H, g = J.T @ (w[:, None] * J), J.T @ (w * r)
        xi = -np.linalg.solve(H + lam * np.diag(np.diag(H)), g)
        T_new = se3_exp(xi) @ T
        c_new = cost(T_new, X, uv, cam, huber)
        if c_new <= c_old:
            T, c_old, lam = T_new, c_new, lam * 0.3
            if np.abs(xi).max() < 1e-15:
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return T, int(len(X))


def gap(T_w_c_a: np.ndarray, T_w_c_b: np.ndarray) -> tuple:
    """(distance between the camera centres, rotation angle in radians)."""
    dt = float(np.linalg.norm(T_w_c_a[:3, 3] - T_w_c_b[:3, 3]))
    return dt, angle(T_w_c_a[:3, :3].T @ T_w_c_b[:3, :3])


def angle(R: np.ndarray) -> float:
    """The rotation angle of ``R`` in radians, exact near 0 as well."""
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))
