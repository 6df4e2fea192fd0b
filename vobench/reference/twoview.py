"""Plain reference of the two-view init's relative pose.

From the correspondences of the two frames, in float64 numpy: the
normalised 8-point essential matrix over all of them (Hartley's
conditioning, singular values forced to (1, 1, 0)), the one of its four
poses that puts most points in front of both cameras, then
Levenberg-Marquardt on the sum of squared Sampson errors (rotation by a left
so(3) update, the unit translation on its sphere). :func:`relative_pose`
returns (R, t) with x2 ~ R x1 + t, |t| = 1; :func:`sampson` the Sampson
errors a pose leaves.
"""

from __future__ import annotations

import numpy as np

from .pose import hat, se3_exp


def normalized(uv: np.ndarray, cam: dict) -> np.ndarray:
    uv = np.asarray(uv, np.float64)
    return np.stack([(uv[:, 0] - cam["cx"]) / cam["fx"], (uv[:, 1] - cam["cy"]) / cam["fy"]], 1)


def _condition(x: np.ndarray):
    c = x.mean(0)
    s = np.sqrt(2.0) / np.mean(np.linalg.norm(x - c, axis=1))
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    return np.c_[x, np.ones(len(x))] @ T.T, T


def eight_point(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    h1, T1 = _condition(x1)
    h2, T2 = _condition(x2)
    A = np.einsum("ni,nj->nij", h2, h1).reshape(-1, 9)
    E = np.linalg.svd(A)[2][-1].reshape(3, 3)
    E = T2.T @ E @ T1
    U, _, Vt = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt


def _depths(R, t, x1, x2):
    """Depths of the midpoint triangulation in view 1 and view 2."""
    h1, h2 = np.c_[x1, np.ones(len(x1))], np.c_[x2, np.ones(len(x2))]
    d1 = h1
    d2 = h2 @ R                        # view-2 rays in view-1 axes
    c2 = -R.T @ t                      # view-2 centre in view 1
    a, b, c = (d1 * d1).sum(1), (d1 * d2).sum(1), (d2 * d2).sum(1)
    d, e = d1 @ c2, d2 @ c2
    den = a * c - b * b
    s = (c * d - b * e) / den
    u = (b * d - a * e) / den
    return s, u


def pose_from_E(E: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    best = None
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            z1, z2 = _depths(R, t, x1, x2)
            n = int(((z1 > 0) & (z2 > 0)).sum())
            if best is None or n > best[0]:
                best = (n, R, t)
    return best[1], best[2]


def sampson(R, t, x1, x2) -> np.ndarray:
    E = hat(t) @ R
    h1, h2 = np.c_[x1, np.ones(len(x1))], np.c_[x2, np.ones(len(x2))]
    Ex1, Etx2 = h1 @ E.T, h2 @ E
    num = (h2 * Ex1).sum(1)
    return num / np.sqrt(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)


def _tangent(t):
    a = np.eye(3)[np.argmin(np.abs(t))]
    b1 = np.cross(t, a)
    b1 /= np.linalg.norm(b1)
    return np.stack([b1, np.cross(t, b1)], 1)


def _apply(R, t, d):
    R2 = se3_exp(np.r_[0, 0, 0, d[:3]])[:3, :3] @ R
    t2 = t + _tangent(t) @ d[3:]
    return R2, t2 / np.linalg.norm(t2)


def refine(R, t, x1, x2, iterations: int = 50):
    lam = 1e-3
    r = sampson(R, t, x1, x2)
    cost = float(r @ r)
    h = 1e-7
    for _ in range(iterations):
        J = np.stack([(sampson(*_apply(R, t, h * e), x1, x2)
                       - sampson(*_apply(R, t, -h * e), x1, x2)) / (2 * h) for e in np.eye(5)], 1)
        H, g = J.T @ J, J.T @ r
        d = -np.linalg.solve(H + lam * np.diag(np.diag(H)), g)
        R2, t2 = _apply(R, t, d)
        r2 = sampson(R2, t2, x1, x2)
        if float(r2 @ r2) <= cost:
            R, t, r, cost, lam = R2, t2, r2, float(r2 @ r2), lam * 0.3
            if np.abs(d).max() < 1e-14:
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return R, t


def relative_pose(uv1: np.ndarray, uv2: np.ndarray, cam: dict):
    x1, x2 = normalized(uv1, cam), normalized(uv2, cam)
    R, t = pose_from_E(eight_point(x1, x2), x1, x2)
    return refine(R, t, x1, x2)
