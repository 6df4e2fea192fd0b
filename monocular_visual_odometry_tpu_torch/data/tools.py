"""Offline camera tools: calibration, undistortion, dataset renaming.

Port of ``monocular_visual_odometry_tpu.data.tools`` (host tools, as there):

- :func:`calibrate_camera`: Zhang's method, per-view homographies by
  normalized DLT, closed-form intrinsics from the absolute-conic
  constraints, extrinsics per view, then a joint Levenberg-Marquardt
  refinement of K, (k1, k2) and the 6V view poses. The reference refines
  with scipy's MINPACK ``least_squares(method="lm")``; the port has its own
  f64 LM (:func:`_levenberg_marquardt`) in torch on the CPU, the Jacobian
  from ``torch.func.jacfwd`` of the residual and the rotations through
  :func:`ops.lie.rodrigues`/:func:`ops.lie.so3_log`. The two stop at
  different points of the same minimum, so they agree by tolerance, not bit
  for bit.
- :func:`find_chessboard_corners` uses OpenCV when present, as the
  reference does, and raises ``NotImplementedError`` without it.
- :func:`undistort_image` / :func:`distort_image`: inverse mapping with
  bilinear sampling (numpy, the reference's arithmetic).
- :func:`rename_image_filenames`: frames to the ``rgb_%05d.png`` layout.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Sequence

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import lie


# ---------------------------------------------------------------------------
# Zhang calibration
# ---------------------------------------------------------------------------


def _homography_dlt(obj_xy: np.ndarray, img_uv: np.ndarray) -> np.ndarray:
    """Plane-to-image homography via normalized DLT (f64 host math)."""

    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2) / max(np.sqrt(((p - c) ** 2).sum(1)).mean(), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return (p - c) * s, T

    a, Ta = normalize(obj_xy)
    b, Tb = normalize(img_uv)
    rows = []
    for (x, y), (u, v) in zip(a, b):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(rows))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ H @ Ta
    return H / H[2, 2]


def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


# the refine's budget and tolerances: the reference's max_nfev, scipy's
# default ftol = xtol = gtol
_LM_MAX_NFEV = 200
_LM_TOL = 1e-8


def _levenberg_marquardt(fun: Callable[[torch.Tensor], torch.Tensor],
                         x0: torch.Tensor) -> torch.Tensor:
    """Minimise ``0.5 * ||fun(x)||^2`` from ``x0`` (f64) by Levenberg-Marquardt
    with Marquardt's diagonal scaling (the largest diagonal of J^T J seen so
    far, as MINPACK keeps it) and Nielsen's damping update. Stops after
    ``_LM_MAX_NFEV`` evaluations of ``fun`` (Jacobians not counted), or when
    the largest cosine between the residual and a column of J, the step or
    the relative decrease of the cost falls below ``_LM_TOL``."""
    jac = torch.func.jacfwd(fun)
    x = x0.clone()
    r = fun(x)
    nfev = 1
    cost = float(r @ r)
    J = jac(x)
    A, g = J.T @ J, J.T @ r
    scale = torch.clamp(torch.diagonal(A).clone(), min=1e-30)
    mu, nu = 1e-3, 2.0
    while nfev < _LM_MAX_NFEV:
        # the largest cosine between the residual and a column of J
        col = torch.clamp(torch.diagonal(A), min=1e-300).sqrt()
        if float((g.abs() / col).max()) <= _LM_TOL * max(cost, 1e-300) ** 0.5:
            break
        h = torch.linalg.solve(A + mu * torch.diag(scale), -g)
        if float(h.norm()) <= _LM_TOL * (float(x.norm()) + _LM_TOL):
            break
        x_new = x + h
        r_new = fun(x_new)
        nfev += 1
        cost_new = float(r_new @ r_new)
        predicted = float(h @ (mu * scale * h - g))
        rho = (cost - cost_new) / predicted if predicted > 0 else -1.0
        if rho > 0:
            decrease = cost - cost_new
            x, r, cost = x_new, r_new, cost_new
            J = jac(x)
            A, g = J.T @ J, J.T @ r
            scale = torch.maximum(scale, torch.diagonal(A))
            mu *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            if decrease <= _LM_TOL * (cost + decrease):
                break
        else:
            mu *= nu
            nu *= 2.0
    return x


def calibrate_camera(object_points: Sequence[np.ndarray],
                     image_points: Sequence[np.ndarray],
                     image_size: tuple[int, int],
                     refine: bool = True):
    """Zhang's calibration from N planar views.

    object_points: list of [M,2] planar board coordinates (z=0 implied).
    image_points:  list of [M,2] detected pixel corners.
    Returns (K [3,3], dist [k1, k2], rms reprojection error px).
    """
    Hs = [_homography_dlt(o, i) for o, i in zip(object_points, image_points)]
    V = []
    for H in Hs:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    # closed-form intrinsics (Zhang A.3)
    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12**2)
    lam = b33 - (b13**2 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = np.sqrt(abs(lam / b11))
    beta = np.sqrt(abs(lam * b11 / (b11 * b22 - b12**2)))
    gamma = -b12 * alpha**2 * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha**2 / lam
    K = np.array([[alpha, gamma, u0], [0, beta, v0], [0, 0, 1.0]])

    # extrinsics per view
    Kinv = np.linalg.inv(K)
    RTs = []
    for H in Hs:
        h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
        s = 1.0 / np.linalg.norm(Kinv @ h1)
        r1 = s * (Kinv @ h1)
        r2 = s * (Kinv @ h2)
        r3 = np.cross(r1, r2)
        t = s * (Kinv @ h3)
        Rm = np.stack([r1, r2, r3], axis=1)
        U, _, Vt2 = np.linalg.svd(Rm)
        RTs.append((U @ Vt2, t))

    def project_all(K, dist, RTs):
        k1, k2 = dist
        errs = []
        for (o, i), (Rm, t) in zip(zip(object_points, image_points), RTs):
            P = np.concatenate([o, np.zeros((len(o), 1))], axis=1)
            pc = P @ Rm.T + t
            xy = pc[:, :2] / pc[:, 2:3]
            r2 = (xy**2).sum(1, keepdims=True)
            xy_d = xy * (1 + k1 * r2 + k2 * r2**2)
            uv = xy_d @ K[:2, :2].T + K[:2, 2]
            errs.append(uv - i)
        return np.concatenate(errs)

    dist = np.zeros(2)
    err = project_all(K, dist, RTs)

    if refine:
        # parameters: fx, fy, cx, cy, k1, k2, then (rotation vector, t) per view
        n_views = len(RTs)
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        obj = [f64(np.concatenate([o, np.zeros((len(o), 1))], axis=1)) for o in object_points]
        img = [f64(i) for i in image_points]
        rvecs = lie.so3_log(f64(np.stack([Rm for Rm, _ in RTs])))
        p0 = torch.cat([f64([K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist[0], dist[1]]),
                        torch.cat([rvecs, f64(np.stack([t for _, t in RTs]))], 1).reshape(-1)])

        def residual(p):
            views = p[6:].reshape(n_views, 6)
            R = lie.rodrigues(views[:, :3])
            errs = []
            for v in range(n_views):
                pc = obj[v] @ R[v].T + views[v, 3:]
                xy = pc[:, :2] / pc[:, 2:3]
                r2 = (xy**2).sum(1, keepdim=True)
                xy_d = xy * (1 + p[4] * r2 + p[5] * r2**2)
                errs.append(xy_d * p[0:2] + p[2:4] - img[v])
            return torch.cat(errs).reshape(-1)

        p = _levenberg_marquardt(residual, p0).numpy()
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        dist = p[4:6].copy()
        views = p[6:].reshape(n_views, 6)
        R = lie.rodrigues(torch.from_numpy(views[:, :3].copy())).numpy()
        RTs = [(R[v], views[v, 3:]) for v in range(n_views)]
        err = project_all(K, dist, RTs)

    rms = float(np.sqrt((err**2).sum(1).mean()))
    return K, dist, rms


def find_chessboard_corners(img: np.ndarray, pattern_size=(8, 6)):
    """Chessboard inner-corner detection with OpenCV (optional, as in the
    reference): [N,2] pixels, or None when the board is not found."""
    try:
        import cv2
    except ImportError:
        raise NotImplementedError(
            "chessboard corner search needs opencv-python (offline tool only)")
    ok, corners = cv2.findChessboardCorners(np.asarray(img, np.uint8), pattern_size)
    if not ok:
        return None
    corners = cv2.cornerSubPix(
        np.asarray(img, np.uint8), corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
    return corners.reshape(-1, 2).astype(np.float64)


def chessboard_object_points(pattern_size=(8, 6), square: float = 1.0) -> np.ndarray:
    """Planar board coordinates for :func:`calibrate_camera`."""
    w, h = pattern_size
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64) * square


# ---------------------------------------------------------------------------
# undistortion
# ---------------------------------------------------------------------------


def _unpack_dist(dist) -> tuple:
    """(k1, k2, p1, p2) from a Brown-Conrady coefficient vector of any
    length <= 4 (missing terms are 0)."""
    d = list(dist) + [0.0] * 4
    return d[0], d[1], d[2], d[3]


def _bilinear_sample(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``img`` [H,W] at float pixel coords (u, v); samples
    outside the image are 0."""
    H, W = img.shape[:2]
    u0 = np.clip(np.floor(u).astype(int), 0, W - 2)
    v0 = np.clip(np.floor(v).astype(int), 0, H - 2)
    fu = np.clip(u - u0, 0, 1)
    fv = np.clip(v - v0, 0, 1)
    out = (img[v0, u0] * (1 - fu) * (1 - fv) + img[v0, u0 + 1] * fu * (1 - fv)
           + img[v0 + 1, u0] * (1 - fu) * fv + img[v0 + 1, u0 + 1] * fu * fv)
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return np.where(inside, out, 0.0)


def undistort_image(img: np.ndarray, K: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Radial (k1, k2[, p1, p2]) undistortion by inverse mapping and bilinear
    sampling."""
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape[:2]
    k1, k2, p1, p2 = _unpack_dist(dist)
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    x = (us - K[0, 2]) / K[0, 0]
    y = (vs - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return _bilinear_sample(img, xd * K[0, 0] + K[0, 2],
                            yd * K[1, 1] + K[1, 2])


def distort_image(img: np.ndarray, K: np.ndarray, dist: np.ndarray,
                  iters: int = 5) -> np.ndarray:
    """Apply lens distortion to an ideal (pinhole) image, the inverse of
    :func:`undistort_image`: each distorted pixel's undistorted position by
    fixed-point inversion of the Brown-Conrady model, then a bilinear sample
    of the ideal image there. Simulates a raw camera."""
    img = np.asarray(img, dtype=np.float64)
    k1, k2, p1, p2 = _unpack_dist(dist)
    H, W = img.shape[:2]
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    xd = (us - K[0, 2]) / K[0, 0]
    yd = (vs - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return _bilinear_sample(img, x * K[0, 0] + K[0, 2],
                            y * K[1, 1] + K[1, 2])


# ---------------------------------------------------------------------------
# dataset renaming
# ---------------------------------------------------------------------------


def rename_image_filenames(src_dir: str, dst_dir: str, start_index: int = 0,
                           pattern: str = "rgb_{:05d}.png",
                           extensions=(".png", ".jpg", ".jpeg")) -> list[str]:
    """Copy the frames of ``src_dir`` (sorted) into ``dst_dir`` under the
    ``rgb_%05d.png`` naming. Returns the new paths."""
    os.makedirs(dst_dir, exist_ok=True)
    srcs = sorted(
        f for f in os.listdir(src_dir)
        if os.path.splitext(f)[1].lower() in extensions)
    out = []
    for i, name in enumerate(srcs):
        dst = os.path.join(dst_dir, pattern.format(start_index + i))
        shutil.copyfile(os.path.join(src_dir, name), dst)
        out.append(dst)
    return out
