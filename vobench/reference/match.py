"""Plain reference of the tracking frame's 3-D to 2-D match.

The port's tracking match (``models/vo.py::track_candidates`` and
``match_candidates``, the ``hamming_nn_top2`` kernel) pairs each map point of
the candidate pool with the frame keypoint of least Hamming distance among
the valid keypoints within ``radius`` pixels of the point's projection at
the constant-velocity prediction of the pose, or (the union gate) at the
previous pose. :func:`misses` takes the links a frame's inliers ended with
and counts those that are not such a nearest keypoint: the keypoint lies
outside both gates, or another keypoint inside them is nearer in Hamming
distance. Projections are float64; keypoints within ``tol`` pixels of a
gate's edge count either way.
"""

from __future__ import annotations

import numpy as np

from . import pose

BEHIND = 1e9


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,M] bit distances between packed descriptors a [N,32] and b [M,32]."""
    return np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1).astype(np.int64)


def _gate_proj(T_w_c, X, cam, height, width, in_frame_only):
    uv, p = pose.project(pose.inv(T_w_c), X, cam)
    bad = p[:, 2] <= 0
    if in_frame_only:
        bad |= ~((uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height))
    return np.where(bad[:, None], BEHIND, uv)


def misses(X, desc_pts, link_kpt, kpts, desc_kpts, valid_kpts, T_pred, T_stale, cam: dict,
           height: int, width: int, radius: float, tol: float = 0.01) -> int:
    """How many of the links (map point l, with world position ``X[l]`` and
    descriptor ``desc_pts[l]``, to keypoint ``link_kpt[l]``) are not the
    point's gated nearest keypoint. ``T_stale`` None: no union gate."""
    X = np.asarray(X, np.float64)
    kpts = np.asarray(kpts, np.float64)
    d2 = None
    for T, in_frame_only in ((T_pred, False), (T_stale, True)):
        if T is None:
            continue
        uv = _gate_proj(np.asarray(T, np.float64), X, cam, height, width, in_frame_only)
        e = ((uv[:, None, :] - kpts[None, :, :]) ** 2).sum(-1)
        d2 = e if d2 is None else np.minimum(d2, e)
    inside = valid_kpts[None, :] & (d2 <= (radius - tol) ** 2)
    ham = hamming(np.asarray(desc_pts), np.asarray(desc_kpts))
    best = np.where(inside, ham, np.iinfo(np.int64).max).min(1)
    rows = np.arange(len(X))
    near = d2[rows, link_kpt] <= (radius + tol) ** 2
    return int((~near | (ham[rows, link_kpt] > best)).sum())
