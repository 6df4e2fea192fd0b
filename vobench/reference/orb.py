"""Plain reference of the ORB frontend's corner score.

What the port's frontend is specified to compute for each keypoint it keeps
(its Harris score on the pyramid atlas), written from that specification in
plain PyTorch, in any floating type and on any device, with no kernel of the
port. The benchmark judges the scores a timed frame stored with its
keypoints against :func:`harris_at` on the same frame in float64.

The semantics the port documents and this follows:

- the pyramid: ``n_levels`` levels, each ``round(previous / scale)`` (at
  least 52) by bilinear interpolation with half-pixel centres (a matrix
  product per axis), packed side by side into one canvas with 32-pixel
  gutters and margin, the height rounded up to the cell size and the width to
  a multiple of 128;
- Harris: Sobel gradients of a [1,2,1]/4 smoothing and a central difference
  /2 (zero beyond the canvas), a 7x7 box mean of the structure tensor (two
  banded matrix products), ``det - k tr^2``;
- a keypoint's level-0 position is ``(x - level offset) * scale^level``, so
  its canvas position is ``round(position / scale^level)`` plus the level's
  offset.
"""

from __future__ import annotations

import numpy as np
import torch

MARGIN = 32
MIN_SIDE = 52   # a level is at least 2 x 22 (the border) + 8 pixels


def _level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(max(int(round(h / scale ** l)), MIN_SIDE), max(int(round(w / scale ** l)), MIN_SIDE))
            for l in range(n_levels)]


def _interp(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation, half-pixel centres, clamped."""
    A = np.zeros((n_out, n_in))
    s = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * s - 0.5
        j0 = int(np.floor(src))
        f = src - j0
        A[i, min(max(j0, 0), n_in - 1)] += 1.0 - f
        A[i, min(max(j0 + 1, 0), n_in - 1)] += f
    return A


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _canvas(img: torch.Tensor, n_levels: int, scale: float, cell: int):
    """(canvas, per-level (ox, oy, h, w))."""
    h, w = img.shape
    shapes = _level_shapes(h, w, n_levels, scale)
    levels, prev = [img], img
    for (ho, wo) in shapes[1:]:
        A = torch.from_numpy(_interp(ho, prev.shape[0])).to(img)
        B = torch.from_numpy(_interp(wo, prev.shape[1]).T.copy()).to(img)
        prev = A @ prev @ B
        levels.append(prev)
    geo, ox = [], MARGIN
    for (lh, lw) in shapes:
        geo.append((ox, MARGIN, lh, lw))
        ox += lw + MARGIN
    H, W = _round_up(h + 2 * MARGIN, cell), _round_up(ox, max(cell, 128))
    canvas = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    for lvl, (x0, y0, lh, lw) in zip(levels, geo):
        canvas[y0:y0 + lh, x0:x0 + lw] = lvl
    return canvas, geo


def _shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx], zero outside."""
    H, W = a.shape
    out = torch.zeros_like(a)
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0), H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0), W + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def _band(n: int, r: int, like: torch.Tensor) -> torch.Tensor:
    """[n,n] with ones where |i - j| <= r: a (2r+1)-tap box sum, zero
    beyond the ends, as a matrix product."""
    i = torch.arange(n, device=like.device)
    return ((i[:, None] - i[None, :]).abs() <= r).to(like.dtype)


def _box_mean(a: torch.Tensor, r: int) -> torch.Tensor:
    n = 2 * r + 1
    return _band(a.shape[0], r, a) @ a @ _band(a.shape[1], r, a) / (n * n)


def _harris(a: torch.Tensor, k: float) -> torch.Tensor:
    sm_y = (_shifted(a, -1, 0) + 2.0 * a + _shifted(a, 1, 0)) * 0.25
    sm_x = (_shifted(a, 0, -1) + 2.0 * a + _shifted(a, 0, 1)) * 0.25
    gx = (_shifted(sm_y, 0, 1) - _shifted(sm_y, 0, -1)) * 0.5
    gy = (_shifted(sm_x, 1, 0) - _shifted(sm_x, -1, 0)) * 0.5
    ixx, iyy, ixy = _box_mean(gx * gx, 3), _box_mean(gy * gy, 3), _box_mean(gx * gy, 3)
    tr = ixx + iyy
    return ixx * iyy - ixy * ixy - k * tr * tr


def harris_at(img: torch.Tensor, kpts: np.ndarray, levels: np.ndarray, orb: dict,
              dtype=torch.float64) -> np.ndarray:
    """The Harris score [n] of the frame ``img`` at keypoints given as
    level-0 positions ``kpts`` [n,2] and their pyramid ``levels`` [n]."""
    a = img.to(dtype)
    canvas, geo = _canvas(a, orb["n_levels"], orb["scale_factor"], orb["grid_size"])
    score = _harris(canvas, orb["harris_k"])
    s_l = np.array([orb["scale_factor"] ** l for l in range(orb["n_levels"])],
                   dtype=np.float32)[levels]
    xa = np.rint(kpts[:, 0] / s_l).astype(np.int64) + np.array([g[0] for g in geo])[levels]
    ya = np.rint(kpts[:, 1] / s_l).astype(np.int64) + MARGIN
    at = score[torch.from_numpy(ya).to(a.device), torch.from_numpy(xa).to(a.device)]
    return at.double().cpu().numpy()
