"""ORB-class feature frontend: FAST + Harris + oriented BRIEF, in PyTorch.

Port of ``monocular_visual_odometry_tpu.ops.features`` with the same
pyramid atlas (all levels packed side by side in one canvas with 32-px
gutters), the same shift-add Sobel and cumulative-sum box filters, the
same per-cell top-k and steered BRIEF over a shared 128-point pool. The
layouts of the JAX function are kept: ``[K,2]`` keypoints, ``[K,32]`` uint8
packed descriptors, a ``[K]`` validity mask.

Points where a straight translation would diverge from the JAX semantics:

- the adaptive FAST threshold uses the *population* std (``correction=0``);
- the global top-K is a stable descending sort (JAX's ``approx_max_k`` is
  exact on the CPU), so ties keep the lower candidate index;
- the descriptor gather clamps its flat index (``take(mode="clip")``);
- ``torch.round`` rounds half to even, like ``jnp.round``;
- the pyramid resize is two fp32 matrix products with TF32 off
  (``ops.precision``): its precision moves ATE in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)
from monocular_visual_odometry_tpu_torch.utils.config import OrbConfig

# FAST-9/16: Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock.
_FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

# Keypoints closer than this to a level's edge are discarded (covers the
# rotated BRIEF pool reach, 15 * sqrt(2)).
_BORDER = 22
# Inter-level gutter and outer margin of the atlas (exceeds every filter radius).
_MARGIN = 32

_POOL_SIZE = 128
_N_BITS = 256
_PATCH_RADIUS = 15


class FrameFeatures(NamedTuple):
    """Fixed-capacity keypoint set."""

    kpts: torch.Tensor     # [K, 2] (x, y) level-0 pixels
    scores: torch.Tensor   # [K] Harris response
    angles: torch.Tensor   # [K] orientation (radians)
    levels: torch.Tensor   # [K] int32 pyramid level
    desc: torch.Tensor     # [K, 32] uint8 packed 256-bit descriptor
    valid: torch.Tensor    # [K] bool
    gray: torch.Tensor     # [K] image intensity at the keypoint

    @property
    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def brief_pool_pattern(seed: int = 42, n_points: int = _POOL_SIZE,
                       n_bits: int = _N_BITS,
                       patch_radius: int = _PATCH_RADIUS):
    """Shared-pool BRIEF pattern: ``n_points`` Gaussian(0, patch/2.2) sample
    offsets clipped to the patch, plus ``n_bits`` distinct (i, j) index
    pairs into the pool. Returns (points [P,2] int32, pair_i [B], pair_j [B])."""
    rng = np.random.default_rng(seed)
    sigma = patch_radius / 2.2
    pts = np.clip(
        np.round(rng.normal(0.0, sigma, size=(n_points, 2))),
        -patch_radius, patch_radius,
    ).astype(np.int32)
    seen = set()
    pair_i, pair_j = [], []
    while len(pair_i) < n_bits:
        i, j = rng.integers(0, n_points, 2)
        if i == j or (i, j) in seen or (j, i) in seen:
            continue
        seen.add((i, j))
        pair_i.append(i)
        pair_j.append(j)
    return pts, np.asarray(pair_i, np.int32), np.asarray(pair_j, np.int32)


_POOL_PTS, _PAIR_I, _PAIR_J = brief_pool_pattern()


# ---------------------------------------------------------------------------
# shift / box-filter primitives
# ---------------------------------------------------------------------------


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], zero beyond the edge."""
    H, W = img.shape
    pad = F.pad(img, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return pad[y0:y0 + H, x0:x0 + W]


_SCAN_BLOCK = 16


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """fp32 prefix sum along the last axis in the JAX package's order.

    XLA on the CPU rewrites a cumulative sum into blocks of 16: a
    left-to-right running sum inside each block, the same scheme applied
    recursively to the block totals, then each block's exclusive prefix
    added. The box filters take differences of these sums, so their
    rounding shows directly in the Harris scores that rank keypoints;
    ``torch.cumsum`` (which accumulates in float64 on the CPU) ranks a few
    near-tied corners differently. This reproduces the XLA order exactly,
    on any device."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(x.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = _cumsum_last(blocks)
    prefix = _cumsum_last(inner[..., -1])
    excl = F.pad(prefix[..., :-1], (1, 0))
    out = inner + excl[..., None]
    return out.reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))[..., :n]


def _box1d(img: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """(2r+1)-tap box sum along ``axis`` with zero boundary, via cumsum."""
    n = img.shape[axis]
    c = _cumsum_last(img) if axis == 1 else _cumsum_last(img.T).T
    if axis == 1:
        c = F.pad(c, (r + 1, r))
        return c[:, 2 * r + 1:2 * r + 1 + n] - c[:, :n]
    c = F.pad(c, (0, 0, r + 1, r))
    return c[2 * r + 1:2 * r + 1 + n, :] - c[:n, :]


def box_filter(img: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)x(2r+1) box *sum*, zero boundary."""
    return _box1d(_box1d(img, r, 1), r, 0)


def _sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sm_y = (_shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)) * 0.25
    sm_x = (_shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)) * 0.25
    gx = (_shift(sm_y, 0, 1) - _shift(sm_y, 0, -1)) * 0.5
    gy = (_shift(sm_x, 1, 0) - _shift(sm_x, -1, 0)) * 0.5
    return gx, gy


# ---------------------------------------------------------------------------
# FAST + Harris
# ---------------------------------------------------------------------------


def fast_corner_mask(img: torch.Tensor, threshold) -> torch.Tensor:
    """FAST-9/16 segment test over 16 shifted planes; bool [H,W]. The
    16-bit arc masks live in int64 so the wrap-around shifts stay positive."""
    H, W = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    bright = torch.zeros((H, W), dtype=torch.int64, device=img.device)
    dark = torch.zeros((H, W), dtype=torch.int64, device=img.device)
    hi = img + threshold
    lo = img - threshold
    for i, (dx, dy) in enumerate(_FAST_OFFSETS):
        p = pad[3 + int(dy):3 + int(dy) + H, 3 + int(dx):3 + int(dx) + W]
        bright |= (p > hi).to(torch.int64) << i
        dark |= (p < lo).to(torch.int64) << i

    def has_run9(m16: torch.Tensor) -> torch.Tensor:
        m = m16 | (m16 << 16)
        a = m & (m >> 1)
        b = a & (a >> 2)
        c = b & (b >> 4)
        d = c & (m >> 8)
        return (d & 0xFFFF) != 0

    return has_run9(bright) | has_run9(dark)


def harris_response(img: torch.Tensor, k: float = 0.04, window: int = 7) -> torch.Tensor:
    """Harris corner response, [H,W] float32."""
    r = window // 2
    inv_n = 1.0 / float(window * window)
    gx, gy = _sobel(img)
    ixx = box_filter(gx * gx, r) * inv_n
    iyy = box_filter(gy * gy, r) * inv_n
    ixy = box_filter(gx * gy, r) * inv_n
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression mask (max-pool pads with -inf)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= m


# ---------------------------------------------------------------------------
# pyramid atlas
# ---------------------------------------------------------------------------


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [
        (max(int(round(height / scale**l)), 2 * _BORDER + 8),
         max(int(round(width / scale**l)), 2 * _BORDER + 8))
        for l in range(n_levels)
    ]


@functools.lru_cache(maxsize=16)
def atlas_geometry(height: int, width: int, n_levels: int, scale: float,
                   grid_size: int = 16):
    """Level shapes, per-level (ox, oy) atlas offsets, and atlas dims."""
    shapes = pyramid_shapes(height, width, n_levels, scale)
    offsets = []
    ox = _MARGIN
    for (h, w) in shapes:
        offsets.append((ox, _MARGIN))
        ox += w + _MARGIN

    def _round_up(v, m):
        return ((v + m - 1) // m) * m
    H_A = _round_up(height + 2 * _MARGIN, grid_size)
    W_A = _round_up(ox, max(grid_size, 128))
    return shapes, offsets, H_A, W_A


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Static [n_out, n_in] bilinear interpolation matrix (align-corners
    false)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        f = src - j0
        j0c = min(max(j0, 0), n_in - 1)
        j1c = min(max(j0 + 1, 0), n_in - 1)
        A[i, j0c] += 1.0 - f
        A[i, j1c] += f
    return A


@functools.lru_cache(maxsize=16)
def _atlas_constants(height: int, width: int, n_levels: int, scale: float,
                     grid_size: int, device: str):
    """Device-resident atlas lookups: the inside-mask, the column->level
    map, per-level offsets/scales, and the resize matrices."""
    shapes, offsets, H_A, W_A = atlas_geometry(height, width, n_levels, scale,
                                               grid_size)
    inside = np.zeros((H_A, W_A), dtype=bool)
    col_level = np.zeros(W_A, dtype=np.int64)
    for l, ((h, w), (ox, oy)) in enumerate(zip(shapes, offsets)):
        inside[oy + _BORDER: oy + h - _BORDER, ox + _BORDER: ox + w - _BORDER] = True
        col_level[ox: ox + w] = l
    lvl_ox = np.asarray([o[0] for o in offsets], dtype=np.float32)
    lvl_oy = np.asarray([o[1] for o in offsets], dtype=np.float32)
    lvl_scale = np.asarray([scale**l for l in range(n_levels)], dtype=np.float32)
    resize = []
    prev = (height, width)
    for l in range(1, n_levels):
        h_out, w_out = shapes[l]
        resize.append((torch.from_numpy(_interp_matrix(h_out, prev[0])).to(device),
                       torch.from_numpy(_interp_matrix(w_out, prev[1]).T.copy()).to(device)))
        prev = (h_out, w_out)
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(inside=t(inside), col_level=t(col_level), lvl_ox=t(lvl_ox),
                lvl_oy=t(lvl_oy), lvl_scale=t(lvl_scale), resize=resize,
                pool=t(_POOL_PTS.astype(np.float32)),
                pair_i=t(_PAIR_I.astype(np.int64)), pair_j=t(_PAIR_J.astype(np.int64)),
                weights=t(np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32)))


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """Bilinear pyramid by two fp32 matrix products per level."""
    H, W = img.shape
    consts = _atlas_constants(H, W, n_levels, scale, 16, str(img.device))
    levels = [img]
    for Ar, AcT in consts["resize"]:
        levels.append(Ar @ levels[-1] @ AcT)
    return levels


def build_atlas(img: torch.Tensor, n_levels: int, scale: float,
                grid_size: int = 16) -> torch.Tensor:
    """Pack the pyramid into one [H_A, W_A] canvas (zeros in the gutters)."""
    H, W = img.shape
    shapes, offsets, H_A, W_A = atlas_geometry(H, W, n_levels, scale, grid_size)
    levels = build_pyramid(img, n_levels, scale)
    cols = []
    for (h, w), (ox, oy), lvl in zip(shapes, offsets, levels):
        cols.append(F.pad(lvl, (_MARGIN, 0, oy, H_A - oy - h)))
    atlas = torch.cat(cols, dim=1)
    return F.pad(atlas, (0, W_A - atlas.shape[1]))


# ---------------------------------------------------------------------------
# grid-uniform candidate selection
# ---------------------------------------------------------------------------


def cell_topk(score: torch.Tensor, cell: int, k: int):
    """Per-cell top-``k`` of a [H, W] score map via ``k`` masked argmaxes
    (first index on ties). Returns (scores [C*k], ys [C*k], xs [C*k])."""
    H, W = score.shape
    ncy, ncx = H // cell, W // cell
    s = score.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    s = s.reshape(ncy * ncx, cell * cell).clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(s, dim=1, keepdim=True)
        vals.append(torch.gather(s, 1, i)[:, 0])
        idxs.append(i[:, 0])
        s.scatter_(1, i, float("-inf"))
    v = torch.stack(vals, dim=1).reshape(-1)
    i = torch.stack(idxs, dim=1).reshape(-1)
    cid = torch.arange(ncy * ncx, device=score.device).repeat_interleave(k)
    ys = (cid // ncx) * cell + i // cell
    xs = (cid % ncx) * cell + i % cell
    return v, ys, xs


# ---------------------------------------------------------------------------
# orientation + descriptors
# ---------------------------------------------------------------------------


def _moment_maps(img: torch.Tensor, radius: int = _PATCH_RADIUS):
    """Intensity-centroid moments m10, m01 via the box-filter identity."""
    H, W = img.shape
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    bx_i = _box1d(img, radius, 1)
    m10 = _box1d(_box1d(xs * img, radius, 1) - xs * bx_i, radius, 0)
    by_i = _box1d(img, radius, 0)
    m01 = _box1d(_box1d(ys * img, radius, 0) - ys * by_i, radius, 1)
    return m10, m01


def _descriptors_from_pool(blur_flat: torch.Tensor, W_A: int, xa: torch.Tensor,
                           ya: torch.Tensor, angles: torch.Tensor, consts) -> torch.Tensor:
    """Steered-BRIEF bits from one [K, P] gather of the smoothed atlas."""
    pat = consts["pool"]
    ca, sa = torch.cos(angles), torch.sin(angles)
    px, py = pat[:, 0], pat[:, 1]
    rx = torch.round(ca[:, None] * px[None, :] - sa[:, None] * py[None, :]).to(torch.int64)
    ry = torch.round(sa[:, None] * px[None, :] + ca[:, None] * py[None, :]).to(torch.int64)
    flat = (ya[:, None] + ry) * W_A + (xa[:, None] + rx)
    vals = blur_flat[flat.clamp(0, blur_flat.shape[0] - 1)]
    b1 = vals[:, consts["pair_i"]]
    b2 = vals[:, consts["pair_j"]]
    bits = (b1 < b2).to(torch.int32)
    packed = torch.sum(bits.reshape(-1, 32, 8) * consts["weights"][None, None, :], dim=-1)
    return packed.to(torch.uint8)


# ---------------------------------------------------------------------------
# top-level frontend
# ---------------------------------------------------------------------------


def detect_and_describe(
    img: torch.Tensor,
    *,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    max_keypoints: int = 1024,
    grid_size: int = 16,
    max_per_cell: int = 8,
    harris_k: float = 0.04,
) -> FrameFeatures:
    """FAST/Harris -> per-cell top-k -> global top-K -> orientation ->
    steered BRIEF on the pyramid atlas. ``img`` is [H,W] float32 in 0..255
    on the device the features should live on."""
    H, W = img.shape
    # adaptive FAST threshold from the frame's contrast (population std)
    contrast = torch.std(img, correction=0)
    threshold = threshold * torch.clamp(contrast * (1.0 / 60.0), 0.15, 1.0)
    atlas = build_atlas(img, n_levels, scale, grid_size)
    H_A, W_A = atlas.shape
    consts = _atlas_constants(H, W, n_levels, scale, grid_size, str(img.device))

    fast = fast_corner_mask(atlas, threshold)
    harris = harris_response(atlas, k=harris_k)
    score = torch.where(fast & _nms3(harris) & consts["inside"], harris,
                        torch.full_like(harris, float("-inf")))

    cand_s, cand_y, cand_x = cell_topk(score, grid_size, max_per_cell)
    order = torch.sort(cand_s, descending=True, stable=True).indices[:max_keypoints]
    top_s = cand_s[order]
    valid = torch.isfinite(top_s)
    xa = cand_x[order]
    ya = cand_y[order]
    levels = consts["col_level"][xa]
    s_l = consts["lvl_scale"][levels]
    kx = (xa.to(torch.float32) - consts["lvl_ox"][levels]) * s_l
    ky = (ya.to(torch.float32) - consts["lvl_oy"][levels]) * s_l
    kpts = torch.where(valid[:, None], torch.stack([kx, ky], dim=-1),
                       torch.zeros((), device=img.device))
    scores = torch.where(valid, top_s, torch.zeros((), device=img.device))

    # clamp invalid slots into range so gathers stay in-bounds
    xa = torch.clamp(xa, _MARGIN, W_A - _MARGIN - 1)
    ya = torch.clamp(ya, _MARGIN, H_A - _MARGIN - 1)

    m10, m01 = _moment_maps(atlas)
    pos = ya * W_A + xa
    angles = torch.atan2(m01.reshape(-1)[pos], m10.reshape(-1)[pos])
    angles = torch.where(valid, angles, torch.zeros((), device=img.device))

    blur = box_filter(atlas, 2) * (1.0 / 25.0)
    desc = _descriptors_from_pool(blur.reshape(-1), W_A, xa, ya, angles, consts)
    desc = torch.where(valid[:, None], desc, torch.zeros((), dtype=torch.uint8,
                                                         device=img.device))

    gray = torch.where(valid, atlas.reshape(-1)[pos], torch.zeros((), device=img.device))
    return FrameFeatures(kpts=kpts, scores=scores, angles=angles,
                         levels=levels.to(torch.int32), desc=desc, valid=valid,
                         gray=gray)


def features_from_config(img: torch.Tensor, cfg: OrbConfig) -> FrameFeatures:
    return detect_and_describe(
        img,
        threshold=cfg.score_threshold,
        n_levels=cfg.n_levels,
        scale=cfg.scale_factor,
        max_keypoints=cfg.max_keypoints,
        grid_size=cfg.grid_size,
        max_per_cell=cfg.max_pts_per_grid,
        harris_k=cfg.harris_k,
    )
