"""Binary-descriptor matching.

Port of ``monocular_visual_odometry_tpu.ops.matching``: methods 1
(global nearest + threshold), 2 (Lowe ratio) and 3 (radius-gated nearest,
the default), the optional ambiguity gate, the union radius gate
(``kpts1_alt``) and the deterministic best-distance dedup per train index.

Every method and every device goes through
:func:`ops.cuda.hamming.hamming_nn_top2` (on CUDA the hand-written kernel,
on the CPU its plain version); methods 1 and 2 pass a radius of 1e6. The
all-pairs helpers of the JAX module (``hamming_matrix``, ``top2_min``,
``pixel_dist2_matrix``, ``unpack_pm1``) live beside that plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from monocular_visual_odometry_tpu_torch.ops.cuda.hamming import hamming_nn_top2

_INF = 1e9
_INT32_MAX = 2**31 - 1


class Matches(NamedTuple):
    """Fixed-capacity match set, one slot per query."""

    query_idx: torch.Tensor  # [M] int64 index into set 1
    train_idx: torch.Tensor  # [M] int64 index into set 2
    dist: torch.Tensor       # [M] float32 Hamming distance (1e9 if invalid)
    valid: torch.Tensor      # [M] bool

    @property
    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def _dedup_best_per_train(query_idx, train_idx, dist, valid, n_train: int):
    """Keep only the best (min-dist, then lowest query) match per train
    index: a scatter-min of the int32 key ``dist * (K+1) + query`` with the
    distance clamped at 300, so the key cannot overflow."""
    K = query_idx.shape[0]
    dist_clamped = torch.clamp(dist, max=300.0)
    key = (dist_clamped.to(torch.int32) * (K + 1) + query_idx.to(torch.int32)).to(torch.int32)
    key = torch.where(valid, key, torch.full_like(key, _INT32_MAX))
    table = torch.full((n_train,), _INT32_MAX, dtype=torch.int32, device=key.device)
    safe_train = torch.where(valid, train_idx, torch.zeros_like(train_idx))
    table = table.scatter_reduce(0, safe_train, key, reduce="amin", include_self=True)
    return valid & (table[safe_train] == key)


def match_features(
    desc1: torch.Tensor, desc2: torch.Tensor,
    valid1: torch.Tensor, valid2: torch.Tensor,
    kpts1: Optional[torch.Tensor] = None, kpts2: Optional[torch.Tensor] = None,
    *,
    method: int = 3,
    max_pixel_dist: float = 50.0,
    xiang_gao_ratio: float = 2.0,
    lowe_ratio: float = 0.8,
    dist_floor: float = 30.0,
    ambiguity_ratio: float = 1.0,
    kpts1_alt: Optional[torch.Tensor] = None,
) -> Matches:
    """Match descriptor set 1 (query) against set 2 (train); one slot per
    query, duplicates per train index resolved to the best distance.

    - method 1: nearest per query, keep ``dist < max(min_dist * ratio, 30)``;
    - method 2: Lowe ratio ``d1 < ratio * d2``;
    - method 3: nearest within ``max_pixel_dist`` of ``kpts1`` (or of
      ``kpts1_alt``), then the method-1 threshold over the gated set.
    """
    K1, K2 = desc1.shape[0], desc2.shape[0]
    dev = desc1.device
    if method == 3:
        assert kpts1 is not None and kpts2 is not None
    radius = float(max_pixel_dist) if method == 3 else 1e6
    uv1 = kpts1 if kpts1 is not None else torch.zeros((K1, 2), device=dev)
    uv2 = kpts2 if kpts2 is not None else torch.zeros((K2, 2), device=dev)
    best, second, train = hamming_nn_top2(desc1, uv1, valid1, desc2, uv2, valid2,
                                          radius, uv1_alt=kpts1_alt)
    train = train.to(torch.int64)

    if method == 2:
        ok = (best < lowe_ratio * second) & (best < _INF)
    else:
        matched = best < _INF
        min_dist = torch.min(torch.where(matched, best, torch.full_like(best, _INF)))
        thresh = torch.clamp(min_dist * xiang_gao_ratio, min=dist_floor)
        ok = matched & (best < thresh)
        if ambiguity_ratio < 1.0:
            ok = ok & (best < ambiguity_ratio * second)

    query = torch.arange(K1, device=dev)
    ok = ok & valid1
    winner = _dedup_best_per_train(query, train, best, ok, K2)
    return Matches(query_idx=query, train_idx=train,
                   dist=torch.where(winner, best, torch.full_like(best, _INF)),
                   valid=winner)


def mean_pixel_displacement(kpts1, kpts2, matches: Matches) -> torch.Tensor:
    """Mean pixel distance between matched keypoints (the init gate)."""
    p1 = kpts1[matches.query_idx]
    p2 = kpts2[matches.train_idx]
    dist = torch.linalg.norm(p1 - p2, dim=-1)
    n = torch.clamp(matches.n_valid, min=1)
    return torch.sum(torch.where(matches.valid, dist, torch.zeros_like(dist))) / n
