"""Two-view epipolar geometry: E/H estimation, pose recovery, triangulation.

Port of ``monocular_visual_odometry_tpu.ops.epipolar``. Every RANSAC entry
point takes an integer ``key`` for its draws and, for tests, explicit
minimal-set indices ``idx`` that override the draws; the five-point path
(``minimal="5pt"``, ``ops/fivepoint.py``) also takes its basis remix ``G``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops.consts import device_const, take
from monocular_visual_odometry_tpu_torch.ops.fivepoint import five_point_essential
from monocular_visual_odometry_tpu_torch.ops.ransac import (
    hartley_normalize,
    nullspace,
    sample_minimal_sets,
    split_key,
)

_EPS = 1e-9


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _signed_eps(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 0, torch.full_like(w, _EPS), torch.full_like(w, -_EPS))


# ---------------------------------------------------------------------------
# essential matrix
# ---------------------------------------------------------------------------


def _essential_from_null(e, T1, T2):
    En = e.reshape(e.shape[:-1] + (3, 3))
    E = T2.transpose(-1, -2) @ En @ T1
    U, s, Vt = lie.svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    S = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (U * S[..., None, :]) @ Vt


def _eight_point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point algorithm on normalized-plane coords [..., M, 2];
    returns E [..., 3, 3] on the essential manifold."""
    x1n, T1 = hartley_normalize(x1)
    x2n, T2 = hartley_normalize(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    return _essential_from_null(nullspace(A), T1, T2)


def _weighted_eight_point(x1, x2, w):
    """8-point over all correspondences with 0/1 weights w [..., N]."""
    x1n, T1 = hartley_normalize(x1, w > 0)
    x2n, T2 = hartley_normalize(x2, w > 0)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w[..., None]
    return _essential_from_null(nullspace(A), T1, T2)


def _sym_epipolar_dist2(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared point-line epipolar distance; E [..., 3, 3],
    x1, x2 [N, 2] -> [..., N]."""
    h1, h2 = _homog(x1), _homog(x2)
    l2 = torch.einsum("...ij,nj->...ni", E, h1)
    l1 = torch.einsum("...ji,nj->...ni", E, h2)
    num = torch.einsum("ni,...ni->...n", h2, l2)
    d2_2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + _EPS)
    d2_1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + _EPS)
    return d2_1 + d2_2


class RansacModel(NamedTuple):
    model: torch.Tensor        # [3,3] E or H
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor    # scalar


def _consensus_refit(x1, x2, valid, hyps, msac, refit, min_support, cap, ok=None):
    """Best minimal hypothesis (among those with ``ok``, if given), then 4
    rounds of two batched refit chains (one seeded by the best hypothesis's
    gate, one by all valid matches), keeping whichever model scores best.
    Returns the model."""
    scores, d2 = msac(hyps)
    if ok is not None:
        scores = torch.where(ok, scores, torch.full_like(scores, float("inf")))
    best = torch.argmin(scores)
    M_best, s_best = take(hyps, best), take(scores, best)
    inl_cur = torch.stack([(take(d2, best) < cap) & valid, valid])
    for _ in range(4):
        n_sup = torch.sum(inl_cur, dim=-1)
        M_cur = refit(inl_cur.to(x1.dtype))
        s_cur, d2r = msac(M_cur)
        s_cur = torch.where(n_sup >= min_support, s_cur, torch.full_like(s_cur, float("inf")))
        inl_cur = (d2r < cap) & valid[None]
        c_best = torch.argmin(s_cur)
        s_c = take(s_cur, c_best)
        M_best = torch.where(s_c <= s_best, take(M_cur, c_best), M_best)
        s_best = torch.minimum(s_c, s_best)
    return M_best


def estimate_essential(
    x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, key: int | None,
    *, threshold: float, n_hypotheses: int = 512, minimal: str = "8pt",
    idx: Optional[torch.Tensor] = None, G: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> RansacModel:
    """RANSAC essential matrix from normalized-plane correspondences with
    MSAC scoring and a consensus refit. ``threshold`` in normalized units.

    ``minimal="8pt"``: ``n_hypotheses`` eight-point samples. ``"5pt"``:
    ``max(n_hypotheses // 4, 8)`` five-point samples of up to 8 candidates
    each; ``key`` splits into the sample draw and the basis remix, as
    ``jax.random.split`` does in the reference, and ``idx`` / ``G``
    override them. ``u`` [samples, N] are the sample draw's uniforms (see
    ``ransac.sample_minimal_sets``). ``key`` may be None when the draws
    are all given."""
    if minimal not in ("8pt", "5pt"):
        raise ValueError(f"estimate_essential: unknown minimal solver {minimal!r}")
    th = np.float32(threshold)
    cap = float(np.float32(2.0) * (th * th))
    ok = None
    if minimal == "5pt":
        k_s, k_b = split_key(key) if key is not None else (None, None)
        if idx is None:
            idx = sample_minimal_sets(k_s, valid, max(n_hypotheses // 4, 8), 5, u)
        Es, ok = five_point_essential(x1[idx], x2[idx], k_b, G=G)
        Es, ok = Es.reshape(-1, 3, 3), ok.reshape(-1)
    else:
        if idx is None:
            idx = sample_minimal_sets(key, valid, n_hypotheses, 8, u)
        Es = _eight_point(x1[idx], x2[idx])

    def msac(E):
        d2 = _sym_epipolar_dist2(E, x1, x2)
        return torch.sum(torch.where(valid, torch.clamp(d2, max=cap),
                                     torch.zeros_like(d2)), dim=-1), d2

    E_best = _consensus_refit(x1, x2, valid, Es, msac,
                              lambda w: _weighted_eight_point(x1, x2, w), 8, cap, ok)
    inl_best = (_sym_epipolar_dist2(E_best, x1, x2) < cap) & valid
    return RansacModel(E_best, inl_best, torch.sum(inl_best))


def _solve_sym3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form batched solve of symmetric 3x3 systems via the adjugate,
    with a relative-scaled determinant floor."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    scale = torch.clamp(torch.abs(a00) + torch.abs(a11) + torch.abs(a22), min=_EPS)
    floor = _EPS * scale**3
    det = torch.where(torch.abs(det) < floor, floor, det)
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def triangulate(x1: torch.Tensor, x2: torch.Tensor, T_2_1: torch.Tensor) -> torch.Tensor:
    """Linear (inhomogeneous DLT) triangulation of normalized-plane
    correspondences x1, x2 [N, 2]; camera 1 is [I|0], camera 2 is
    ``T_2_1`` [..., 4, 4]. Returns [..., N, 3] points in camera 1."""
    P1 = torch.eye(3, 4, dtype=x1.dtype, device=x1.device)
    P2 = T_2_1[..., :3, :]

    def rows(P, x):
        Pb = P[..., None, :, :]  # [..., 1, 3, 4]
        return torch.stack([x[:, 0:1] * Pb[..., 2, :] - Pb[..., 0, :],
                            x[:, 1:2] * Pb[..., 2, :] - Pb[..., 1, :]], dim=-2)

    r2 = rows(P2, x2)
    r1 = rows(P1, x1).expand(r2.shape)
    A = torch.cat([r1, r2], dim=-2)                       # [..., N, 4, 4]
    B = A[..., :3]
    c = A[..., 3]
    BtB = torch.einsum("...ki,...kj->...ij", B, B)
    Btc = torch.einsum("...ki,...k->...i", B, c)
    return -_solve_sym3(BtB, Btc)


def depths_in_two_views(pts1: torch.Tensor, T_2_1: torch.Tensor):
    """z in camera 1 and camera 2 for frame-1 points."""
    return pts1[..., 2], lie.transform_points(T_2_1, pts1)[..., 2]


def _sampson_residuals(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar error [..., N]; R, t may
    carry leading batch dims."""
    E = lie.hat(t) @ R
    h1, h2 = _homog(x1), _homog(x2)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    r = torch.sum(h2 * Ex1, dim=-1)
    denom = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
                       + Etx2[..., 1] ** 2 + _EPS)
    return r / denom


def refine_pose_sampson(
    R0: torch.Tensor, t0: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
    valid: torch.Tensor, *, iterations: int = 10, huber_delta: float = 2e-3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt on the 5-DoF essential manifold (so(3) x the
    tangent of the translation sphere) under a redescending Huber weight on
    the Sampson error. R0 [B,3,3], t0 [B,3]: B candidates refined at once
    (``torch.func.vmap``; the Jacobian is ``torch.func.jacfwd``)."""
    w_valid = valid.to(x1.dtype)
    cutoff = 5.0 * huber_delta
    dev, dt = x1.device, x1.dtype
    ex = device_const([1.0, 0.0, 0.0], dev, dt)
    ey = device_const([0.0, 1.0, 0.0], dev, dt)
    eye5 = torch.eye(5, dtype=dt, device=dev)

    def tangent_basis(t):
        a = torch.where(torch.abs(t[0]) < 0.9, ex, ey)
        b1 = torch.linalg.cross(t, a)
        b1 = b1 / (torch.linalg.norm(b1) + _EPS)
        b2 = torch.linalg.cross(t, b1)
        return torch.stack([b1, b2], dim=-1)

    def residuals(params, R, t, B):
        # [1,3], not [3]: forward-mode AD of a 0-d tensor divided by a
        # Python float yields a float64 tangent in this PyTorch
        Rp = lie.so3_exp(params[None, :3])[0] @ R
        tp = t + B @ params[3:]
        tp = tp / (torch.linalg.norm(tp) + _EPS)
        return _sampson_residuals(Rp, tp, x1, x2)

    def irls_w(r):
        absr = torch.abs(r)
        w = torch.where(absr <= huber_delta, torch.ones_like(r), huber_delta / (absr + _EPS))
        return torch.where(absr > cutoff, torch.zeros_like(r), w)

    def robust_cost(r):
        absr = torch.abs(r)
        c = torch.where(absr <= huber_delta, r * r, huber_delta * (2.0 * absr - huber_delta))
        cap = huber_delta * (2.0 * cutoff - huber_delta)
        return torch.sum(w_valid * torch.where(absr > cutoff, torch.full_like(c, cap), c))

    jac = torch.func.jacfwd(residuals)

    def step(R, t, lam):
        B = tangent_basis(t)
        p0 = torch.zeros(5, dtype=dt, device=dev)
        r = residuals(p0, R, t, B)
        J = jac(p0, R, t, B)
        w = w_valid * irls_w(r)
        H = J.T @ (J * w[:, None])
        g = J.T @ (r * w)
        # unchecked: the checked solve reads LAPACK's info back
        delta = -torch.linalg.solve_ex(H + lam * eye5, g).result
        R_new = lie.so3_exp(delta[:3]) @ R
        t_new = t + B @ delta[3:]
        t_new = t_new / (torch.linalg.norm(t_new) + _EPS)
        accept = robust_cost(_sampson_residuals(R_new, t_new, x1, x2)) < robust_cost(r)
        return (torch.where(accept, R_new, R), torch.where(accept, t_new, t),
                torch.where(accept, lam * 0.3, lam * 5.0))

    vstep = torch.func.vmap(step)
    R, t = R0, t0
    lam = torch.full((R0.shape[0],), 1e-4, dtype=dt, device=dev)
    for _ in range(iterations):
        R, t, lam = vstep(R, t, lam)
    return R, t


def recover_pose_from_E(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                        inliers: torch.Tensor):
    """Decompose E into 4 (R, t) candidates and pick by cheirality vote
    over the inliers; t unit-normalized. Returns (R, t, n_good)."""
    U, _, Vt = lie.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = device_const([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.device, E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / (torch.linalg.norm(t) + _EPS)
    cand_R = torch.stack([R1, R1, R2, R2])
    cand_t = torch.stack([t, -t, t, -t])
    Ts = lie.rt_to_T(cand_R, cand_t)
    pts1 = triangulate(x1, x2, Ts)
    z1, z2 = depths_in_two_views(pts1, Ts)
    votes = torch.sum((z1 > 0) & (z2 > 0) & inliers, dim=-1)
    best = torch.argmax(votes)
    return take(cand_R, best), take(cand_t, best), take(votes, best)


# ---------------------------------------------------------------------------
# homography
# ---------------------------------------------------------------------------


def _h_rows(p1n, p2n, w=None):
    u1, v1 = p1n[..., 0], p1n[..., 1]
    u2, v2 = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    if w is not None:
        r1, r2 = r1 * w[..., None], r2 * w[..., None]
    return torch.cat([r1, r2], dim=-2)


def _h_from_null(h, T1, T2):
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.inv_ex(T2).inverse @ Hn @ T1
    return H / (H[..., 2:3, 2:3] + _EPS)


def _four_point_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT homography (pixels), p2 ~ H p1."""
    p1n, T1 = hartley_normalize(p1)
    p2n, T2 = hartley_normalize(p2)
    return _h_from_null(nullspace(_h_rows(p1n, p2n)), T1, T2)


def _weighted_h(p1, p2, w):
    p1n, T1 = hartley_normalize(p1, w > 0)
    p2n, T2 = hartley_normalize(p2, w > 0)
    return _h_from_null(nullspace(_h_rows(p1n, p2n, w)), T1, T2)


def _sym_transfer_dist2(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Max of forward/backward squared transfer errors, [..., N]."""
    Hinv = torch.linalg.inv_ex(H).inverse

    def transfer(M, p):
        q = torch.einsum("...ij,nj->...ni", M, _homog(p))
        return q[..., :2] / (q[..., 2:3] + _signed_eps(q[..., 2:3]))

    e12 = torch.sum((transfer(H, p1) - p2) ** 2, dim=-1)
    e21 = torch.sum((transfer(Hinv, p2) - p1) ** 2, dim=-1)
    return torch.maximum(e12, e21)


def estimate_homography(
    p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor, key: int | None,
    *, threshold_px: float = 3.0, n_hypotheses: int = 512,
    idx: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
) -> RansacModel:
    """RANSAC homography from pixel correspondences, MSAC + consensus refit.
    ``idx`` overrides the 4-point draws, ``u`` [n_hypotheses, N] are their
    uniforms (see ``ransac.sample_minimal_sets``)."""
    cap = float(np.float32(threshold_px) * np.float32(threshold_px))
    if idx is None:
        idx = sample_minimal_sets(key, valid, n_hypotheses, 4, u)
    Hs = _four_point_h(p1[idx], p2[idx])

    def msac(H):
        d2 = _sym_transfer_dist2(H, p1, p2)
        return torch.sum(torch.where(valid, torch.clamp(d2, max=cap),
                                     torch.zeros_like(d2)), dim=-1), d2

    H_best = _consensus_refit(p1, p2, valid, Hs, msac,
                              lambda w: _weighted_h(p1, p2, w), 4, cap)
    inl_best = (_sym_transfer_dist2(H_best, p1, p2) < cap) & valid
    return RansacModel(H_best, inl_best, torch.sum(inl_best))


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras-Lustman decomposition into 4 (R, t, n), t unit-normalized.
    Returns (Rs [4,3,3], ts [4,3], ns [4,3], valid4 [4] bool)."""
    Kinv = torch.linalg.inv_ex(K).inverse
    Hn = Kinv @ H @ K
    U, s, Vt = lie.svd(Hn)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    distinct = (d1 / (d2 + _EPS) - 1.0 > 1e-4) | (1.0 - d3 / (d2 + _EPS) > 1e-4)
    den = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    x1_sq = (d1 * d1 - d2 * d2) / den
    x3_sq = (d2 * d2 - d3 * d3) / den
    x1 = torch.sqrt(torch.clamp(x1_sq, 0.0, 1.0))
    x3 = torch.sqrt(torch.clamp(x3_sq, 0.0, 1.0))
    d2c = torch.clamp(d2, min=_EPS)
    sin_t = (d1 - d3) * x1 * x3 / d2c
    cos_t = (d1 * x3_sq + d3 * x1_sq) / d2c
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                              torch.stack([zero, one, zero]),
                              torch.stack([st, zero, cos_t])])
            npp = torch.stack([e1 * x1, zero, e3 * x3])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            R = detUV * (U @ Rp @ Vt)
            t = U @ tp
            t = t / (torch.linalg.norm(t) + _EPS)
            Rs.append(R)
            ts.append(t)
            ns.append(Vt.T @ npp)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ns), distinct.expand(4)


def homography_visible_filter(ns: torch.Tensor, x1: torch.Tensor,
                              inliers: torch.Tensor) -> torch.Tensor:
    """A solution is plausible if > 90% of inliers see the plane's visible
    side (n . [x, y, 1] > 0). Returns [4] bool."""
    dots = torch.einsum("kj,nj->kn", ns, _homog(x1))
    n_in = torch.clamp(torch.sum(inliers), min=1)
    frac_pos = torch.sum((dots > 0) & inliers[None, :], dim=-1) / n_in
    return frac_pos > 0.9


def epipolar_residuals(x1: torch.Tensor, x2: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Algebraic epipolar error y2^T [t]x R y1 per correspondence."""
    E = lie.hat(t) @ R
    return torch.einsum("ni,ij,nj->n", _homog(x2), E, _homog(x1))
