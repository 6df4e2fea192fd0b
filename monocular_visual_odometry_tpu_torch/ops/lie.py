"""SE(3)/SO(3) Lie-group operations in PyTorch.

Port of ``monocular_visual_odometry_tpu.ops.lie``: the same conventions
(``T_w_c`` maps camera-frame points to the world; se(3) twists are
``[rho, phi]``), the same Taylor fallbacks near the identity, batched over
leading dimensions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import consts
from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)

_EPS = 1e-8


def _eye3(ref: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of a 3-vector (batched)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix (batched)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`so3_exp` (OpenCV naming)."""
    return so3_exp(rvec)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector (batched); the axis sign is
    arbitrary at exactly pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(sin_t == 0, torch.ones_like(sin_t), sin_t))
    log_generic = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    sym = (R + R.transpose(-1, -2)) * 0.5
    one = torch.ones_like(axis_abs[..., 0])
    sx = one
    sy = torch.where(sym[..., 0, 1] >= 0, one, -one)
    sz = torch.where(sym[..., 0, 2] >= 0, one, -one)
    x_tiny = axis_abs[..., 0] < 1e-3
    sz = torch.where(x_tiny, torch.where(sym[..., 1, 2] >= 0, one, -one), sz)
    axis = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    log_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], log_pi, log_generic)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    sin_h = torch.sin(half)
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(sin_h == 0, torch.ones_like(sin_h), sin_h))
        / (theta2 + _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi, W.shape) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] -> 4x4 transform (batched)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return rt_to_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> se(3) twist [rho, phi] (batched)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Vinv = _so3_left_jacobian_inv(phi)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into a 4x4 T (batched)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] from fills: a tensor built from host data would be copied
    # over and synchronise the stream
    bottom = torch.cat([torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device),
                        torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def T_to_rt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def T_to_rt34(T: torch.Tensor) -> torch.Tensor:
    """4x4 -> 3x4 [R|t]."""
    return T[..., :3, :]


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R, t = T_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply T (..., 4, 4) to points (..., N, 3)."""
    R, t = T_to_rt(T)
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def relative_T(T_w_a: torch.Tensor, T_w_b: torch.Tensor) -> torch.Tensor:
    """T_a_b = T_w_a^-1 @ T_w_b."""
    return inv_T(T_w_a) @ T_w_b


def card_route(t: torch.Tensor) -> bool:
    """Whether a factorization of ``t`` takes the card's wait-free form
    (:func:`svd`, :func:`eigh` and their callers choose by it): on a CUDA
    tensor. LAPACK's routes stay on the CPU, so no CPU result changes."""
    return t.is_cuda


_JACOBI_SWEEPS = 4


def svd3_jacobi(M: torch.Tensor):
    """SVD of 3x3 matrices [..., 3, 3] by one-sided (Hestenes) Jacobi:
    ``_JACOBI_SWEEPS`` sweeps of the three plane rotations that orthogonalize
    a pair of columns of M, accumulated into V; the singular values are the
    column norms of M V, in descending order. Tensor ops only, so nothing
    is read back. U's third column is u1 x u2, signed as M V's third column:
    U is orthonormal however small the third singular value. Returns
    (U, S, Vt) as ``torch.linalg.svd``; the signs of paired singular vectors
    may differ from LAPACK's."""
    # columns of M over columns of V: one rotation updates both
    cols = list(torch.cat([M, _eye3(M, M.shape)], dim=-2).unbind(-1))   # 3 x [..., 6]
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = cols[p], cols[q]
            alpha = torch.sum(ap[..., :3] * ap[..., :3], dim=-1)
            beta = torch.sum(aq[..., :3] * aq[..., :3], dim=-1)
            gamma = torch.sum(ap[..., :3] * aq[..., :3], dim=-1)
            tau = beta - alpha
            # tan of the angle that zeroes the pair's inner product (the
            # smaller root); 0 when the pair is already orthogonal
            t = (2.0 * gamma * torch.where(tau >= 0, 1.0, -1.0)
                 / (torch.abs(tau) + torch.sqrt(tau * tau + 4.0 * gamma * gamma) + 1e-30))
            c = torch.rsqrt(1.0 + t * t)[..., None]
            s = c * t[..., None]
            cols[p], cols[q] = c * ap - s * aq, s * ap + c * aq
    AV = torch.stack(cols, dim=-1)                                         # [..., 6, 3]
    S = torch.linalg.vector_norm(AV[..., :3, :], dim=-2)
    order = torch.argsort(S, dim=-1, descending=True)
    S = torch.gather(S, -1, order)
    AV = torch.gather(AV, -1, order[..., None, :].expand(AV.shape))
    A, V = AV[..., :3, :], AV[..., 3:, :]
    # a zero column gets a unit vector: e_x for u1, for u2 one orthogonal to u1
    e = _eye3(M, M.shape)
    u1 = torch.where(S[..., 0, None] > 0, A[..., 0] / S[..., 0, None], e[..., 0])
    w = A[..., 1] - torch.sum(A[..., 1] * u1, dim=-1, keepdim=True) * u1
    fb = torch.linalg.cross(u1, torch.where(torch.abs(u1[..., :1]) < 0.9, e[..., 0], e[..., 1]))
    n, n_fb = (torch.linalg.vector_norm(v, dim=-1, keepdim=True) for v in (w, fb))
    u2 = torch.where(n > 1e-30, w / n, fb / n_fb)
    u3 = torch.linalg.cross(u1, u2)
    u3 = u3 * torch.where(torch.sum(u3 * A[..., 2], dim=-1, keepdim=True) >= 0, 1.0, -1.0)
    return torch.stack([u1, u2, u3], dim=-1), S, V.transpose(-1, -2)


def svd(M: torch.Tensor):
    """``torch.linalg.svd`` that, like ``jnp.linalg.svd``, turns a matrix
    with non-finite entries into NaN factors instead of raising. On a card a
    3x3 is factored by :func:`svd3_jacobi`: ``torch.linalg.svd`` reads its
    ``info`` back there (a wait on the stream) and has no ``_ex`` form."""
    ok = torch.isfinite(M).flatten(-2).all(-1)[..., None, None]
    M0 = torch.where(ok, M, torch.zeros_like(M))
    U, S, Vt = (svd3_jacobi(M0) if card_route(M) and M.shape[-2:] == (3, 3)
                else torch.linalg.svd(M0))
    nan = torch.full((), float("nan"), dtype=M.dtype, device=M.device)
    return (torch.where(ok, U, nan), torch.where(ok[..., 0], S, nan),
            torch.where(ok, Vt, nan))


# sweeps of eigh_jacobi by dtype: from 9x9 and 10x10 tests (rank-5 Gram
# matrices, clustered spectra), where float32 reaches its rounding in 6 and
# float64 in 10
_EIGH_SWEEPS = {torch.float32: 7, torch.float64: 10}


@functools.lru_cache(maxsize=None)
def _round_robin(n: int):
    """The cyclic-by-rounds (tournament) order of the pairs of ``n`` slots,
    padded to an even m: m - 1 rounds of m / 2 disjoint pairs, every pair
    once per sweep. Returns numpy int64 arrays (p, q) [m - 1, m / 2], p < q;
    slot n (odd n) is the padding slot."""
    m = n + n % 2
    ring = list(range(1, m))
    p, q = [], []
    for _ in range(m - 1):
        order = [0] + ring
        pairs = [tuple(sorted((order[i], order[m - 1 - i]))) for i in range(m // 2)]
        p.append([a for a, _ in pairs])
        q.append([b for _, b in pairs])
        ring = ring[-1:] + ring[:-1]
    return np.asarray(p, np.int64), np.asarray(q, np.int64)


def eigh_jacobi(M: torch.Tensor):
    """Eigen-decomposition of symmetric float32 or float64 matrices
    [..., n, n] by cyclic two-sided Jacobi: a fixed number of sweeps
    (``_EIGH_SWEEPS``), each of m - 1 rounds of the
    m / 2 disjoint plane rotations of a tournament order (:func:`_round_robin`;
    m = n rounded up to even, the padding slot of an odd n a zero row and
    column, which no rotation moves), applied at once as one orthogonal J:
    A <- J' A J, V <- V J. Tensor ops only, a fixed count of them, so
    nothing is read back. Returns (eigenvalues ascending [..., n],
    eigenvectors [..., n, n] as columns in the same order), as
    ``torch.linalg.eigh``; the signs of the vectors, and the basis of a
    repeated eigenvalue's space, may differ from LAPACK's."""
    n = M.shape[-1]
    m = n + n % 2
    batch = M.shape[:-2]
    A = M if m == n else torch.nn.functional.pad(M, (0, 1, 0, 1))
    V = torch.eye(m, dtype=M.dtype, device=M.device).expand(batch + (m, m))
    P, Q = _round_robin(n)
    dev = str(M.device)
    # per round: the flat positions of (p,p), (q,q), (p,q), and where c, c,
    # s, -s go in J
    read = [consts.device_const(np.concatenate([p * m + p, q * m + q, p * m + q]), dev,
                                torch.int64) for p, q in zip(P, Q)]
    write = [consts.device_const(np.concatenate([p * m + p, q * m + q, p * m + q, q * m + p]),
                                 dev, torch.int64) for p, q in zip(P, Q)]
    k = m // 2
    for _ in range(_EIGH_SWEEPS[M.dtype]):
        for r in range(m - 1):
            a = A.flatten(-2).index_select(-1, read[r])
            app, aqq, apq = a[..., :k], a[..., k:2 * k], a[..., 2 * k:]
            d, apq2 = aqq - app, 2.0 * apq
            # tan of the angle that zeroes a_pq (the smaller root, |angle| <=
            # pi/4); 0 where a_pq is 0, the padding slot's pairs included
            t = apq2 / (d + torch.copysign(torch.hypot(d, apq2) + 1e-30, d))
            c = torch.rsqrt(torch.addcmul(torch.ones_like(t), t, t))
            s = c * t
            J = torch.zeros(batch + (m * m,), dtype=M.dtype, device=M.device).index_copy(
                -1, write[r], torch.cat([c, c, s, -s], dim=-1)).unflatten(-1, (m, m))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)[..., :n]
    order = torch.argsort(w, dim=-1)
    return (torch.gather(w, -1, order),
            torch.gather(V[..., :n, :n], -1, order[..., None, :].expand(batch + (n, n))))


def eigh(M: torch.Tensor):
    """``torch.linalg.eigh`` (eigenvalues ascending, eigenvectors as
    columns) that turns a matrix with non-finite entries into NaN factors,
    as ``jnp.linalg.eigh`` does. On a card the factorization is
    :func:`eigh_jacobi`: ``torch.linalg.eigh`` reads its ``info`` back there
    (a wait on the stream); the CPU keeps LAPACK."""
    ok = torch.isfinite(M).flatten(-2).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    M0 = torch.where(ok[..., None, None], M, eye)
    w, V = eigh_jacobi(M0) if card_route(M) else torch.linalg.eigh(M0)
    nan = torch.full((), float("nan"), dtype=M.dtype, device=M.device)
    return torch.where(ok[..., None], w, nan), torch.where(ok[..., None, None], V, nan)


def project_onto_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (det +1) via SVD."""
    U, _, Vt = svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def angle_between(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two vectors (batched)."""
    num = torch.sum(v1 * v2, dim=-1)
    den = torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)
    return torch.arccos(torch.clamp(num / (den + _EPS), -1.0, 1.0))


def pose_distance(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Translation distance between two poses (keyframe / jump metric)."""
    return torch.linalg.norm(T_a[..., :3, 3] - T_b[..., :3, 3], dim=-1)
