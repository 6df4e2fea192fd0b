"""Batched five-point minimal essential-matrix solver.

Port of ``monocular_visual_odometry_tpu.ops.fivepoint``. A five-point
sample pins E to a 4-D null space E = x·E1 + y·E2 + z·E3 + E4; the rank and
trace constraints give 10 cubics in (x, y, z), built exactly from two static
monomial-product tables. Grouping the 20 monomials by their (x, y) part
gives a 10×10 matrix M(z) whose determinant vanishes at the real roots in
z, which are bracketed on a fixed tan-grid and bisected; (x, y) come from
the null vector of M(z*), a few Gauss-Newton steps polish (x, y, z), and
each candidate is projected onto the essential manifold.

The null-space basis comes from ``eigh`` of a rank-5 [9,9] Gram matrix,
whose 4-fold near-zero eigenspace has no canonical basis: LAPACK builds
differ in it, so the port's candidates are the JAX package's as a set, not
in order. The basis is remixed by the QR of a Gaussian ``G`` [B,4,4],
drawn from ``key`` or passed in.

On a card (``lie.card_route``) both ``eigh`` calls are ``lie.eigh_jacobi``,
so the solver reads nothing back and can be captured (the QR, the
determinants and the solves do not wait there). Its bases differ from
LAPACK's within the same spaces, so the card's candidates are the CPU's as
a set, too.

Both Gram matrices (the 5x9 epipolar system's and M(z*)'s) are formed and
factored in float64 whatever the input's dtype, and the vectors cast back:
their near-zero eigenspaces are what the solver reads, and in float32 the
rounding there loses roots. Formed and factored in float32, the float32
solver kept 83.6% (LAPACK) and 94.7% (the Jacobi) of the float64 solver's
roots on 640 noisy samples, and the two charts then picked other RANSAC
winners; now each keeps over 95%
(``tests/test_torch_eigh.py::test_float32_solver_keeps_the_float64_roots``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)
from monocular_visual_odometry_tpu_torch.ops.consts import device_const

_EPS = 1e-12

# exponent tuples (i, j, k) for x^i y^j z^k
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]                 # x y z 1
_DEG2 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
         (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]      # 10
_DEG3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
         (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)] + _DEG2  # 20


def _mul_table(out_basis, a_basis, b_basis):
    T = np.zeros((len(out_basis), len(a_basis), len(b_basis)), np.float32)
    lut = {m: i for i, m in enumerate(out_basis)}
    for ia, ma in enumerate(a_basis):
        for ib, mb in enumerate(b_basis):
            T[lut[tuple(x + y for x, y in zip(ma, mb))], ia, ib] = 1.0
    return T


_T2 = _mul_table(_DEG2, _DEG1, _DEG1)   # [10,4,4]
_T3 = _mul_table(_DEG3, _DEG2, _DEG1)   # [20,10,4]

# columns of M(z) over [x³, x²y, xy², y³, x², xy, y², x, y, 1]
_XY_BASIS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
             (1, 0), (0, 1), (0, 0)]
_COL = np.asarray([_XY_BASIS.index((i, j)) for (i, j, _k) in _DEG3], np.int64)
_ZDEG = np.asarray([k for (_i, _j, k) in _DEG3], np.int64)

# d/dp of each monomial of _DEG3: coefficient and exponents, [3,20] and [3,20,3]
_EXP3 = np.asarray(_DEG3, np.float32)                       # [20,3]
_DCOEF = _EXP3.T.copy()                                     # [3,20]
_DEXP = np.maximum(_EXP3[None] - np.eye(3, dtype=np.float32)[:, None, :], 0.0)

_MAX_ROOTS = 8        # brackets kept per hypothesis (<= 10 real roots exist)
_GRID = 129           # theta-grid nodes over (-pi/2, pi/2); z = tan(theta)
_BISECT_ITERS = 40
_THETA = np.linspace(-1.5607, 1.5607, _GRID).astype(np.float32)  # tan(±1.5607) ≈ ±100


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return device_const(a, like.device, like.dtype)


def _finite(M: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(M).flatten(-2).all(-1)


def _det(M: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.det`` that gives NaN for a matrix with non-finite
    entries, as ``jnp.linalg.det`` does."""
    ok = _finite(M)
    d = torch.linalg.det(torch.where(ok[..., None, None], M, torch.zeros_like(M)))
    return torch.where(ok, d, torch.full_like(d, float("nan")))


def _gram_eigvecs(A: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of the Gram matrix A'A of A [..., m, n] (ascending
    eigenvalues), the Gram formed and factored in float64 and the vectors
    returned in A's dtype; NaN for a non-finite A instead of raising. On a
    card ``lie.eigh`` is the wait-free Jacobi."""
    A64 = A.to(torch.float64)
    return lie.eigh(A64.transpose(-1, -2) @ A64)[1].to(A.dtype)


def _constraints(e: torch.Tensor) -> torch.Tensor:
    """10 cubic constraints from the null-space basis. e: [B,3,3,4], each
    entry's coefficients over [x, y, z, 1]. Returns C [B,10,20] over _DEG3."""
    T2, T3 = _const(_T2, e), _const(_T3, e)

    def q(a, b):            # lin × lin -> quad   [B,4],[B,4] -> [B,10]
        return torch.einsum("mab,na,nb->nm", T2, a, b)

    def c(qq, a):           # quad × lin -> cubic [B,10],[B,4] -> [B,20]
        return torch.einsum("mqa,nq,na->nm", T3, qq, a)

    # det(E) = e00·m00 − e01·m01 + e02·m02 (cofactor expansion)
    m00 = q(e[:, 1, 1], e[:, 2, 2]) - q(e[:, 1, 2], e[:, 2, 1])
    m01 = q(e[:, 1, 0], e[:, 2, 2]) - q(e[:, 1, 2], e[:, 2, 0])
    m02 = q(e[:, 1, 0], e[:, 2, 1]) - q(e[:, 1, 1], e[:, 2, 0])
    det = c(m00, e[:, 0, 0]) - c(m01, e[:, 0, 1]) + c(m02, e[:, 0, 2])

    # 2 E Eᵀ E − tr(E Eᵀ) E, entrywise (9 cubics)
    EEt = torch.einsum("mab,nika,njkb->nijm", T2, e, e)          # [B,3,3,10]
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]              # [B,10]
    EEtE = torch.einsum("mqa,nikq,nkja->nijm", T3, EEt, e)       # [B,3,3,20]
    trE = torch.einsum("mqa,nq,nija->nijm", T3, tr, e)           # [B,3,3,20]
    tc = 2.0 * EEtE - trE
    return torch.cat([det[:, None], tc.reshape(-1, 9, 20)], dim=1)


def _m_of_z(Mcoef: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """M(z), scaled to unit max-entry (the determinant's sign is kept; raw
    entries grow like z³). Mcoef: [..., 10, 10, 4]; z: [...]."""
    zp = torch.stack([torch.ones_like(z), z, z * z, z * z * z], dim=-1)
    M = torch.einsum("...ijd,...d->...ij", Mcoef, zp)
    return M / (torch.amax(torch.abs(M), dim=(-2, -1), keepdim=True) + _EPS)


def _mono3(p: torch.Tensor) -> torch.Tensor:
    """The 20 monomials of _DEG3 at p [..., 3] -> [..., 20]."""
    return torch.prod(p[..., None, :] ** _const(_EXP3, p), dim=-1)


def _mono3_jac(p: torch.Tensor) -> torch.Tensor:
    """d mono3 / dp at p [..., 3] -> [..., 20, 3], from the fixed table of
    monomial derivatives (d/dx x^i y^j z^k = i x^(i-1) y^j z^k)."""
    terms = torch.prod(p[..., None, None, :] ** _const(_DEXP, p), dim=-1)   # [...,3,20]
    return (terms * _const(_DCOEF, p)).transpose(-1, -2)


def five_point_essential(x1: torch.Tensor, x2: torch.Tensor, key: int = 0,
                         G: Optional[torch.Tensor] = None):
    """Solve the five-point problem for a batch of minimal samples.

    x1, x2: [B,5,2] normalized-plane correspondences. ``G`` [B,4,4] remixes
    the null-space basis; without it, it is drawn from a generator seeded
    with ``key``. Returns (Es [B,8,3,3] essential-manifold candidates,
    ok [B,8] bool)."""
    B = x1.shape[0]

    # --- 4-D null space of the 5×9 epipolar constraint (x2ᵀ E x1 = 0)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)                  # [B,5,9]
    basis = _gram_eigvecs(A)[..., :4]                              # [B,9,4]

    # random orthonormal remix: the fixed "coefficient of E4 is 1" chart
    # misses solutions orthogonal to E4; a random one makes that measure-zero
    if G is None:
        G = remix_draw(key, B, x1.device, x1.dtype)
    return _candidates(basis @ torch.linalg.qr(G.to(x1.dtype)).Q)


def remix_draw(key: int, n: int, device, dtype=torch.float32) -> torch.Tensor:
    """The Gaussian basis remix [n,4,4] that :func:`five_point_essential`
    draws from ``key`` for ``n`` samples (a generator on ``device`` seeded
    with it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return torch.randn((n, 4, 4), generator=gen, device=device, dtype=dtype)


def _candidates(basis: torch.Tensor):
    """Candidates of :func:`five_point_essential` from the remixed null-space
    basis [B,9,4]."""
    B = basis.shape[0]
    dev, dt = basis.device, basis.dtype
    C = _constraints(basis.reshape(B, 3, 3, 4))                    # [B,10,20]
    # out of place, so that it batches under torch.func.vmap (the general
    # batched step's init)
    Mcoef = torch.zeros((B, 10, 10, 4), dtype=dt, device=dev).index_put(
        (torch.arange(B, device=dev)[:, None, None], torch.arange(10, device=dev)[None, :, None],
         device_const(_COL, dev, torch.int64), device_const(_ZDEG, dev, torch.int64)), C)

    # --- bracket real roots of det M(z) on the tan grid; theta stays
    # float32 at any precision, as in the reference
    theta = device_const(_THETA, dev)

    def det_sign(th):
        return torch.sign(_det(_m_of_z(Mcoef[:, None], torch.tan(th).to(dt))))

    sgn = det_sign(theta.expand(B, _GRID))
    change = sgn[:, :-1] * sgn[:, 1:] < 0                          # [B,G-1]
    # the first MAX_ROOTS brackets per row (stable argsort of ~change)
    order = torch.argsort((~change).to(torch.int32), dim=1, stable=True)[:, :_MAX_ROOTS]
    ok = torch.gather(change, 1, order)                           # [B,R]
    lo, hi = theta[order], theta[order + 1]
    f_lo = torch.gather(sgn[:, :-1], 1, order)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        fm = det_sign(mid)
        same = fm * f_lo >= 0
        lo = torch.where(same, mid, lo)
        f_lo = torch.where(same, fm, f_lo)
        hi = torch.where(same, hi, mid)
    z_root = torch.tan(0.5 * (lo + hi)).to(dt)                    # [B,R]

    # --- (x, y) from the null vector of M(z*)
    M = _m_of_z(Mcoef[:, None], z_root)                           # [B,R,10,10]
    v = _gram_eigvecs(M)[..., :, 0]
    # v ∝ [x³, x²y, xy², y³, x², xy, y², x, y, 1]: (x, y) from the degree
    # pair with the largest denominator (x/1, x²/x or x³/x²)
    dens = torch.stack([v[..., 9], v[..., 7], v[..., 4]], dim=-1)
    nums_x = torch.stack([v[..., 7], v[..., 4], v[..., 0]], dim=-1)
    nums_y = torch.stack([v[..., 8], v[..., 5], v[..., 1]], dim=-1)
    pick = torch.argmax(torch.abs(dens), dim=-1, keepdim=True)
    den = torch.gather(dens, -1, pick)[..., 0]
    den = torch.where(torch.abs(den) < _EPS, torch.full_like(den, _EPS), den)
    x = torch.gather(nums_x, -1, pick)[..., 0] / den
    y = torch.gather(nums_y, -1, pick)[..., 0] / den

    # --- Gauss-Newton polish of (x, y, z) on the 10 cubics r(p) = C·mono3(p)
    p = torch.stack([x, y, z_root], dim=-1)                       # [B,R,3]
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def resid(p):
        return torch.einsum("bmn,brn->brm", C, _mono3(p))

    for _ in range(4):
        r = resid(p)
        J = torch.einsum("bmn,brnd->brmd", C, _mono3_jac(p))      # [B,R,10,3]
        H = J.transpose(-1, -2) @ J + 1e-8 * eye3
        d = -torch.linalg.solve_ex(H, (J.transpose(-1, -2) @ r[..., None]),
                                   check_errors=False).result[..., 0]
        p_new = p + d
        better = torch.sum(resid(p_new) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        p = torch.where(better[..., None], p_new, p)
    x, y, z_root = p[..., 0], p[..., 1], p[..., 2]

    # --- reassemble E and project to the essential manifold
    coef = torch.stack([x, y, z_root, torch.ones_like(x)], dim=-1)   # [B,R,4]
    E = torch.einsum("bnk,brk->brn", basis, coef).reshape(B, _MAX_ROOTS, 3, 3)
    E = E / (torch.sqrt(torch.sum(E * E, dim=(-2, -1), keepdim=True)) + _EPS)
    U, s, Vt = lie.svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    E = (U * torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)[..., None, :]) @ Vt

    ok = ok & torch.isfinite(E).flatten(-2).all(-1) & torch.isfinite(x) & torch.isfinite(y)
    return E, ok
