"""Batched-hypothesis RANSAC primitives.

Port of ``monocular_visual_odometry_tpu.ops.ransac``. Randomness comes from
explicit integer keys: :func:`split_key` derives independent child keys
(splitmix64) the way ``jax.random.split`` is used by the reference, and
:func:`sample_minimal_sets` draws from a ``torch.Generator`` seeded with a
key. The draws differ from JAX's; every entry point above this module
therefore also accepts explicit sample indices (``idx=``) so a test can
hand both packages the same minimal sets.
"""

from __future__ import annotations

import torch

from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def split_key(key: int, n: int = 2) -> list[int]:
    """``n`` child keys of ``key`` (non-negative 63-bit ints)."""
    return [_splitmix64(key * 1_000_003 + i + 1) >> 1 for i in range(n)]


def sample_minimal_sets(key: int, valid: torch.Tensor, n_hypotheses: int,
                        sample_size: int) -> torch.Tensor:
    """``n_hypotheses`` index sets of ``sample_size`` distinct valid entries
    (random-key top-k, the Gumbel-top-k of the reference). With fewer valid
    entries than ``sample_size`` invalid indices appear; their degenerate
    solves score out downstream. Returns [B, sample_size] int64."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(key)
    u = torch.rand((n_hypotheses, valid.shape[0]), generator=gen, device=valid.device)
    u = torch.where(valid[None, :], u, torch.full_like(u, -1.0))
    return torch.topk(u, sample_size, dim=-1).indices


def nullspace_via_eigh(A: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of A (..., M, D) via eigh(A'A)."""
    AtA = torch.einsum("...md,...me->...de", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def nullspace(A: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Smallest right-singular vector of A (..., M, D) by block-2 inverse
    iteration on the ridged Gram matrix plus a 2x2 Rayleigh-Ritz step
    (see the JAX module for why block-2 and why B = (AV)'(AV))."""
    AtA = torch.einsum("...md,...me->...de", A, A)
    d = AtA.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    M = AtA + (1e-6 / d) * torch.clamp(tr, min=1e-30) * eye
    L = torch.linalg.cholesky_ex(M).L  # no error check: NaN propagates as in JAX
    v0 = torch.ones(AtA.shape[:-2] + (d,), dtype=A.dtype, device=A.device)
    alt = torch.tensor([1.0, -1.0], dtype=A.dtype, device=A.device).repeat((d + 1) // 2)[:d]
    v1 = alt.expand(AtA.shape[:-2] + (d,))
    V = torch.stack([v0, v1], dim=-1)
    for _ in range(iters):
        Y = torch.linalg.solve_triangular(L, V, upper=False)
        V = torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)
        c0 = V[..., 0]
        c0 = c0 / (torch.linalg.norm(c0, dim=-1, keepdim=True) + 1e-30)
        c1 = V[..., 1]
        c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
        c1 = c1 / (torch.linalg.norm(c1, dim=-1, keepdim=True) + 1e-30)
        V = torch.stack([c0, c1], dim=-1)
    AV = torch.einsum("...md,...dk->...mk", A, V)
    B = torch.einsum("...mk,...ml->...kl", AV, AV)
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 1, 1]
    half_diff = 0.5 * (a - c)
    rad = torch.sqrt(half_diff * half_diff + b * b)
    lam_min = 0.5 * (a + c) - rad
    w1 = torch.stack([b, lam_min - a], dim=-1)
    w2 = torch.stack([lam_min - c, b], dim=-1)
    use1 = torch.abs(lam_min - a) > torch.abs(lam_min - c)
    w = torch.where(use1[..., None], w1, w2)
    degenerate = torch.linalg.norm(w, dim=-1) < 1e-12
    e0 = torch.tensor([1.0, 0.0], dtype=A.dtype, device=A.device)
    e1 = torch.tensor([0.0, 1.0], dtype=A.dtype, device=A.device)
    w_fallback = torch.where((a <= c)[..., None], e0, e1)
    w = torch.where(degenerate[..., None], w_fallback, w)
    w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-30)
    v = torch.einsum("...dk,...k->...d", V, w)
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30)


def hartley_normalize(pts: torch.Tensor, valid: torch.Tensor | None = None):
    """Similarity-normalize 2-D points to zero mean / sqrt(2) RMS distance.
    pts: [..., N, 2]. Returns (pts_norm, T_3x3) with x_norm = T @ x_homog."""
    if valid is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    rms = torch.sqrt(torch.sum(centered**2, dim=(-1, -2)) / n.squeeze(-1) + 1e-12)
    s = 1.4142135623730951 / torch.clamp(rms, min=1e-8)
    pts_n = (pts - mean) * s[..., None, None]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    mx = mean.squeeze(-2)
    T = torch.stack([
        torch.stack([s, zeros, -s * mx[..., 0]], dim=-1),
        torch.stack([zeros, s, -s * mx[..., 1]], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return pts_n, T
