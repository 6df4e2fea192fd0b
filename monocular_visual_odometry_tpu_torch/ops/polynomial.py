"""Closed-form real polynomial roots (Cardano / Ferrari), batched.

Port of ``monocular_visual_odometry_tpu.ops.polynomial``: all real
arithmetic with branch selection by ``torch.where``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def cubic_one_real_root(b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One real root of x^3 + b x^2 + c x + d = 0 (batched)."""
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u3 = -q / 2.0 + sq
    v3 = -q / 2.0 - sq
    cbrt = lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
    t_cardano = cbrt(u3) + cbrt(v3)

    pm = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    pmm = pm * m
    arg = torch.clamp(3.0 * q / (pmm + torch.where(pmm == 0, _EPS, 0.0)), -1.0, 1.0)
    t_trig = m * torch.cos(torch.arccos(arg) / 3.0)

    t = torch.where(disc >= 0, t_cardano, t_trig)
    return t - b / 3.0


def quartic_real_roots(a3, a2, a1, a0):
    """All real roots of x^4 + a3 x^3 + a2 x^2 + a1 x + a0 (Ferrari).
    Returns (roots [..., 4], real_mask [..., 4])."""
    e = a3 / 4.0
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3**3 / 8.0
    r = a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0 - 3.0 * a3**4 / 256.0

    z = cubic_one_real_root(2.0 * p, p * p - 4.0 * r, -q * q)
    z = torch.clamp(z, min=0.0)
    w = torch.sqrt(z + _EPS)
    s = q / (2.0 * w)
    c1 = (p + z) / 2.0 - s
    c2 = (p + z) / 2.0 + s

    def quad(root_sign, bq, cq):
        disc = bq * bq / 4.0 - cq
        sqd = torch.sqrt(torch.clamp(disc, min=0.0))
        return -bq / 2.0 + root_sign * sqd, disc >= 0

    y0, ok0 = quad(+1.0, w, c1)
    y1, ok1 = quad(-1.0, w, c1)
    y2, ok2 = quad(+1.0, -w, c2)
    y3, ok3 = quad(-1.0, -w, c2)
    roots = torch.stack([y0, y1, y2, y3], dim=-1) - e[..., None]
    mask = torch.stack([ok0, ok1, ok2, ok3], dim=-1)
    return roots, mask


def polish_quartic_roots(a3, a2, a1, a0, roots, iterations: int = 2):
    """Newton-polish quartic roots."""
    a3, a2, a1, a0 = a3[..., None], a2[..., None], a1[..., None], a0[..., None]
    for _ in range(iterations):
        f = (((roots + a3) * roots + a2) * roots + a1) * roots + a0
        df = ((4.0 * roots + 3.0 * a3) * roots + 2.0 * a2) * roots + a1
        roots = roots - f / torch.where(torch.abs(df) < _EPS, torch.full_like(df, _EPS), df)
    return roots
