"""The matcher's operations and bytes, and the peaks of the card they are
held against.

Peaks: NVIDIA H100 SXM5 (132 SMs, 1,980 MHz boost clock), compute
capability 9.0 instruction throughput per SM per clock (CUDA C++
Programming Guide: 16 population counts, 64 32-bit logic operations),
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. They assume
the card's full 700 W; the run prints the card's power limit beside them.
"""

from __future__ import annotations

import torch

SMS, CLOCK_HZ = 132, 1.98e9
POPC_PER_S = SMS * 16 * CLOCK_HZ
LOGIC_PER_S = SMS * 64 * CLOCK_HZ
FP32_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def matcher_bound_ms(uv1: torch.Tensor, uv1_alt, valid1: torch.Tensor, uv2: torch.Tensor,
                     valid2: torch.Tensor, radius: float) -> float:
    """The least time of one radius-gated top-2 Hamming match of K1 queries
    at ``uv1`` (and ``uv1_alt``, the union gate) against K2 keypoints: each
    input byte read once and each output written once (32-byte descriptors,
    float32 positions, a validity byte; best, second and index out, 4 bytes
    each), or the operations, whichever is longer: for every pair, the gate
    (2 subtractions, 2 products, a sum and a compare per query position);
    for every pair the gate lets through, 8 XORs and 8 population counts of
    32 bits."""
    k1, k2 = uv1.shape[0], uv2.shape[0]
    pos = [uv1] if uv1_alt is None else [uv1, uv1_alt]
    nbytes = k1 * (32 + 8 * len(pos) + 1) + k2 * (32 + 8 + 1) + k1 * 12
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    near = torch.zeros((k1, k2), dtype=torch.bool, device=uv1.device)
    for p in pos:
        d = p[:, None, :].double() - uv2[None, :, :].double()
        near |= (d ** 2).sum(-1) <= float(r2)
    pairs = int((near & valid1[:, None] & valid2[None, :]).sum())
    ops_s = pairs * 8 / POPC_PER_S + pairs * 8 / LOGIC_PER_S + k1 * k2 * 6 * len(pos) / FP32_PER_S
    return 1e3 * max(ops_s, nbytes / HBM_BYTES_PER_S)
