"""Radius-gated Hamming nearest-neighbour matcher: CUDA kernel and its
plain PyTorch version.

Counterpart of ``monocular_visual_odometry_tpu/ops/pallas/hamming.py``.
:func:`hamming_nn_top2` takes the packed ``[K,32]`` uint8 descriptors (the
TPU kernel's +/-1 unpack existed only to reach the matrix unit). On a CUDA
tensor it launches ``csrc/hamming_nn_top2.cu`` or raises; on a CPU tensor
it runs :func:`hamming_nn_top2_reference`. There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops.cuda import build

_BIG = 1e9
_lib = None


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[K,32] uint8 packed -> [K,256] int8 in {-1,+1} (bit=1 -> +1)."""
    shifts = torch.arange(8, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[:, :, None] >> shifts[None, None, :]) & 1
    return (bits.reshape(desc.shape[0], 256) * 2 - 1).to(torch.int8)


def _radius2(r: float) -> float:
    """r*r rounded as one fp32 product, as the JAX kernel computes it."""
    return float(np.float32(r) * np.float32(r))


def hamming_matrix(desc1, desc2, valid1, valid2) -> torch.Tensor:
    """All-pairs Hamming distances [K1,K2] float32, 1e9 on invalid rows/cols,
    as an fp32 +/-1 product (exact: integers of at most 256)."""
    a = unpack_pm1(desc1).to(torch.float32)
    b = unpack_pm1(desc2).to(torch.float32)
    d = (256.0 - a @ b.T) * 0.5
    return torch.where(valid1[:, None] & valid2[None, :], d, torch.full_like(d, _BIG))


def pixel_dist2_matrix(kpts1, kpts2) -> torch.Tensor:
    """All-pairs squared pixel distances, [K1,K2] float32."""
    diff = kpts1[:, None, :] - kpts2[None, :, :]
    return diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]


def top2_min(d: torch.Tensor):
    """(best, second, first-index argmin) along the last axis; ``second``
    is the min with the argmin column masked, so it counts a duplicate."""
    best = torch.min(d, dim=-1).values
    idx = torch.argmin(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.min(torch.where(cols == idx[..., None], torch.full_like(d, _BIG), d),
                       dim=-1).values
    return best, second, idx.to(torch.int32)


def hamming_nn_top2_reference(desc1, uv1, valid1, desc2, uv2, valid2, r,
                              uv1_alt=None):
    """Plain PyTorch version, the JAX package's XLA route
    (``ops/matching.py``: the full distance matrix, the radius gate, then
    three reductions)."""
    d = hamming_matrix(desc1, desc2, valid1, valid2)
    p2 = pixel_dist2_matrix(uv1, uv2)
    if uv1_alt is not None:
        p2 = torch.minimum(p2, pixel_dist2_matrix(uv1_alt, uv2))
    return top2_min(torch.where(p2 <= _radius2(r), d, torch.full_like(d, _BIG)))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("hamming_nn_top2")
        fn = lib.hamming_nn_top2_launch
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_int, P, P, P, ctypes.c_int,
                       ctypes.c_float, P, P, P, P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def hamming_nn_top2(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt=None):
    """Per-query nearest + second-nearest Hamming match with a radius gate.

    desc*: [K,32] uint8 packed; uv*: [K,2] float32; valid*: [K] bool; ``r``
    a Python float; ``uv1_alt`` an optional second query position (the gate
    accepts the union of both). Returns (best [K1] f32, second [K1] f32,
    idx [K1] int32) with 1e9 / index 0 where nothing passes the gate."""
    if desc1.device.type == "cpu":
        return hamming_nn_top2_reference(desc1, uv1, valid1, desc2, uv2, valid2,
                                         r, uv1_alt)
    if desc1.device.type != "cuda":
        raise ValueError(f"hamming_nn_top2: unsupported device {desc1.device}")
    dev = desc1.device
    k1, k2 = desc1.shape[0], desc2.shape[0]
    alt = uv1 if uv1_alt is None else uv1_alt
    for name, t, dt, shape in (("desc1", desc1, torch.uint8, (k1, 32)),
                               ("uv1", uv1, torch.float32, (k1, 2)),
                               ("uv1_alt", alt, torch.float32, (k1, 2)),
                               ("valid1", valid1, torch.bool, (k1,)),
                               ("desc2", desc2, torch.uint8, (k2, 32)),
                               ("uv2", uv2, torch.float32, (k2, 2)),
                               ("valid2", valid2, torch.bool, (k2,))):
        _check(name, t, dt, shape, dev)
    best = torch.empty(k1, dtype=torch.float32, device=dev)
    second = torch.empty(k1, dtype=torch.float32, device=dev)
    idx = torch.empty(k1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().hamming_nn_top2_launch(
        desc1.data_ptr(), uv1.data_ptr(), alt.data_ptr(), valid1.data_ptr(), k1,
        desc2.data_ptr(), uv2.data_ptr(), valid2.data_ptr(), k2,
        _radius2(r), best.data_ptr(), second.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_nn_top2 launch failed: CUDA error {err}")
    hamming_nn_top2.launches += 1
    return best, second, idx


hamming_nn_top2.launches = 0  # kernel launches since the last reset
