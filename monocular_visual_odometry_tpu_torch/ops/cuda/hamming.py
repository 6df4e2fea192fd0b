"""Radius-gated Hamming nearest-neighbour matcher: CUDA kernel and its
plain PyTorch version.

Counterpart of ``monocular_visual_odometry_tpu/ops/pallas/hamming.py``.
:func:`hamming_nn_top2` takes the packed ``[K,32]`` uint8 descriptors (the
TPU kernel's +/-1 unpack existed only to reach the matrix unit). On a CUDA
tensor it launches ``csrc/hamming_nn_top2.cu`` or raises; on a CPU tensor
it runs :func:`hamming_nn_top2_reference`. There is no fallback from one to
the other.

The call goes through the operator ``mvo::hamming_nn_top2``, whose vmap
rule makes ``torch.func.vmap`` (one level) of it a call of
:func:`hamming_nn_top2_batched`: on CUDA one launch for all streams, on the
CPU the plain version per stream. That is how the batched tracking step
(``models/vo.py::step_tracking_batched``) matches B streams at once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.ops.cuda import build

_BIG = 1e9
_lib = None


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[...,32] uint8 packed -> [...,256] int8 in {-1,+1} (bit=1 -> +1)."""
    shifts = torch.arange(8, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., None] >> shifts) & 1
    return (bits.reshape(desc.shape[:-1] + (256,)) * 2 - 1).to(torch.int8)


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
                       ctypes.c_float, P, P, P, ctypes.c_int, P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _pad_train(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` [B,K2,...] with ``n`` zero (invalid) train points appended."""
    return torch.cat([t, torch.zeros((t.shape[0], n) + t.shape[2:], dtype=t.dtype,
                                     device=t.device)], dim=1)


def _launch(desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2, r):
    """One kernel launch over B streams: desc* [B,K,32], uv* [B,K,2],
    valid* [B,K] on one CUDA device. Returns (best, second, idx) [B,K1]."""
    dev = desc1.device
    if dev.type != "cuda":
        raise ValueError(f"hamming_nn_top2: unsupported device {dev}")
    b, k1, k2 = desc1.shape[0], desc1.shape[1], desc2.shape[1]
    if b > 1 and k2 % 16:
        # stream s's train set starts s*K2 points in; its bulk copies need a
        # 16-byte aligned start, so K2 is padded to a multiple of 16 with
        # invalid points (which no query can match)
        pad = -k2 % 16
        desc2, uv2, valid2 = (_pad_train(t, pad) for t in (desc2, uv2, valid2))
        k2 += pad
    alt = uv1 if uv1_alt is None else uv1_alt
    for name, t, dt, shape in (("desc1", desc1, torch.uint8, (b, k1, 32)),
                               ("uv1", uv1, torch.float32, (b, k1, 2)),
                               ("uv1_alt", alt, torch.float32, (b, k1, 2)),
                               ("valid1", valid1, torch.bool, (b, k1)),
                               ("desc2", desc2, torch.uint8, (b, k2, 32)),
                               ("uv2", uv2, torch.float32, (b, k2, 2)),
                               ("valid2", valid2, torch.bool, (b, k2))):
        _check(name, t, dt, shape, dev)
    ptrs = [t.data_ptr() for t in (desc1, uv1, alt, valid1, desc2, uv2, valid2)]
    best = torch.empty((b, k1), dtype=torch.float32, device=dev)
    second = torch.empty((b, k1), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k1), dtype=torch.int32, device=dev)
    err = _library().hamming_nn_top2_launch(
        *ptrs[:4], k1, *ptrs[4:], k2, _radius2(r), best.data_ptr(), second.data_ptr(),
        idx.data_ptr(), b, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hamming_nn_top2 launch failed: CUDA error {err}")
    hamming_nn_top2.launches += 1
    return best, second, idx


def hamming_nn_top2_batched(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt=None):
    """B independent calls of :func:`hamming_nn_top2` in one: every input
    carries a leading [B] (stream b matches its queries against its own
    train set); returns (best, second, idx) [B,K1]. On CUDA tensors one
    kernel launch, on CPU tensors the plain version per stream."""
    if desc1.device.type == "cpu":
        alts = [None] * desc1.shape[0] if uv1_alt is None else uv1_alt
        outs = [hamming_nn_top2_reference(*args, r, uv1_alt=alt) for *args, alt in
                zip(desc1, uv1, valid1, desc2, uv2, valid2, alts)]
        return tuple(torch.stack(o) for o in zip(*outs))
    return _launch(desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2, r)


@torch.library.custom_op("mvo::hamming_nn_top2", mutates_args=())
def _op(desc1: torch.Tensor, uv1: torch.Tensor, uv1_alt: Optional[torch.Tensor],
        valid1: torch.Tensor, desc2: torch.Tensor, uv2: torch.Tensor, valid2: torch.Tensor,
        r: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if desc1.device.type == "cpu":
        return hamming_nn_top2_reference(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt)
    one = lambda t: None if t is None else t[None]
    best, second, idx = _launch(*map(one, (desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2)), r)
    return best[0], second[0], idx[0]


@_op.register_vmap
def _op_vmap(info, in_dims, desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2, r):
    """vmap of the operator: the batch dim to the front (an unbatched input
    is expanded), then one :func:`hamming_nn_top2_batched` call."""
    def front(t, d):
        if t is None:
            return None
        t = t.expand((info.batch_size,) + t.shape) if d is None else t.movedim(d, 0)
        return t.contiguous()
    d1, p1, alt, v1, d2, p2, v2 = map(front, (desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2),
                                      in_dims[:7])
    return hamming_nn_top2_batched(d1, p1, v1, d2, p2, v2, r, uv1_alt=alt), (0, 0, 0)


def hamming_nn_top2(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt=None):
    """Per-query nearest + second-nearest Hamming match with a radius gate.

    desc*: [K,32] uint8 packed; uv*: [K,2] float32; valid*: [K] bool; ``r``
    a Python float; ``uv1_alt`` an optional second query position (the gate
    accepts the union of both). Returns (best [K1] f32, second [K1] f32,
    idx [K1] int32) with 1e9 / index 0 where nothing passes the gate. Under
    ``torch.func.vmap`` the whole batch is one launch."""
    return _op(desc1, uv1, uv1_alt, valid1, desc2, uv2, valid2, float(r))


hamming_nn_top2.launches = 0  # kernel launches since the last reset, batched or not
