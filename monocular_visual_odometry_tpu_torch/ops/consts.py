"""Small constant tensors, copied to their device once.

A tensor built from host data inside a step is a copy from pageable host
memory, which waits on the card's stream (and, under ``torch.func.vmap``,
is still one copy per call). The step's constants are therefore made once
per value, dtype and device and cached; a cached tensor is never written to.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _cached(values: tuple, shape: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (nested numbers or an array) as a tensor on ``device``; the
    same tensor on every call with the same values, dtype and device."""
    a = np.asarray(values)
    return _cached(tuple(a.reshape(-1).tolist()), a.shape, dtype, str(torch.device(device)))
