"""Small constant tensors, copied to their device once.

A tensor built from host data inside a step is a copy from pageable host
memory, which waits on the card's stream (and, under ``torch.func.vmap``,
is still one copy per call). The step's constants are therefore made once
per value, dtype and device and cached; a cached tensor is never written to.
The cache is unbounded (the step has a few dozen constants): a captured
program (``models/capture.py``) reads its constants by address, so none may
ever be evicted and freed.

For the same reason a 0-d index tensor never indexes a tensor here (PyTorch
reads it back as an integer): :func:`take` selects with it on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, shape: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor ``i``, without reading it back."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def device_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (nested numbers or an array) as a tensor on ``device``; the
    same tensor on every call with the same values, dtype and device."""
    a = np.asarray(values)
    return _cached(tuple(a.reshape(-1).tolist()), a.shape, dtype, str(torch.device(device)))
