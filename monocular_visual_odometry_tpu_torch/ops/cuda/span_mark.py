"""The span marker: one timestamp into one slot of a program's slot buffer.

:func:`span_mark` goes through the operator ``mvo::span_mark``. On a CUDA
tensor it launches ``csrc/span_mark.cu`` (one thread writes the card's
``%globaltimer``, in stream order); on a CPU tensor it writes
``time.perf_counter_ns()``, so a CPU run sees the same order. Its vmap rule
marks once for the whole batch: the slots belong to the program, not to a
stream. The library is built and loaded at the first launch, which only
runs while spans are on (``utils/logging.py``).
"""

from __future__ import annotations

import ctypes
import time

import torch

from monocular_visual_odometry_tpu_torch.ops.cuda import build

_lib = None


def library() -> ctypes.CDLL:
    """The marker's library, built and loaded at the first call."""
    global _lib
    if _lib is None:
        lib = build.load("span_mark")
        lib.span_mark_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.span_mark_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


@torch.library.custom_op("mvo::span_mark", mutates_args=("slots",))
def _op(slots: torch.Tensor, index: int) -> None:
    if slots.device.type == "cpu":
        slots[index] = time.perf_counter_ns()
        return
    err = library().span_mark_launch(slots.data_ptr(), index,
                                     torch.cuda.current_stream(slots.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span_mark launch failed: CUDA error {err}")


@_op.register_vmap
def _op_vmap(info, in_dims, slots, index):
    """Under vmap one mark for every stream: the slots are never batched."""
    if in_dims[0] is not None:
        raise ValueError("span_mark: a program's slot buffer has no batch dimension")
    _op(slots, index)
    return None, None


def span_mark(slots: torch.Tensor, index: int) -> None:
    """Write the time now into ``slots[index]`` (``slots``: a contiguous
    int64 buffer; on a card, ns of ``%globaltimer``; on the CPU, ns of
    ``time.perf_counter_ns``), after everything queued before it."""
    if slots.dtype != torch.int64 or not slots.is_contiguous() or not 0 <= index < slots.numel():
        raise ValueError(f"span_mark: slot {index} of a {slots.dtype} buffer of "
                         f"{slots.numel()} (contiguous int64 expected)")
    _op(slots, index)
