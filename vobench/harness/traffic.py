"""What every driver shares: the seed's derived numbers, the rendered
passes, what a window records, and host copies of the program's records.

A traffic file (``traffic/<name>.json``) holds numbers only. Its ``driver``
names the driver module ``drivers/<driver>.py`` that reads it (found by name,
as a metric's reader is), and every other key is that driver's parameter.
The keys the drivers here share:

- ``pass_frames``, ``translation_step``: a pass is that many frames of the
  room scene along ``make_trajectory``; every pass starts from a fresh state
  with a new key (a live session restarts its map; an offline stream starts
  its next recording);
- ``sample``: the frames whose states the output checks keep (drawn from
  the seed, see each driver);
- ``profile``: the bounded slice the traced run profiles.

Each stream's scene comes from the run's seed (:func:`derive`); the path is
the same for every scene, so every seed asks for the same work.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from . import scene


def derive(seed: int, *tags) -> int:
    """A 62-bit integer from the run's seed and ``tags`` (scene seeds and
    RANSAC keys): the same for the same seed on every machine."""
    h = hashlib.sha256(":".join(map(str, (seed,) + tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


class Frames(NamedTuple):
    """The rendered passes: ``frames`` [streams, N, H, W] uint8 on the card,
    ``gt`` [streams, N, 4, 4] (numpy)."""

    frames: torch.Tensor
    gt: np.ndarray


def render(traffic: dict, cam: dict, height: int, width: int, seed: int, device,
           streams: int = 1) -> Frames:
    frames, gt = [], []
    for b in range(streams):
        f, p = scene.sequence(derive(seed, "scene", b), traffic["pass_frames"],
                              traffic["translation_step"], cam, height, width, device)
        frames.append(f)
        gt.append(p)
    return Frames(torch.stack(frames), np.stack(gt))


class Window(NamedTuple):
    """What a window recorded, on the host."""

    seconds: float                 # from the first frame's start to the last one's end
    frames: int                    # frames whose pose came back
    frame_ms: np.ndarray           # live: each add_frame's host time
    passes: list                   # complete passes: (stream, est [N,4,4], stages [N], ok [N])
    samples: list                  # frames kept for the output checks: dicts of
                                   # ``stream``, ``index`` (frame of the pass), ``before``
                                   # and ``after`` (the stream's state, on the host) and
                                   # ``out`` (its StepOutput, on the host)


def draw(seed: int, tag: str, n: int, lo: int, hi: int) -> list:
    """``n`` distinct integers of [lo, hi) drawn from the seed, sorted."""
    rng = np.random.default_rng(derive(seed, tag))
    return sorted(int(v) for v in rng.choice(np.arange(lo, hi), size=min(n, hi - lo),
                                             replace=False))


def to_host(record):
    """A copy of a record (a NamedTuple of tensors, nested) on the host."""
    if record is None:
        return None
    if hasattr(record, "_fields"):
        return type(record)(*(to_host(x) for x in record))
    return record.detach().cpu().clone()


def row(record, b: int):
    """Stream ``b`` of a stacked record."""
    if record is None:
        return None
    if hasattr(record, "_fields"):
        return type(record)(*(row(x, b) for x in record))
    return record[b]
