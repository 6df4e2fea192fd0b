"""Trajectory and dataset I/O in the reference's formats.

Copy of ``monocular_visual_odometry_tpu.utils.io``:

- image path generation with the ``rgb_%05d.png`` printf pattern
- trajectory files with 12 numbers per row: tx, ty, tz, then the three
  *columns* of R
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

import numpy as np


def image_paths(dataset_dir: str | Path, num_images: int,
                pattern: str = "rgb_{:05d}.png", start: int = 0) -> List[str]:
    """The frame file names of a dataset directory."""
    d = Path(dataset_dir)
    return [str(d / pattern.format(i)) for i in range(start, start + num_images)]


def pose_to_row(T: np.ndarray) -> np.ndarray:
    """4x4 pose -> the reference's 12-number row:
    [T03, T13, T23, T00, T10, T20, T01, T11, T21, T02, T12, T22]."""
    T = np.asarray(T)
    return np.concatenate([T[:3, 3], T[:3, 0], T[:3, 1], T[:3, 2]])


def row_to_pose(row: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pose_to_row`."""
    row = np.asarray(row, dtype=np.float64)
    T = np.eye(4)
    T[:3, 3] = row[0:3]
    T[:3, 0] = row[3:6]
    T[:3, 1] = row[6:9]
    T[:3, 2] = row[9:12]
    return T


def write_trajectory(path: str | Path, poses: np.ndarray) -> None:
    """Write [N,4,4] poses to the 12-number-per-row text format."""
    poses = np.asarray(poses)
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    rows = np.stack([pose_to_row(T) for T in poses]) if len(poses) else np.zeros((0, 12))
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")


def read_trajectory(path: str | Path) -> np.ndarray:
    """Read a 12-number-per-row trajectory -> [N,4,4]. Any
    whitespace-separated stream of 12*N numbers is accepted."""
    tokens = Path(path).read_text().split()
    vals = np.array([float(t) for t in tokens], dtype=np.float64)
    if vals.size % 12 != 0:
        raise ValueError(f"{path}: expected multiple of 12 numbers, got {vals.size}")
    rows = vals.reshape(-1, 12)
    return np.stack([row_to_pose(r) for r in rows]) if len(rows) else np.zeros((0, 4, 4))
