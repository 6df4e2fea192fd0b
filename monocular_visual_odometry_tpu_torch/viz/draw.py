"""Annotated-frame rendering.

Copy of ``monocular_visual_odometry_tpu.viz.draw``: all keypoints drawn
green, inlier keypoints red, written to the output folder per frame
(through :func:`runtime.write_png`, so no imaging library is needed).
"""

from __future__ import annotations

import numpy as np

from monocular_visual_odometry_tpu_torch.runtime import write_png


def draw_frame(img_gray: np.ndarray, kpts: np.ndarray, kpt_valid: np.ndarray,
               inlier_mask: np.ndarray | None = None,
               out_path: str | None = None) -> np.ndarray:
    """Return an RGB uint8 image with keypoints marked (green) and inliers
    marked (red), optionally saving it."""
    img = np.asarray(img_gray)
    rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
    H, W = img.shape

    def mark(u, v, color):
        x, y = int(round(u)), int(round(v))
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                if abs(dx) + abs(dy) >= 2 and 0 <= y + dy < H and 0 <= x + dx < W:
                    rgb[y + dy, x + dx] = color

    kpts = np.asarray(kpts)
    kpt_valid = np.asarray(kpt_valid)
    inl = np.asarray(inlier_mask) if inlier_mask is not None else np.zeros(len(kpts), bool)
    for i in range(len(kpts)):
        if not kpt_valid[i]:
            continue
        mark(kpts[i, 0], kpts[i, 1], (255, 0, 0) if inl[i] else (0, 255, 0))
    if out_path:
        write_png(out_path, rgb)
    return rgb
