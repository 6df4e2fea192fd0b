"""Trajectory + map plots.

Copy of ``monocular_visual_odometry_tpu.viz.trajectory``: offline
matplotlib exports of the estimated and ground-truth trajectories, the
map-point cloud, keyframes and the newest points, the estimate
scale-aligned to ground truth at display time (monocular scale is
arbitrary). matplotlib is imported inside the functions only, so the rest
of the package runs where it is not installed; :func:`animate_trajectory`
saves its GIF through matplotlib's Pillow writer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from monocular_visual_odometry_tpu_torch.utils.metrics import align_scale


def plot_trajectory(est: np.ndarray, gt: Optional[np.ndarray] = None,
                    map_pts: Optional[np.ndarray] = None,
                    keyframes: Optional[np.ndarray] = None,
                    new_pts: Optional[np.ndarray] = None,
                    map_gray: Optional[np.ndarray] = None,
                    out_path: str = "trajectory.png",
                    title: str = "", three_d: bool = True) -> str:
    """Top-down (x-z) + side (z-y) trajectory views plus an optional 3-D
    view: estimated vs GT, map-point cloud, keyframe markers (red), newly
    triangulated points (red cloud), camera position glyph (x at the last
    pose). Returns the written path.

    ``keyframes``: [Kf,4,4] poses or [Kf,3] positions. ``new_pts``: [P,3].
    The estimate (and everything expressed in its frame: map points,
    keyframes, new points) is scale-aligned to GT at display time, as the
    reference does (run_vo.cpp:256-262).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.asarray(est)
    pe = est[:, :3, 3]

    s = 1.0
    if gt is not None and len(est) > 2:
        s = align_scale(est, np.asarray(gt)[: len(est)])
    origin = pe[0]
    pe = (pe - origin) * s

    def world(p):
        return (np.asarray(p) - origin) * s

    kf = None
    if keyframes is not None and len(keyframes):
        kf = np.asarray(keyframes)
        kf = kf[:, :3, 3] if kf.ndim == 3 else kf
        kf = world(kf)
    mp = world(map_pts) if map_pts is not None and len(map_pts) else None
    # per-point intensity shading (MapState.gray — the grayscale analogue
    # of the reference's colored PCL cloud, pcl_display.cpp:16-33)
    mp_c = "#bbbbbb"
    if mp is not None and map_gray is not None and len(map_gray) == len(mp):
        g = np.clip(np.asarray(map_gray, float) / 255.0, 0.0, 1.0)
        mp_c = np.stack([0.35 + 0.6 * g] * 3, axis=-1)
    npts = world(new_pts) if new_pts is not None and len(new_pts) else None
    pg = None
    if gt is not None:
        pg = np.asarray(gt)[:, :3, 3]
        pg = pg - pg[0]

    fig = plt.figure(figsize=(16, 5) if three_d else (12, 5))
    axes = [fig.add_subplot(1, 3 if three_d else 2, k + 1)
            for k in range(2)]
    for ax, (i, j), name in zip(axes, [(0, 2), (2, 1)],
                                ["top-down (x-z)", "side (z-y)"]):
        if mp is not None:
            ax.scatter(mp[:, i], mp[:, j], s=2, c=mp_c, label="map points")
        if npts is not None:
            ax.scatter(npts[:, i], npts[:, j], s=6, c="#d62728",
                       label="new points")
        ax.plot(pe[:, i], pe[:, j], "-", lw=1.2, c="#1f77b4", label="estimated")
        if kf is not None:
            ax.scatter(kf[:, i], kf[:, j], s=18, c="#d62728", marker="s",
                       label="keyframes")
        if pg is not None:
            ax.plot(pg[:, i], pg[:, j], "-", c="#2ca02c", label="ground truth")
        ax.scatter([pe[-1, i]], [pe[-1, j]], s=60, c="#1f77b4", marker="x")
        ax.set_title(name)
        ax.axis("equal")
        ax.legend(fontsize=8)

    if three_d:
        ax3 = fig.add_subplot(1, 3, 3, projection="3d")
        if mp is not None:
            ax3.scatter(mp[:, 0], mp[:, 2], mp[:, 1], s=1, c=mp_c)
        if npts is not None:
            ax3.scatter(npts[:, 0], npts[:, 2], npts[:, 1], s=5, c="#d62728")
        ax3.plot(pe[:, 0], pe[:, 2], pe[:, 1], c="#1f77b4")
        if kf is not None:
            ax3.scatter(kf[:, 0], kf[:, 2], kf[:, 1], s=15, c="#d62728",
                        marker="s")
        if pg is not None:
            ax3.plot(pg[:, 0], pg[:, 2], pg[:, 1], c="#2ca02c")
        ax3.set_title("3-D (x, z, y)")

    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def animate_trajectory(est: np.ndarray, gt: Optional[np.ndarray] = None,
                       map_pts: Optional[np.ndarray] = None,
                       map_created_idx: Optional[np.ndarray] = None,
                       out_path: str = "trajectory.gif",
                       max_anim_frames: int = 60, fps: int = 10) -> str:
    """Incremental GIF of the growing trajectory + map cloud — the offline
    equivalent of the reference's live demo GIFs (README.md:216-234): the
    estimated path grows frame by frame (GT-scale-aligned, like the live
    PCL view, run_vo.cpp:256-262), the camera marker tracks the newest
    pose, and map points appear from the frame that triangulated them
    (``map_created_idx``; culled points simply never show).

    Renders a top-down (x-z) view, subsampled to at most
    ``max_anim_frames`` animation frames. Returns the written path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import PillowWriter

    est = np.asarray(est)
    pe = est[:, :3, 3]
    n = len(pe)
    s = 1.0
    if gt is not None and n > 2:
        s = align_scale(est, np.asarray(gt)[:n])
    origin = pe[0] if n else np.zeros(3)
    pe = (pe - origin) * s
    pg = None
    if gt is not None:
        pg = np.asarray(gt)[:, :3, 3]
        pg = pg - pg[0]
    mp = ((np.asarray(map_pts) - origin) * s
          if map_pts is not None and len(map_pts) else None)
    created = (np.asarray(map_created_idx)
               if map_created_idx is not None else None)

    # fixed axes over the whole run so the view does not jump
    allx = [pe[:, 0]]
    allz = [pe[:, 2]]
    if pg is not None:
        allx.append(pg[:, 0]); allz.append(pg[:, 2])
    if mp is not None:
        allx.append(mp[:, 0]); allz.append(mp[:, 2])
    ax_min = np.array([np.concatenate(allx).min(), np.concatenate(allz).min()])
    ax_max = np.array([np.concatenate(allx).max(), np.concatenate(allz).max()])
    pad = 0.05 * (ax_max - ax_min + 1e-6)

    step = max(n // max_anim_frames, 1)
    idxs = list(range(0, n, step)) + ([n - 1] if (n - 1) % step else [])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 5))
    writer = PillowWriter(fps=fps)
    writer.setup(fig, out_path, dpi=fig.dpi)
    for i in idxs:
        ax.clear()
        if mp is not None:
            vis = mp if created is None else mp[(created >= 0) & (created <= i)]
            if len(vis):
                ax.scatter(vis[:, 0], vis[:, 2], s=2, c="#bbbbbb")
        if pg is not None:
            ax.plot(pg[:, 0], pg[:, 2], "-", c="#2ca02c", lw=1.0, alpha=0.6,
                    label="ground truth")
        ax.plot(pe[: i + 1, 0], pe[: i + 1, 2], "-", c="#1f77b4", lw=1.4,
                label="estimated")
        ax.scatter([pe[i, 0]], [pe[i, 2]], s=70, c="#d62728", marker="x")
        ax.set_xlim(ax_min[0] - pad[0], ax_max[0] + pad[0])
        ax.set_ylim(ax_min[1] - pad[1], ax_max[1] + pad[1])
        ax.set_title(f"frame {i + 1}/{n}")
        ax.legend(fontsize=8, loc="upper left")
        writer.grab_frame()
    writer.finish()
    plt.close(fig)
    return out_path
