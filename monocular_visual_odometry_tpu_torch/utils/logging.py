"""Per-stage timing, the per-frame banner, and a profiler trace.

Copy of ``monocular_visual_odometry_tpu.utils.logging``, with
:func:`torch_trace` (a ``torch.profiler`` trace) in place of its
``jax_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Accumulates wall-clock per named stage; prints a summary table."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'stage':<24}{'calls':>8}{'total_s':>10}{'mean_ms':>10}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<24}{n:>8}{tot:>10.3f}{tot / max(n,1) * 1e3:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Wrap a block in a ``torch.profiler`` trace of CPU and (where there is
    a card) CUDA activity when ``log_dir`` is set; the trace is written to
    ``log_dir/trace.json`` in the Chrome trace format."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def format_step(frame_idx: int, out) -> str:
    """One-line per-frame banner."""
    stage_names = {0: "BLANK", 1: "INIT", 2: "TRACK"}
    return (
        f"frame {frame_idx:4d} [{stage_names.get(int(out.stage), '?'):5s}] "
        f"kpts={int(out.n_keypoints):4d} matches={int(out.n_matches):4d} "
        f"inliers={int(out.n_inliers):4d} map={int(out.n_map_points):4d} "
        f"{'KF' if bool(out.is_keyframe) else '  '} "
        f"{'ok' if bool(out.tracking_ok) else 'TRACK-FAIL'}"
    )
