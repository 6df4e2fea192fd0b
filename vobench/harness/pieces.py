"""The tracking frame in pieces, for the per-stage metrics of a traced run.

A frozen copy of the piece builders of the repository's stage protocol (the
tracking frame's prefixes a, c, d, ``ba_update_state`` and
``keyframe_update`` on one state and frame, each a function of no arguments
that :func:`capture` turns into one CUDA graph), with its profiler guard:
spin kernels queued before and after the profiled replays take the device
records a profile loses at its start, and the counts must come out a
multiple of the replays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

PROFILED = 5       # replays per piece under the profiler
MARKERS = 4096     # spin kernels before and after them


class Chain(NamedTuple):
    """The tracking program's parts run eagerly once on one state (its key
    left out) and frame with the program's draws: the inputs of the pieces."""

    st: object
    img: torch.Tensor
    draws: object
    new: object            # step_track's state: what BA sees
    out: object
    feats: object
    curr_mp: torch.Tensor
    solved: Optional[object]
    sel: object            # the BA select's result: what the keyframe update sees


def tracking_chain(cfg, cam, st, key: int, img: torch.Tensor, *, height: int,
                   width: int) -> Chain:
    from monocular_visual_odometry_tpu_torch.models import ba
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V

    d = V._stage_draws(cfg, S.STAGE_TRACKING, key, img.device)
    st = st._replace(rng=None)
    new, out, feats, curr_mp = V.step_track(cfg, cam, st, img, height=height, width=width,
                                            u=d.pnp)
    solved = ba.ba_update_state(cfg, cam, new) if cfg.ba.enabled else None
    sel = new if solved is None else V._tree_select(out.tracking_ok, solved, new)
    return Chain(st, img, d, new, out, feats, curr_mp, solved, sel)


def track_pieces(cfg, cam, ch: Chain, *, height: int, width: int) -> dict:
    """name -> function of no arguments: ``a`` the features; ``c`` also the
    candidate pool and the match; ``d`` also RANSAC-PnP; ``ba`` and
    ``keyframe`` the two stages on the states the program hands them."""
    from monocular_visual_odometry_tpu_torch.models import ba
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops import pnp
    from monocular_visual_odometry_tpu_torch.ops.features import features_from_config

    st, img = ch.st, ch.img
    feats = lambda: features_from_config(img, cfg.orb)

    def c():
        f = feats()
        cs = V.track_candidates(cfg, cam, st, height=height, width=width)
        return f, cs, V.match_candidates(cfg, cs, f)

    def d():
        f, cs, m = c()
        return f, cs, m, pnp.solve_pnp_ransac(
            cs.pts, f.kpts[m.train_idx], m.valid, cam, None,
            threshold_px=cfg.ransac.pnp_reproj_threshold_px,
            n_hypotheses=cfg.ransac.pnp_n_hypotheses,
            min_inliers=cfg.ransac.pnp_min_inliers, u=ch.draws.pnp)

    pieces = {"a": feats, "c": c, "d": d}
    if cfg.ba.enabled:
        pieces["ba"] = lambda: ba.ba_update_state(cfg, cam, ch.new)
    pieces["keyframe"] = lambda: V.keyframe_update(cfg, cam, ch.sel, ch.feats, ch.curr_mp,
                                                   height=height, width=width, u=ch.draws.epi)
    return pieces


def capture(fn, device):
    """``fn`` (no arguments) as a ``CapturedStep`` called once; its only input
    is a one-element placeholder handed back unchanged, so ``replay()`` runs
    ``fn``'s kernels and nothing else."""
    from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep

    prog = CapturedStep(lambda s: (s, fn()))
    prog(torch.zeros(1, device=device))
    return prog


def markers() -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(100)


def kind(name: str) -> str:
    """A device event's name with the memory kind of a copy or fill left out
    (one graph node's records can carry either)."""
    return name.split(" (")[0] if name.startswith(("Memset", "Memcpy")) else name


def device_events(prof) -> list:
    """[(start ns, end ns, name)] of the trace's device events in the order
    they ran, from the profiler's raw events."""
    ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sorted(ev)


def profile_replays(name: str, prog) -> list:
    """PROFILED replays of ``prog`` between two runs of markers: the
    replays' device events [(name, ms)] in the order they ran. Raises unless
    every kernel's count is a multiple of PROFILED (records lost)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        markers()
        for _ in range(PROFILED):
            prog.replay()
        markers()
        torch.cuda.synchronize()
    ev = device_events(prof)
    seq = [(kind(n), (b - a) / 1e6) for a, b, n in ev if "spin_kernel" not in n]
    counts = {}
    for n, _ in seq:
        counts[n] = counts.get(n, 0) + 1
    uneven = [(n[:60], c) for n, c in counts.items() if c % PROFILED]
    if uneven or len(seq) == len(ev):
        raise RuntimeError(f"the profile of piece {name} lost device records inside its "
                           f"replays: {uneven[:5]}")
    return seq


def after_prefix(short: list, long: list) -> float:
    """Busy ms per replay of ``long``'s kernels after those of ``short``, a
    piece that is its prefix, read inside ``long``'s profile (two profiles of
    one graph differ by up to 0.5 ms). Raises unless ``long``'s first kernels
    are ``short``'s, kernel for kernel (compared without template arguments,
    copies and fills as one kind)."""
    coarse = lambda x: "copy or fill" if x.startswith(("Memset", "Memcpy")) else x.split("<")[0]
    n_s, n_l = len(short) // PROFILED, len(long) // PROFILED
    want = [coarse(n) for n, _ in short[:n_s]]
    tail = 0.0
    for r in range(PROFILED):
        rp = long[r * n_l:(r + 1) * n_l]
        if [coarse(n) for n, _ in rp[:n_s]] != want:
            raise RuntimeError("the shorter piece's kernels are not the first of the longer's")
        tail += sum(ms for _, ms in rp[n_s:])
    return tail / PROFILED
