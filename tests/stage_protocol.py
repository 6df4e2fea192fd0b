"""The JAX repo's stage-level profiling tools on the port, shared by
``tests/test_torch_stage_protocol.py`` and phase 4k of ``chip_smoke.py``.

The JAX tools time pieces of the step one at a time: ``profile_bisect.py``
cumulative prefixes of the tracking frame, ``profile_scan.py`` the stages
repeated inside one dispatch, ``profile_iso.py`` tracking alone and with BA
and the keyframe update, ``profile_ba_floor.py`` BA's per-iteration cost
against its fixed cost and its three parts, ``profile_init.py`` /
``profile_twoview.py`` the pieces of ``bench.py`` cfg1's two-view init.
Here each piece is a function of no arguments over fixed tensors, built from
the port ops the stage programs call, so that on a card it can be captured
as one CUDA graph (:func:`capture`) and replayed:

- :func:`track_pieces`: on one state and frame (:func:`tracking_chain`),
  the prefixes a (features), b (+ the frustum scan, the union gate and the
  candidate compaction: ``vo.track_candidates``), c (+ the 3D-2D match,
  the kernel), d (+ RANSAC-PnP on the tracking program's draws), e (the
  whole ``step_track``); ``ba_update_state``, ``keyframe_update``, and the
  glue the tracking program adds around them (the two selects on
  ``tracking_ok`` / ``is_keyframe`` and the program's tail,
  ``capture.finish``, writing into scratch buffers so that a replay leaves
  the state alone). e + ba + keyframe + glue is the tracking program
  (``vo.StagePrograms``) op for op.
- :func:`ba_pieces`: ``ba_update_state`` at ``BA_ITERS`` LM iterations, and
  ``gather_window``, ``ba_solve`` and ``write_back`` each alone;
  :func:`linear_fit` splits a cost into per iteration and fixed.
- :func:`init_pieces`: A (features of both frames), B (+ the init match),
  C (+ ``twoview.estimate_relative_pose`` as ``step_init`` calls it, on the
  init program's draws), D (``estimate_relative_pose`` alone on B's
  matched points); :func:`init_program_pose` reads R, t and the inliers
  out of the init stage program itself.

Imports torch, numpy and the port only (the card's machine has no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from monocular_visual_odometry_tpu_torch.models import ba
from monocular_visual_odometry_tpu_torch.models import state as S
from monocular_visual_odometry_tpu_torch.models import vo as V
from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep, finish
from monocular_visual_odometry_tpu_torch.ops import pnp, twoview
from monocular_visual_odometry_tpu_torch.ops.features import features_from_config

# profile_ba_floor.py: a tracking state from 16 frames of
# make_trajectory(16, 0, 0.05) over default_scene(0); the next frame is the
# 17th of make_trajectory(17, ...), whose first 16 poses are the same
STATE_FRAMES, STATE_STEP = 16, 0.05
BA_ITERS = (1, 2, 4, 8, 12)
INIT_PAIR = (0, 3)  # bench.py cfg1: frames 0 and 3 of the benchmark sequence
TRACK_ORDER = ("a", "b", "c", "d", "e", "ba", "keyframe", "glue")
PREFIXES = ("a", "b", "c", "d", "e")


@contextlib.contextmanager
def tap(module, name: str, record: list):
    """``module.name`` wrapped for the block: every result it returns is
    appended to ``record``. A program captured inside the block keeps writing
    its replays' values into the tensors recorded during its capture."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(out)
        return out

    setattr(module, name, wrapped)
    try:
        yield record
    finally:
        setattr(module, name, fn)


class Chain(NamedTuple):
    """The tracking program's parts run eagerly once, one after another, on
    one state and frame with the program's draws: the inputs each piece
    reads."""

    st: S.VOState          # the state, its key left out (as the program sees it)
    img: torch.Tensor
    draws: V.BatchedDraws
    new: S.VOState         # step_track's
    out: S.StepOutput
    feats: object
    curr_mp: torch.Tensor
    solved: Optional[S.VOState]  # ba_update_state(new); None with BA off
    sel: S.VOState         # the BA select's result
    kf_new: S.VOState      # keyframe_update(sel)


def tracking_draws(cfg, key: int, device) -> V.BatchedDraws:
    """The tracking program's draws from the key ``key``, as
    ``vo.StagePrograms`` makes them."""
    return V._stage_draws(cfg, S.STAGE_TRACKING, key, device)


def tracking_chain(cfg, cam, st: S.VOState, img: torch.Tensor, *, height: int,
                   width: int) -> Chain:
    """:func:`Chain` from a tracking state with its key (``st.rng``) and the
    next frame, with the tracking program's draws from that key."""
    d = tracking_draws(cfg, int(st.rng), img.device)
    st = st._replace(rng=None)
    new, out, feats, curr_mp = V.step_track(cfg, cam, st, img, height=height, width=width,
                                            u=d.pnp)
    solved = ba.ba_update_state(cfg, cam, new) if cfg.ba.enabled else None
    sel = new if solved is None else V._tree_select(out.tracking_ok, solved, new)
    kf_new = V.keyframe_update(cfg, cam, sel, feats, curr_mp, height=height, width=width,
                               u=d.epi)
    return Chain(st, img, d, new, out, feats, curr_mp, solved, sel, kf_new)


def prefix_pieces(cfg, cam, st: S.VOState, img: torch.Tensor, draws: V.BatchedDraws, *,
                  height: int, width: int) -> dict:
    """The tracking frame's prefixes on a state (its key left out) and
    frame with the tracking program's draws: name -> function of no
    arguments returning what it computes: a the features; b also the
    candidate pool; c also the matches; d also the PnP result; e
    ``step_track``'s (new state, StepOutput, features, keypoint links)."""
    feats = lambda: features_from_config(img, cfg.orb)

    def b():
        return feats(), V.track_candidates(cfg, cam, st, height=height, width=width)

    def c():
        f, cs = b()
        return f, cs, V.match_candidates(cfg, cs, f)

    def d():
        f, cs, m = c()
        return f, cs, m, pnp.solve_pnp_ransac(
            cs.pts, f.kpts[m.train_idx], m.valid, cam, None,
            threshold_px=cfg.ransac.pnp_reproj_threshold_px,
            n_hypotheses=cfg.ransac.pnp_n_hypotheses,
            min_inliers=cfg.ransac.pnp_min_inliers, u=draws.pnp)

    return {"a": feats, "b": b, "c": c, "d": d,
            "e": lambda: V.step_track(cfg, cam, st, img, height=height, width=width,
                                      u=draws.pnp)}


def track_pieces(cfg, cam, ch: Chain, *, height: int, width: int) -> dict:
    """The tracking frame's pieces over ``ch`` (see the module docstring),
    in TRACK_ORDER: name -> function of no arguments returning its results;
    the prefixes are :func:`prefix_pieces`."""
    st, img = ch.st, ch.img
    # the program's buffers are the state's leaves, the frame's and the
    # draws'; its tail copies the new state into scratch buffers here
    state_leaves = tree_flatten(st)[0]
    inputs = tree_flatten((st, img, ch.draws))[0]
    scratch = [None if t is None else torch.empty_like(t) for t in state_leaves]

    def glue():
        if ch.solved is not None:
            V._tree_select(ch.out.tracking_ok, ch.solved, ch.new)  # its result is ch.sel
        new = V._tree_select(ch.out.is_keyframe, ch.kf_new, ch.sel)
        out = ch.out._replace(T_w_c=new.T_w_c, n_map_points=new.map.n_valid,
                              ba_rejected_total=new.ba_rejected)
        return finish(state_leaves, new, [out], inputs, into=scratch)

    pieces = prefix_pieces(cfg, cam, st, img, ch.draws, height=height, width=width)
    if cfg.ba.enabled:
        pieces["ba"] = lambda: ba.ba_update_state(cfg, cam, ch.new)
    pieces["keyframe"] = lambda: V.keyframe_update(cfg, cam, ch.sel, ch.feats, ch.curr_mp,
                                                   height=height, width=width, u=ch.draws.epi)
    pieces["glue"] = glue
    return pieces


def ba_pieces(cfg, cam, st: S.VOState) -> dict:
    """``profile_ba_floor.py``'s pieces on ``st`` (the state BA sees in the
    tracking program: ``Chain.new``): ``ba@n`` = ``ba_update_state`` at n LM
    iterations for n in BA_ITERS, then ``gather_window``, ``ba_solve`` and
    ``write_back`` each alone on the others' eager results."""
    out = {f"ba@{n}": (lambda c=cfg.replace(ba=dataclasses.replace(cfg.ba, iterations=n)):
                       ba.ba_update_state(c, cam, st))
           for n in BA_ITERS}
    prob, slots = ba.gather_window(cfg, st, cam)
    T_c_w, pts, _ = ba.ba_solve(cfg, cam, prob)
    out["gather_window"] = lambda: ba.gather_window(cfg, st, cam)
    out["ba_solve"] = lambda: ba.ba_solve(cfg, cam, prob)
    out["write_back"] = lambda: ba.write_back(cfg, st, prob, slots, T_c_w, pts)
    return out


def linear_fit(xs, ys) -> tuple[float, float]:
    """(slope, intercept) of the least-squares line through (xs, ys)."""
    slope, intercept = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(slope), float(intercept)


def init_pieces(cfg, cam, img1: torch.Tensor, img2: torch.Tensor, key: int) -> dict:
    """``profile_init.py``'s stages on one pair, each as ``step_init``
    computes it with the init program's draws from ``key``: A features of
    both frames; B + the init match; C + ``estimate_relative_pose`` (returns
    R, t, inliers); D ``estimate_relative_pose`` alone on B's matched points
    (B run once eagerly)."""
    d = V._stage_draws(cfg, S.STAGE_INITIALIZING, key, img1.device)

    def a():
        return features_from_config(img1, cfg.orb), features_from_config(img2, cfg.orb)

    def b():
        f1, f2 = a()
        return f1, f2, V._match(cfg, f1.desc, f2.desc, f1.valid, f2.valid, f1.kpts, f2.kpts,
                                cfg.match.max_pixel_dist_init)

    def pose(uv1, uv2, valid):
        return twoview.estimate_relative_pose(
            uv1, uv2, valid, cam, None, threshold_px=cfg.ransac.threshold_px,
            n_hypotheses=cfg.ransac.n_hypotheses,
            use_reference_selection=cfg.init.use_reference_selection,
            essential_minimal=cfg.ransac.essential_minimal,
            u_e=d.init_e, u_h=d.init_h, G_e=d.init_G)

    def c():
        f1, f2, m = b()
        tv = pose(f1.kpts[m.query_idx], f2.kpts[m.train_idx], m.valid)
        return tv.R, tv.t, tv.inliers

    f1, f2, m = b()
    uv1, uv2, valid = f1.kpts[m.query_idx], f2.kpts[m.train_idx], m.valid
    return {"A": a, "B": b, "C": c, "D": lambda: pose(uv1, uv2, valid)}


def init_program_pose(cfg, cam, img1: torch.Tensor, img2: torch.Tensor, *, height: int,
                      width: int, seed: int = 0):
    """The init stage program of ``vo.StagePrograms`` on the pair: the first
    frame's program on ``img1`` from ``init_state(cfg, seed)``, then the
    init program on ``img2``, its ``estimate_relative_pose`` tapped.
    Returns (R, t, inliers as the program computed them, the key its draws
    came from, the programs)."""
    st = S.init_state(cfg, seed, img1.device)
    key = int(st.rng)
    programs = V.StagePrograms(cfg, cam, height, width, img1.device)
    st1, _ = programs(st, img1, S.STAGE_BLANK, key)
    record = []
    with tap(twoview, "estimate_relative_pose", record):
        programs(st1._replace(rng=torch.tensor(key, dtype=torch.int64)), img2,
                 S.STAGE_INITIALIZING, key)
    tv = record[-1]
    return tv.R, tv.t, tv.inliers, key, programs


def capture(fn, device) -> CapturedStep:
    """``fn`` (no arguments) as a ``CapturedStep`` called once (on a card:
    warmed up, captured as one CUDA graph and replayed). Its only input is a
    one-element placeholder it hands back unchanged, so ``replay()`` runs
    ``fn``'s kernels and nothing else: no copy in, no copy back."""
    prog = CapturedStep(lambda s: (s, fn()))
    prog(torch.zeros(1, device=device))
    return prog
