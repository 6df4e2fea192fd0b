"""What decides ``correct``: the timed path's outputs against the plain
reference (``vobench/reference/``), each number beside its limit.

Over the window:

- ``ate_pct`` / ``failures``: every pass the window completed, of every
  stream: the Sim(3) ATE of its poses against the ground truth the
  benchmark rendered them from, as a share of the path, and its tracking
  failures. The limits are the accuracy the configuration promises.
- ``passes``: complete passes judged (at least the cell's ``min_passes``).

Layer by layer, on the frames the driver kept (their state before and after
the frame, and the frame's output), against float64 references that take
the frame and the program's outputs only:

- ORB frontend, ``score_gap``: the Harris scores the reference keyframe in
  the state holds (computed by a timed frame) against the reference
  frontend's at the same keypoints of the same frame: the largest
  difference over the larger of the keypoint's own reference score and the
  frame's median one. ``score_frames``: keyframes compared.
- RANSAC-PnP and BA, ``pose_excess_med_px``: on tracked frames, every pose
  the windowed BA wrote (the window's older frames on the links they held
  when BA ran, BA's window and gate rebuilt from the state before the
  frame; the frame's own pose where no keyframe update rewrote its links
  after BA) against the float64 minimiser of the same robust reprojection
  loss (``reference/pose.py``): the excess of the pose's loss over the
  minimiser's, as RMS pixels per link; the median over the poses.
  ``pose_frames``: poses compared.

With ``every`` (``control.py``), readings that no limit holds, kept to show
why: the widest pose excess and the camera-centre and rotation gaps; the
tracking match's links that are not the point's Hamming-nearest keypoint in
the union gate (``reference/match.py``); the two-view init's relative pose
against the float64 Sampson-optimal pose of its correspondences
(``reference/twoview.py``: a keypoint of the new frame linked to a new map
point and the reference frame's keypoint within 2 px of that point's
projection), as rotation and direction gaps and Sampson excess.

:func:`gather` takes what the program made while the driver still holds it;
:func:`judge` runs the reference after the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

STAGE_INIT, STAGE_TRACKING = 1, 2   # the port's STAGE_INITIALIZING, STAGE_TRACKING
PAIR_PX = 2.0                       # an init correspondence's reprojection in the first view


def gather(drv, win) -> dict:
    """The program's side of every comparison, as numpy, with each kept
    frame's reference keyframe image."""
    samples = []
    for s in win.samples:
        st = s["before"]
        ref_at = s["index"] - (int(st.frame_idx) - int(st.ref_frame_idx))
        samples.append(dict(s, ref_frame=np.asarray(drv.frame(s["stream"], ref_at))
                            if int(st.stage) != 0 and ref_at >= 0 else None))
    passes = [dict(stream=b, est=est, stages=st, ok=ok, gt=drv.gt[b])
              for b, est, st, ok in win.passes]
    return dict(samples=samples, passes=passes)


def pass_numbers(passes: list) -> tuple[float, int]:
    """(worst ATE %, worst failures) over the passes."""
    from reference import ate

    worst_ate, worst_fail = 0.0, 0
    for p in passes:
        worst_ate = max(worst_ate, ate.ate_pct(p["est"], p["gt"]))
        worst_fail = max(worst_fail, int(((p["stages"] == STAGE_TRACKING) & ~p["ok"]).sum()))
    return worst_ate, worst_fail


def score_items(samples: list) -> list:
    out = []
    for s in samples:
        if s["ref_frame"] is not None:
            f = s["before"].ref_feats
            v = f.valid.numpy()
            out.append(dict(frame=s["ref_frame"], kpts=f.kpts.numpy()[v],
                            levels=f.levels.numpy()[v], scores=f.scores.numpy()[v]))
    return out


def score_gap(items: list, orb_cfg: dict, dtype=torch.float64, device="cpu") -> float:
    from reference import orb

    gap = 0.0
    for it in items:
        ref = orb.harris_at(torch.from_numpy(it["frame"]).to(device), it["kpts"], it["levels"],
                            orb_cfg, dtype)
        den = np.maximum(np.abs(ref), np.median(np.abs(ref)))
        gap = max(gap, float(np.max(np.abs(it["scores"] - ref) / den)))
    return gap


def _np(t):
    return t.double().numpy() if t.is_floating_point() else t.numpy()


def _tracked(s) -> bool:
    return (int(s["before"].stage) == STAGE_TRACKING and int(s["out"].stage) == STAGE_TRACKING
            and bool(s["out"].tracking_ok))


def _links(s, frame_buffer: int):
    """(keypoints [K,2], map slots [L], keypoint of each [L]): the frame's
    inlier keypoints linked to points valid before it."""
    b, a = s["before"], s["after"]
    slot = int(b.frame_idx) % frame_buffer
    kpts = _np(a.ring.kpts[slot])
    mp = a.ring.mp_idx[slot].numpy().astype(np.int64)
    valid = b.map.valid.numpy()
    use = s["out"].kpt_inlier.numpy() & (mp >= 0)
    use &= valid[np.clip(mp, 0, len(valid) - 1)]
    k = np.nonzero(use)[0]
    return kpts, mp[k], k


def window_slots(b, ba: dict, frame_buffer: int) -> list:
    """The ring slots of the frame's BA window other than its own, as the
    port's ``gather_window`` picks them: the newest ``window - 1`` keyframes
    (``keyframe_window``) or the ``window - 1`` frames before it."""
    F, last = frame_buffer, int(b.frame_idx)
    occupied, is_kf = b.ring.occupied.numpy(), b.ring.is_kf.numpy()
    if ba["keyframe_window"]:
        fid = {s: last - (last - s) % F for s in range(F)}
        ok = [s for s in range(F)
              if occupied[s] and is_kf[s] and fid[s] >= 0 and s != last % F]
        return sorted(ok, key=lambda s: -fid[s])[:ba["window"] - 1]
    ids = [last - j for j in range(1, ba["window"])]
    return [i % F for i in ids if i >= 0 and occupied[i % F]]


def pose_numbers(samples: list, vo: dict) -> tuple[float, float, list, int]:
    """Over the tracked frames whose BA write the program kept: each pose BA
    wrote (the window's older frames, on the links they held when BA ran;
    the frame's own where no keyframe update changed its links after BA)
    against the float64 minimiser of the same objective."""
    from reference import pose

    cam, ba, F = vo["dataset"], vo["ba"], vo["map"]["frame_buffer"]
    gt, gr, ex, n = 0.0, 0.0, [], 0
    for s in samples:
        b, a = s["before"], s["after"]
        if not _tracked(s) or int(a.ba_rejected) != int(b.ba_rejected):
            continue
        pts, valid = _np(b.map.pts), b.map.valid.numpy()
        jobs = []
        for slot in window_slots(b, ba, F):
            mp = b.ring.mp_idx[slot].numpy().astype(np.int64)
            k = np.nonzero((mp >= 0) & valid[np.clip(mp, 0, len(valid) - 1)])[0]
            jobs.append((_np(b.ring.poses[slot]), _np(a.ring.poses[slot]), mp[k],
                         _np(b.ring.kpts[slot])[k]))
        if int(a.ref_frame_idx) != int(b.frame_idx):      # no keyframe update
            kpts, mp, k = _links(s, F)
            T = _np(a.T_w_c)
            jobs.append((T, T, mp, kpts[k]))
        for T_in, T_out, mp, uv in jobs:
            X = pts[mp]
            r, p = pose.project(pose.inv(T_in), X, cam)
            g = (p[:, 2] > 0) & (((r - uv) ** 2).sum(1) < ba["obs_gate_px"] ** 2)
            if g.sum() < 6:
                continue
            X, uv, h = X[g], uv[g], ba["huber_delta"]
            T_ref, _ = pose.refine(pose.inv(T_out), X, uv, cam, huber=h, gate=np.inf)
            dt, dr = pose.gap(T_out, pose.inv(T_ref))
            lost = pose.cost(pose.inv(T_out), X, uv, cam, h) - pose.cost(T_ref, X, uv, cam, h)
            gt, gr, n = max(gt, dt), max(gr, dr), n + 1
            ex.append(float(np.sqrt(max(lost, 0.0) / len(X))))
    return gt, gr, ex, n


def match_numbers(samples: list, vo: dict) -> tuple[int, int]:
    from reference import match

    cam, tr = vo["dataset"], vo["tracking"]
    miss = links = 0
    for s in samples:
        b, a = s["before"], s["after"]
        if not _tracked(s) or int(a.ref_frame_idx) != int(b.frame_idx):
            continue
        kpts, mp, k = _links(s, vo["map"]["frame_buffer"])
        T_w_c = _np(b.T_w_c)
        T_pred = T_w_c @ _np(b.last_rel) if tr["use_motion_model"] else T_w_c
        union = tr["use_motion_model"] and tr["motion_gate_union"]
        f = a.ref_feats
        miss += match.misses(_np(b.map.pts)[mp], b.map.desc.numpy()[mp], k, _np(f.kpts),
                             f.desc.numpy(), f.valid.numpy(), T_pred, T_w_c if union else None,
                             cam, cam["height"], cam["width"], vo["match"]["max_pixel_dist_pnp"])
        links += len(k)
    return miss, links


def init_numbers(samples: list, vo: dict) -> tuple[float, float, float, int]:
    from reference import pose, twoview

    cam = vo["dataset"]
    focal = 0.5 * (cam["fx"] + cam["fy"])
    rot, dirn, ex, n = 0.0, 0.0, 0.0, 0
    for s in samples:
        b, a = s["before"], s["after"]
        if int(b.stage) != STAGE_INIT or int(s["out"].stage) != STAGE_TRACKING:
            continue
        links = a.ref_mp_idx.numpy().astype(np.int64)
        created = a.map.created_idx.numpy()
        made = a.map.valid.numpy() & (created == int(b.frame_idx))
        k = np.nonzero((links >= 0) & made[np.clip(links, 0, len(made) - 1)])[0]
        X = _np(a.map.pts)[links[k]]
        uv2 = _np(a.ref_feats.kpts)[k]
        T_w_1 = _np(b.ref_pose)
        proj = pose.project(pose.inv(T_w_1), X, cam)[0]
        f1 = b.ref_feats
        kp1 = _np(f1.kpts)[f1.valid.numpy()]
        d2 = ((proj[:, None, :] - kp1[None, :, :]) ** 2).sum(-1)
        near = d2.argmin(1)
        pair = d2[np.arange(len(k)), near] <= PAIR_PX ** 2
        if pair.sum() < 8:
            continue
        uv1, uv2 = kp1[near[pair]], uv2[pair]
        R, t = twoview.relative_pose(uv1, uv2, cam)
        T_2_1 = pose.inv(_np(a.T_w_c)) @ T_w_1
        tp = T_2_1[:3, 3] / np.linalg.norm(T_2_1[:3, 3])
        rot = max(rot, np.degrees(pose.angle(T_2_1[:3, :3].T @ R)))
        dirn = max(dirn, float(np.degrees(np.arctan2(np.linalg.norm(np.cross(tp, t)), tp @ t))))
        x1, x2 = twoview.normalized(uv1, cam), twoview.normalized(uv2, cam)
        lost = (np.sum(twoview.sampson(T_2_1[:3, :3], tp, x1, x2) ** 2)
                - np.sum(twoview.sampson(R, t, x1, x2) ** 2))
        ex = max(ex, focal * float(np.sqrt(max(lost, 0.0) / len(x1))))
        n += 1
    return rot, dirn, ex, n


def numbers(got: dict, vo: dict, device="cpu", every: bool = False) -> dict:
    """The numbers by name: those a limit can hold, and with ``every`` the
    readings no limit holds (the widest pose excess and gaps, the match and
    the two-view init; ``PERF.md`` says why)."""
    worst_ate, worst_fail = pass_numbers(got["passes"])
    items = score_items(got["samples"])
    gt, gr, pex, n_pose = pose_numbers(got["samples"], vo)
    pex = np.asarray(pex if pex else [0.0])
    out = {"ate_pct": worst_ate, "failures": worst_fail, "passes": len(got["passes"]),
           "score_gap": score_gap(items, vo["orb"], device=device), "score_frames": len(items),
           "pose_excess_med_px": float(np.median(pex)), "pose_frames": n_pose}
    if every:
        miss, links = match_numbers(got["samples"], vo)
        rot, dirn, iex, n_init = init_numbers(got["samples"], vo)
        out.update({"pose_excess_px": float(pex.max()), "pose_gap_t": gt, "pose_gap_r": gr,
                    "match_misses": miss, "match_links": links, "init_excess_px": iex,
                    "init_rot_deg": rot, "init_dir_deg": dirn, "init_frames": n_init})
    return out


def judge(got: dict, config: dict, limits: dict, device="cpu", every: bool = False) -> dict:
    """name -> (value, rule, limit, holds) for every number compared; the
    rule is "<=" (at most the limit) or ">=" (at least). The limits are the
    configuration's accuracy and ``limits/<cell>.json``: a number with a
    dict there is held to its ``limit``, a whole number is a least count.
    ``every``: the numbers with no limit too, held to nothing (``control.py``
    reads them)."""
    acc = config["accuracy"]
    vals = numbers(got, config["vo_config"], device, every)
    rows = {"ate_pct": ("<=", acc["ate_pct_max"]), "failures": ("<=", acc["failures_max"])}
    for k, lim in limits.items():
        rows[k] = ("<=", lim["limit"]) if isinstance(lim, dict) else (">=", lim)
    out = {}
    for k, (op, lim) in rows.items():
        v = vals[k]
        out[k] = (v, op, lim, v <= lim if op == "<=" else v >= lim)
    if every:
        out.update({k: (v, "", None, True) for k, v in vals.items() if k not in out})
    return out
