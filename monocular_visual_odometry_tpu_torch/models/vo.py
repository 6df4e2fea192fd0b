"""The VO pipeline: per-frame stages, windowed bundle adjustment and the
host-side engine.

Port of ``monocular_visual_odometry_tpu.models.vo``. The JAX package runs
the whole frame as one jitted call and selects between branches with
masked selects (``lax.switch`` / ``lax.cond`` / ``_tree_select``). PyTorch
runs eagerly, so in the single-stream :func:`step` the stage dispatch, the
BA gate on ``tracking_ok`` and the keyframe decision are host branches on
values read back from the device; each branch computes what the selected
side of the JAX select computes. The stages themselves are the public
entry points :func:`step_first`, :func:`step_init` (branch-free, as in
JAX: the init gate applies its result by a select), :func:`step_track` and
:func:`keyframe_update`. A tracking frame runs tracking, then
(``cfg.ba.enabled`` and tracking held) ``models/ba.py::ba_update_state``,
then the keyframe update, which sees the corrected pose. With a ``mesh``
(``parallel.mesh.PointsMesh``) BA runs sharded over its ranks
(``parallel/dist_ba.py``) on every tracking frame and is applied by a
select, as in JAX's mesh route.

JAX's one program per frame is :class:`VOEngine`'s route (``fused=True``):
three stage programs, each branch-free with its RANSAC draws made on the
host, held as ``models/capture.py::CapturedStep``s: on a card each is a CUDA
graph, so a frame is one replay and one readback (the packed
``StepOutput``), whose ``stage`` picks the next frame's program and whose
``is_keyframe`` the next key. The tracking program (:func:`_track_frame`)
computes BA and the keyframe update on every tracking frame and applies them
by selects, as JAX's batched step does (JAX's ``step_fused``: ``lax.cond``).
With a ``mesh`` the tracking program runs the sharded BA instead, its
collectives captured with it under NCCL (gloo's cannot be: there the
tracking program runs eagerly). :func:`run_sequence` goes through the same
programs; :func:`step` stays the eager host-branch step (the reference of
both routes).

The multi-stream modes are JAX's form too: B streams advance by one
frame in one ``torch.func.vmap`` of a per-stream body with no host branch.
:func:`step_tracking_batched` takes streams that all track: BA and the
keyframe update run unconditionally and are applied by per-stream selects
(:func:`_tree_select`). :func:`step_general_batched` takes streams in any
stage (JAX's ``vmap(run_sequence)``): the first-frame, init and tracking
branches all run for every stream and its stage selects, as ``lax.switch``
does under vmap. Their random draws are made on the host from each
stream's key before the body, and one readback after it picks each
stream's next key. The body is a ``CapturedStep`` too (one replay per step),
cached by kind, B, config, camera, frame size and device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from monocular_visual_odometry_tpu_torch.models import ba
from monocular_visual_odometry_tpu_torch.models import state as S
from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep
from monocular_visual_odometry_tpu_torch.ops import fivepoint, lie, matching, pnp, twoview
from monocular_visual_odometry_tpu_torch.ops.camera import Camera, cam2pixel, in_frame
from monocular_visual_odometry_tpu_torch.ops.consts import take
from monocular_visual_odometry_tpu_torch.ops.features import FrameFeatures, features_from_config
from monocular_visual_odometry_tpu_torch.ops.ransac import split_key, uniforms
from monocular_visual_odometry_tpu_torch.parallel import dist_ba
from monocular_visual_odometry_tpu_torch.utils import logging as lg
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

_DEG = math.pi / 180.0


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median (lower middle) over masked entries; inf if none."""
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, float("inf")))).values
    n = torch.sum(mask)
    return take(s, torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0))


def _angle_filter(angles: torch.Tensor, mask: torch.Tensor, cfg: VOConfig) -> torch.Tensor:
    """Drop points with parallax below the minimum or above ratio x median."""
    med = _masked_median(angles, mask)
    lo = cfg.triang.min_triang_angle_deg * _DEG
    hi = cfg.triang.max_ratio_angle_over_median * med
    return mask & (angles >= lo) & (angles <= hi)


def compact_mask(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices of the True entries of ``mask`` in ascending order, packed
    into a [capacity] int64 array padded with -1; overflow is dropped."""
    m = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    tgt = torch.where(mask & (pos < capacity), pos, torch.full_like(pos, capacity))
    out = torch.full((capacity + 1,), -1, dtype=torch.int64, device=mask.device)
    # duplicates only at the scratch slot
    return out.index_put((tgt,), torch.arange(m, device=mask.device))[:capacity]


def scatter_links(base: torch.Tensor, train_idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """Scatter per-match values into per-keypoint slots with scatter-MAX,
    which is order-free under duplicate indices (winners' links >= -1
    dominate losers' sentinels; for bools max is OR). Negative indices wrap
    and out-of-range ones are dropped, as in JAX."""
    n = base.shape[0]
    idx = torch.where(train_idx < 0, train_idx + n, train_idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    work = torch.cat([base, base[:1]]).to(torch.int32)
    out = work.scatter_reduce(0, idx.to(torch.int64), values.to(torch.int32),
                              reduce="amax", include_self=True)[:n]
    return out.to(base.dtype)


def _tree_select(pred: torch.Tensor, a, b):
    """``torch.where(pred, a, b)`` over two records of the same structure. A
    field that is the same object on both sides (None included) is returned
    as it is: the single-stream state's ``rng`` lives on the CPU and must
    stay there."""
    if a is b:
        return a
    if hasattr(a, "_fields"):
        return type(a)(*(_tree_select(pred, x, y) for x, y in zip(a, b)))
    return torch.where(pred, a, b)


def _eye4(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def _i32(v, device) -> torch.Tensor:
    # a fill, not a copy from host memory (which waits on the card's stream)
    return torch.full((), v, dtype=torch.int32, device=device)


def _flag(v: bool, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.bool, device=device)


def _next_key(st: S.VOState):
    """(the state's next key, this stage's key). In the batched step's body
    ``st.rng`` is None: the host split the keys and made the draws."""
    if st.rng is None:
        return None, None
    rng, k = split_key(int(st.rng))
    return torch.tensor(rng, dtype=torch.int64), k


def _unit_normals(pts_w: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    nrm = pts_w - center[None, :]
    return nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-9)


def _match(cfg: VOConfig, desc1, desc2, valid1, valid2, kpts1, kpts2, radius,
           kpts1_alt=None) -> matching.Matches:
    return matching.match_features(
        desc1, desc2, valid1, valid2, kpts1, kpts2,
        method=cfg.match.method_index,
        max_pixel_dist=radius,
        xiang_gao_ratio=cfg.match.xiang_gao_match_ratio,
        lowe_ratio=cfg.match.lowe_dist_ratio,
        ambiguity_ratio=cfg.match.method3_ambiguity_ratio,
        kpts1_alt=kpts1_alt,
    )


# ---------------------------------------------------------------------------
# stage: first frame
# ---------------------------------------------------------------------------


def step_first(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor, *,
               feats: Optional[FrameFeatures] = None):
    """First frame: detect, T = I, become the reference keyframe. ``feats``:
    the frame's features, when the caller has them. Returns (new state,
    StepOutput)."""
    dev = img.device
    feats = features_from_config(img, cfg.orb) if feats is None else feats
    k = cfg.orb.max_keypoints
    eye = _eye4(dev)
    no_links = torch.full((k,), -1, dtype=torch.int32, device=dev)
    ring = st.ring.push(st.frame_idx % cfg.map.frame_buffer, eye, feats.kpts,
                        no_links, is_kf=True)
    new = st._replace(
        stage=_i32(S.STAGE_INITIALIZING, dev),
        frame_idx=st.frame_idx + 1,
        T_w_c=eye, ref_feats=feats, ref_pose=eye, ref_mp_idx=no_links,
        ref_frame_idx=st.frame_idx, last_keyframe_pose=eye, ring=ring,
    )
    new = S.push_keyframe(new, eye)
    out = S.StepOutput(
        T_w_c=eye, stage=new.stage, n_keypoints=feats.n_valid,
        # int64 as in the other stages: run_sequence preallocates one dtype a field
        n_matches=torch.zeros((), dtype=torch.int64, device=dev), n_inliers=_i32(0, dev),
        is_keyframe=_flag(True, dev), tracking_ok=_flag(True, dev),
        used_homography=_flag(False, dev), n_map_points=new.map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid,
        kpt_inlier=torch.zeros(k, dtype=torch.bool, device=dev),
        ba_rejected_total=st.ba_rejected, n_candidates=_i32(0, dev),
    )
    return new, out


# ---------------------------------------------------------------------------
# stage: initialization attempt
# ---------------------------------------------------------------------------


def step_init(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor, *,
              u_e: Optional[torch.Tensor] = None, u_h: Optional[torch.Tensor] = None,
              G_e: Optional[torch.Tensor] = None, feats: Optional[FrameFeatures] = None):
    """Two-view initialization attempt against the reference frame: match,
    E/H estimation and selection, the triangulation-angle filter, the
    quality gate and depth normalization. Branch-free, as in JAX: the
    succeeded and the unchanged state are both built (the map insert masked
    by the gate) and the gate selects between them. ``u_e`` / ``u_h`` / ``G_e``
    are the RANSAC draws when the caller made them (the batched step; see
    ``twoview.estimate_relative_pose``), ``feats`` the frame's features.
    Returns (new state, StepOutput)."""
    dev = img.device
    feats = features_from_config(img, cfg.orb) if feats is None else feats
    lg.mark("init.features")
    rng, k_est = _next_key(st)
    ref = st.ref_feats

    m = _match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts,
               feats.kpts, cfg.match.max_pixel_dist_init)
    uv1 = ref.kpts[m.query_idx]
    uv2 = feats.kpts[m.train_idx]
    lg.mark("init.match")

    tv = twoview.estimate_relative_pose(
        uv1, uv2, m.valid, cam, k_est,
        threshold_px=cfg.ransac.threshold_px,
        n_hypotheses=cfg.ransac.n_hypotheses,
        use_reference_selection=cfg.init.use_reference_selection,
        essential_minimal=cfg.ransac.essential_minimal,
        u_e=u_e, u_h=u_h, G_e=G_e,
    )
    T_2_1 = lie.rt_to_T(tv.R, tv.t)
    angles = twoview.triangulation_angles(tv.pts3d_c1, T_2_1)
    lg.mark("init.twoview")
    good = _angle_filter(angles, tv.inliers, cfg)

    n_good = torch.sum(good)
    mean_disp = matching.mean_pixel_displacement(ref.kpts, feats.kpts,
                                                 m._replace(valid=good))
    med_angle = _masked_median(angles, good)
    is_good = ((n_good >= cfg.init.min_inlier_matches)
               & (mean_disp > cfg.init.min_pixel_dist)
               & (med_angle > cfg.init.min_median_triang_angle_deg * _DEG))

    # depth normalization: mean depth in the current frame -> assumed
    pts_c2 = lie.transform_points(T_2_1, tv.pts3d_c1)
    mean_depth = (torch.sum(torch.where(good, pts_c2[:, 2], torch.zeros_like(angles)))
                  / torch.clamp(n_good, min=1))
    scale = cfg.init.assumed_mean_depth / torch.clamp(mean_depth, min=1e-6)
    T_w_c2 = st.ref_pose @ lie.inv_T(lie.rt_to_T(tv.R, tv.t * scale))
    pts_w = lie.transform_points(st.ref_pose, tv.pts3d_c1 * scale)
    # masked by the gate, so a failed attempt inserts nothing
    insert = good & is_good
    new_map, slots = S.insert_map_points(
        st.map, pts_w, feats.desc[m.train_idx],
        _unit_normals(pts_w, T_w_c2[:3, 3]), insert, frame_idx=st.frame_idx,
        gray=feats.gray[m.train_idx])
    k = cfg.orb.max_keypoints
    curr_mp = scatter_links(torch.full((k,), -1, dtype=torch.int32, device=dev), m.train_idx,
                            torch.where(insert, slots, torch.full_like(slots, -1)))
    pose_out = torch.where(is_good, T_w_c2, st.ref_pose)
    ring = st.ring.push(st.frame_idx % cfg.map.frame_buffer, pose_out,
                        feats.kpts, curr_mp, is_kf=is_good)

    succeeded = S.push_keyframe(st._replace(
        stage=_i32(S.STAGE_TRACKING, dev), T_w_c=T_w_c2, ref_feats=feats,
        ref_pose=T_w_c2, ref_mp_idx=curr_mp, ref_frame_idx=st.frame_idx,
        last_keyframe_pose=T_w_c2, map=new_map), T_w_c2)
    new = _tree_select(is_good, succeeded, st._replace(T_w_c=st.ref_pose))
    new = new._replace(frame_idx=st.frame_idx + 1, ring=ring, rng=rng)
    kpt_inlier = scatter_links(torch.zeros(k, dtype=torch.bool, device=dev), m.train_idx,
                               insert)
    out = S.StepOutput(
        T_w_c=pose_out, stage=new.stage, n_keypoints=feats.n_valid,
        n_matches=m.n_valid, n_inliers=n_good.to(torch.int32),
        is_keyframe=is_good, tracking_ok=_flag(True, dev),
        used_homography=tv.used_homography, n_map_points=new.map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid, kpt_inlier=kpt_inlier,
        ba_rejected_total=st.ba_rejected, n_candidates=_i32(0, dev),
    )
    return new, out


# ---------------------------------------------------------------------------
# stage: tracking (PnP against the local map)
# ---------------------------------------------------------------------------


class TrackCandidates(NamedTuple):
    """The tracking frame's candidate pool: the map slots in the frustum,
    compacted (``cfg.map.track_candidates``) into the matcher's queries."""

    candidates: torch.Tensor          # [M] bool: in the frustum (either projection)
    visible: torch.Tensor             # [M] int32: the map's visible counts, updated
    comp_idx: torch.Tensor            # [C] map slot per pool entry, -1 padded
    comp_ok: torch.Tensor             # [C] bool: the entry holds a candidate
    comp_safe: torch.Tensor           # [C] comp_idx clamped to a valid slot
    desc: torch.Tensor                # [C,32] descriptors
    proj: torch.Tensor                # [C,2] predicted projections (1e9: behind)
    pts: torch.Tensor                 # [C,3] map points
    proj_alt: Optional[torch.Tensor]  # [C,2] stale-pose projections (the union gate)


def track_candidates(cfg: VOConfig, cam: Camera, st: S.VOState, *, height: int,
                     width: int) -> TrackCandidates:
    """The frustum scan of :func:`step_track`, with the constant-velocity
    prediction and (union gate) the stale pose, and the candidate
    compaction."""
    dev = st.T_w_c.device
    # Asymmetric on purpose (as in the JAX package): the stale projection is
    # pushed to 1e9 when it is out of frame, the predicted one only when it
    # is behind the camera.
    use_union = cfg.tracking.use_motion_model and cfg.tracking.motion_gate_union
    T_proj = st.T_w_c @ st.last_rel if cfg.tracking.use_motion_model else st.T_w_c
    p_cam = lie.transform_points(lie.inv_T(T_proj), st.map.pts)
    proj = cam2pixel(p_cam, cam)
    candidates = st.map.valid & (p_cam[:, 2] > 0) & in_frame(proj, height, width)
    proj_s = None
    if use_union:
        p_cam_s = lie.transform_points(lie.inv_T(st.T_w_c), st.map.pts)
        proj_s = cam2pixel(p_cam_s, cam)
        ok_s = (p_cam_s[:, 2] > 0) & in_frame(proj_s, height, width)
        candidates = candidates | (st.map.valid & ok_s)
        proj_s = torch.where(ok_s[:, None], proj_s, torch.full_like(proj_s, 1e9))
        proj = torch.where((p_cam[:, 2] > 0)[:, None], proj, torch.full_like(proj, 1e9))
    visible = st.map.visible + candidates.to(torch.int32)

    # compact the in-frustum slots into the [C] candidate pool
    M = st.map.pts.shape[0]
    C = cfg.map.track_candidates
    if C and C < M:
        comp_idx = compact_mask(candidates, C)
        comp_ok = comp_idx >= 0
        comp_safe = torch.clamp(comp_idx, min=0)
        return TrackCandidates(candidates, visible, comp_idx, comp_ok, comp_safe,
                               st.map.desc[comp_safe], proj[comp_safe], st.map.pts[comp_safe],
                               proj_s[comp_safe] if use_union else None)
    comp_idx = torch.arange(M, device=dev)
    return TrackCandidates(candidates, visible, comp_idx, candidates, comp_idx, st.map.desc,
                           proj, st.map.pts, proj_s)


def match_candidates(cfg: VOConfig, c: TrackCandidates,
                     feats: FrameFeatures) -> matching.Matches:
    """The tracking frame's 3D-2D match: the candidate pool against the
    frame's keypoints, radius-gated around the projections."""
    return _match(cfg, c.desc, feats.desc, c.comp_ok, feats.valid, c.proj, feats.kpts,
                  cfg.match.max_pixel_dist_pnp, kpts1_alt=c.proj_alt)


def step_track(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor,
               *, height: int, width: int, u: Optional[torch.Tensor] = None,
               feats: Optional[FrameFeatures] = None):
    """Tracking: frustum scan and candidate compaction
    (:func:`track_candidates`), 3D-2D matching (:func:`match_candidates`),
    RANSAC-PnP, pose-jump rejection and the keyframe-need flag. ``u`` are
    the PnP draw's uniforms when the caller made them (the batched steps),
    ``feats`` the frame's features. Returns (new state, StepOutput,
    features, keypoint links)."""
    dev = img.device
    feats = features_from_config(img, cfg.orb) if feats is None else feats
    lg.mark("track.features")
    rng, k_pnp = _next_key(st)
    c = track_candidates(cfg, cam, st, height=height, width=width)
    m = match_candidates(cfg, c, feats)
    uv = feats.kpts[m.train_idx]
    lg.mark("track.match")

    res = pnp.solve_pnp_ransac(
        c.pts, uv, m.valid, cam, k_pnp,
        threshold_px=cfg.ransac.pnp_reproj_threshold_px,
        n_hypotheses=cfg.ransac.pnp_n_hypotheses,
        min_inliers=cfg.ransac.pnp_min_inliers, u=u,
    )
    T_w_c_new = lie.inv_T(res.T_c_w)

    # pose-jump rejection and pose freeze on failure
    jump = lie.pose_distance(T_w_c_new, st.T_w_c) > cfg.tracking.max_dist_to_prev_keyframe
    ok = res.ok & ~jump
    pose = torch.where(ok, T_w_c_new, st.T_w_c)

    inl_ok = res.inliers & ok
    matched_add = torch.zeros(st.map.pts.shape[0], dtype=torch.int32, device=dev).index_add(
        0, c.comp_safe, (inl_ok & c.comp_ok).to(torch.int32))
    new_map = st.map._replace(visible=c.visible, matched=st.map.matched + matched_add)
    k = cfg.orb.max_keypoints
    map_slot = c.comp_idx[m.query_idx].to(torch.int32)
    curr_mp = scatter_links(torch.full((k,), -1, dtype=torch.int32, device=dev),
                            m.train_idx, torch.where(inl_ok, map_slot,
                                                     torch.full_like(map_slot, -1)))

    need_kf = ok & (lie.pose_distance(pose, st.last_keyframe_pose)
                    > cfg.tracking.min_dist_between_keyframes)
    ring = st.ring.push(st.frame_idx % cfg.map.frame_buffer, pose, feats.kpts,
                        curr_mp, is_kf=need_kf)
    last_rel = torch.where(ok, lie.relative_T(st.T_w_c, pose), _eye4(dev))
    new = st._replace(frame_idx=st.frame_idx + 1, T_w_c=pose, map=new_map, ring=ring,
                      last_rel=last_rel, rng=rng)
    kpt_inlier = scatter_links(torch.zeros(k, dtype=torch.bool, device=dev),
                               m.train_idx, inl_ok)
    out = S.StepOutput(
        T_w_c=pose, stage=new.stage, n_keypoints=feats.n_valid,
        n_matches=m.n_valid, n_inliers=res.n_inliers.to(torch.int32),
        is_keyframe=need_kf, tracking_ok=ok,
        used_homography=_flag(False, dev),
        n_map_points=new_map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid, kpt_inlier=kpt_inlier,
        ba_rejected_total=st.ba_rejected,
        n_candidates=torch.sum(c.candidates, dtype=torch.int32),
    )
    lg.mark("track.pnp")
    return new, out, feats, curr_mp


# ---------------------------------------------------------------------------
# keyframe update: triangulate new points, cull, switch reference
# ---------------------------------------------------------------------------


def keyframe_update(cfg: VOConfig, cam: Camera, st: S.VOState,
                    feats: FrameFeatures, curr_mp: torch.Tensor,
                    *, height: int, width: int,
                    u: Optional[torch.Tensor] = None) -> S.VOState:
    """Match against the reference keyframe, epipolar-filter, triangulate
    with the tracked poses, angle-filter, insert with link reuse, cull the
    map and make the current frame the new reference. ``u`` are the
    E-RANSAC filter's uniforms when the caller made them (the batched
    steps)."""
    rng, k_epi = _next_key(st)
    ref = st.ref_feats

    m = _match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts,
               feats.kpts, cfg.match.max_pixel_dist_triang)
    uv1 = ref.kpts[m.query_idx]
    uv2 = feats.kpts[m.train_idx]

    if cfg.ransac.keyframe_use_ransac_filter:
        inl = twoview.find_inlier_matches_by_epipolar(
            uv1, uv2, m.valid, cam, k_epi, threshold_px=cfg.ransac.threshold_px,
            n_hypotheses=cfg.ransac.n_hypotheses // 2, u=u)
    else:
        inl = twoview.epipolar_filter_known_pose(
            uv1, uv2, m.valid, cam, st.ref_pose, st.T_w_c,
            threshold_px=cfg.ransac.threshold_px)

    pts_w, ok3d = twoview.triangulate_with_pose(uv1, uv2, inl, cam, st.ref_pose, st.T_w_c)
    T_2_1 = lie.relative_T(st.T_w_c, st.ref_pose)
    pts_c1 = lie.transform_points(lie.inv_T(st.ref_pose), pts_w)
    angles = twoview.triangulation_angles(pts_c1, T_2_1)
    good = _angle_filter(angles, ok3d, cfg)

    # a ref keypoint already linked to a map point does not spawn a duplicate
    ref_links = st.ref_mp_idx[m.query_idx]
    reuse = good & (ref_links >= 0)
    fresh = good & (ref_links < 0)

    cam_center = st.T_w_c[:3, 3]
    new_map, slots = S.insert_map_points(
        st.map, pts_w, feats.desc[m.train_idx], _unit_normals(pts_w, cam_center),
        fresh, frame_idx=st.frame_idx - 1, gray=feats.gray[m.train_idx])
    link_target = torch.where(reuse, ref_links,
                              torch.where(fresh, slots, torch.full_like(slots, -1)))
    curr_mp = scatter_links(curr_mp, m.train_idx, link_target)

    # map culling
    p_cam = lie.transform_points(lie.inv_T(st.T_w_c), new_map.pts)
    proj = cam2pixel(p_cam, cam)
    in_view = (p_cam[:, 2] > 0) & in_frame(proj, height, width)
    ratio = new_map.matched.to(torch.float32) / torch.clamp(
        new_map.visible.to(torch.float32), min=1.0)
    view_dir = _unit_normals(new_map.pts, cam_center)
    cosang = torch.sum(view_dir * new_map.normals, dim=-1)
    angle_ok = cosang > float(np.cos(np.float32(cfg.map.max_view_angle_deg * _DEG)))
    keep = new_map.valid & in_view & (ratio >= st.erase_ratio) & angle_ok
    new_map = new_map._replace(valid=keep)
    erase_ratio = torch.where(torch.sum(keep) > 1000, st.erase_ratio + 0.05,
                              torch.full_like(st.erase_ratio, cfg.map.default_erase_ratio))

    slot = (st.frame_idx - 1) % cfg.map.frame_buffer
    new = st._replace(
        ref_feats=feats, ref_pose=st.T_w_c, ref_mp_idx=curr_mp,
        ref_frame_idx=st.frame_idx - 1, last_keyframe_pose=st.T_w_c,
        map=new_map, ring=st.ring._replace(mp_idx=S.put_row(st.ring.mp_idx, slot, curr_mp)),
        erase_ratio=erase_ratio, rng=rng,
    )
    return S.push_keyframe(new, st.T_w_c)


# ---------------------------------------------------------------------------
# per-frame step and engine
# ---------------------------------------------------------------------------


def step(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor,
         *, height: int, width: int, mesh=None):
    """One frame through the stage its state is in, eagerly: the host reads
    the stage, the tracking gate and the keyframe decision back and runs
    only the branches they pick (JAX's ``step_fused`` selects with
    ``lax.cond``). The reference of the captured route (:class:`VOEngine`,
    :func:`run_sequence`), with or without a mesh. Returns (new state,
    StepOutput).

    ``mesh`` (a ``parallel.mesh.PointsMesh``): the windowed BA runs sharded
    over its ranks (``parallel.dist_ba``), honouring ``cfg.ba.fix_map_points``
    as the single-device BA does. As in JAX, it is computed on every
    tracking frame and applied where tracking held by a select, so the
    collectives a frame calls depend on its stage only. Every rank steps the
    same frames from the same state: the host branches below read values
    that are bitwise equal on every rank."""
    stage = int(st.stage)
    if stage == S.STAGE_BLANK:
        return step_first(cfg, cam, st, img)
    if stage == S.STAGE_INITIALIZING:
        return step_init(cfg, cam, st, img)
    new, out, feats, curr_mp = step_track(cfg, cam, st, img, height=height, width=width)
    if cfg.ba.enabled and mesh is not None:
        new = _tree_select(out.tracking_ok, dist_ba.ba_update_state_dist(cfg, cam, mesh, new),
                           new)
    elif cfg.ba.enabled and bool(out.tracking_ok):
        new = ba.ba_update_state(cfg, cam, new)
    if bool(out.is_keyframe):
        new = keyframe_update(cfg, cam, new, feats, curr_mp, height=height, width=width)
    return new, out._replace(T_w_c=new.T_w_c, n_map_points=new.map.n_valid,
                             ba_rejected_total=new.ba_rejected)


def _stack_outputs(outs: list[S.StepOutput]) -> S.StepOutput:
    return S.StepOutput(*(torch.stack(f) for f in zip(*outs)))


def _frames_on(frames, device) -> torch.Tensor:
    """A frame stack on ``device`` in one copy (its dtype kept; each step
    takes its frame as float32 there)."""
    return torch.as_tensor(np.asarray(frames) if not torch.is_tensor(frames) else frames).to(device)


def run_sequence(cfg: VOConfig, cam: Camera, st: S.VOState, frames, *,
                 height: int, width: int, mesh=None):
    """A [N,H,W] frame stack (moved to the device once) through the stage
    programs of :class:`StagePrograms` (made for this call; on a card one
    graph replay per frame), each frame's ``StepOutput`` written into a
    preallocated [N] output on the device; each frame reads back its stage
    and keyframe flag (one small copy), which pick the next frame's program
    and key. ``mesh``: the tracking program runs the sharded BA (see
    :class:`StagePrograms`). Returns (final state, StepOutput with a leading
    [N] on every field, on the state's device)."""
    frames = _frames_on(frames, st.T_w_c.device)
    programs = StagePrograms(cfg, cam, height, width, st.T_w_c.device, mesh=mesh)
    stage, key, outs = int(st.stage), int(st.rng), None
    for i, img in enumerate(frames):
        st, out = programs(st, img.to(torch.float32), stage, key)
        if outs is None:
            outs = S.StepOutput(*(torch.empty((len(frames),) + t.shape, dtype=t.dtype,
                                              device=t.device) for t in out))
        for o, t in zip(outs, out):
            o[i].copy_(t)
        stage_after, is_kf = _bytes_to_host([out.stage, out.is_keyframe])
        key = _advance_key(key, stage, bool(is_kf))
        st, stage = st._replace(rng=torch.tensor(key, dtype=torch.int64)), int(stage_after)
    return _snapshot(st), outs


# ---------------------------------------------------------------------------
# multi-stream steps: B streams, one vmapped step
# ---------------------------------------------------------------------------


class BatchedDraws(NamedTuple):
    """The uniforms a batched step's RANSACs draw from, stream by stream,
    each from that stream's key as :func:`step` would draw them. The init
    fields are drawn for the general step only (:func:`draw_general`)."""

    pnp: torch.Tensor            # [B, pnp_n_hypotheses, N] (N: the candidate pool)
    epi: Optional[torch.Tensor]  # [B, n_hypotheses // 2, K]; None unless the
                                 # keyframe update's E-RANSAC filter is on
    init_e: Optional[torch.Tensor] = None  # [B, S, K]: the init E-RANSAC's sample draw
                                           # (S: n_hypotheses; 5pt: max(n // 4, 8))
    init_h: Optional[torch.Tensor] = None  # [B, n_hypotheses, K]: the init H-RANSAC's
    init_G: Optional[torch.Tensor] = None  # [B, S, 4, 4]: the five-point basis remix


def _split_keys(rng: torch.Tensor) -> list[tuple[int, int, int, int]]:
    """Per stream, as :func:`step` splits them: (key after tracking or an
    init attempt, PnP key = init's estimation key, key after a keyframe
    update, its E-RANSAC key)."""
    out = []
    for r in rng.tolist():
        r1, k_pnp = split_key(r)
        r2, k_epi = split_key(r1)
        out.append((r1, k_pnp, r2, k_epi))
    return out


def _next_keys(rng: torch.Tensor, stage: list[int], is_kf: list[int]) -> torch.Tensor:
    """Each stream's key after its step, as :func:`step` leaves it: the same
    key after a first frame, the first split's after an init attempt or a
    tracking frame, the keyframe update's after a keyframe."""
    return torch.tensor([r if s == S.STAGE_BLANK else k[2] if s == S.STAGE_TRACKING and kf
                         else k[0] for r, k, s, kf in zip(rng.tolist(), _split_keys(rng),
                                                          stage, is_kf)], dtype=torch.int64)


def draw_batched(cfg: VOConfig, rng: torch.Tensor, device) -> BatchedDraws:
    """Each stream's tracking draws from its key ``rng`` [B] (CPU int64), on
    ``device``."""
    keys = _split_keys(rng)
    M, C = cfg.map.max_map_points, cfg.map.track_candidates
    n_pnp = C if C and C < M else M
    pnp_u = torch.stack([uniforms(k[1], (cfg.ransac.pnp_n_hypotheses, n_pnp), device)
                         for k in keys])
    epi_u = None
    if cfg.ransac.keyframe_use_ransac_filter:
        epi_u = torch.stack([uniforms(k[3], (cfg.ransac.n_hypotheses // 2,
                                             cfg.orb.max_keypoints), device) for k in keys])
    return BatchedDraws(pnp_u, epi_u)


def _draw_init(cfg: VOConfig, rng: torch.Tensor, device) -> BatchedDraws:
    """The init attempt's draws (the ``init_*`` fields; see
    :func:`draw_general`)."""
    K, n = cfg.orb.max_keypoints, cfg.ransac.n_hypotheses
    halves = [split_key(k[1]) for k in _split_keys(rng)]
    init_G = None
    if cfg.ransac.essential_minimal == "5pt":
        n_e = max(n // 4, 8)
        parts = [split_key(k_e) for k_e, _ in halves]
        init_e = torch.stack([uniforms(k_s, (n_e, K), device) for k_s, _ in parts])
        init_G = torch.stack([fivepoint.remix_draw(k_b, n_e, device) for _, k_b in parts])
    else:
        init_e = torch.stack([uniforms(k_e, (n, K), device) for k_e, _ in halves])
    init_h = torch.stack([uniforms(k_h, (n, K), device) for _, k_h in halves])
    return BatchedDraws(None, None, init_e, init_h, init_G)


def draw_general(cfg: VOConfig, rng: torch.Tensor, device) -> BatchedDraws:
    """:func:`draw_batched`'s draws and the init attempt's, each stream's
    from its key ``rng`` [B] (CPU int64), on ``device``: the init's key is
    the first split's second child (tracking's PnP key), split into the E
    and H halves; the five-point E-RANSAC splits its half again into the
    sample draw and the basis remix."""
    d = draw_batched(cfg, rng, device)
    return _draw_init(cfg, rng, device)._replace(pnp=d.pnp, epi=d.epi)


def _vmap_dims(record):
    """vmap's dims for a record: 0 for every tensor, None for a None field."""
    return tree_map(lambda v: None if v is None else 0, record)


def _track_frame(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor,
                 d: BatchedDraws, *, height: int, width: int,
                 feats: Optional[FrameFeatures] = None, mesh=None):
    """One stream's tracking frame in a batched body or a stage program:
    tracking, then BA (``cfg.ba.enabled``; with a ``mesh`` the sharded
    ``dist_ba.ba_update_state_dist``, as in :func:`step`) and the keyframe
    update computed unconditionally and applied where ``tracking_ok`` /
    ``is_keyframe`` hold."""
    new, out, feats, curr_mp = step_track(cfg, cam, st, img, height=height, width=width,
                                          u=d.pnp, feats=feats)
    if cfg.ba.enabled:
        solved = (ba.ba_update_state(cfg, cam, new) if mesh is None
                  else dist_ba.ba_update_state_dist(cfg, cam, mesh, new))
        new = _tree_select(out.tracking_ok, solved, new)
    lg.mark("track.ba")
    kf_new = keyframe_update(cfg, cam, new, feats, curr_mp, height=height, width=width, u=d.epi)
    new = _tree_select(out.is_keyframe, kf_new, new)
    return new, out._replace(T_w_c=new.T_w_c, n_map_points=new.map.n_valid,
                             ba_rejected_total=new.ba_rejected)


def _vmapped(one, sts: S.VOState, imgs: torch.Tensor, draws: BatchedDraws):
    """``one(st, img, draws)`` vmapped over the streams, ``rng`` left out."""
    st_in = sts._replace(rng=None)
    st_dims = _vmap_dims(st_in)
    return torch.func.vmap(one, in_dims=(st_dims, 0, _vmap_dims(draws)),
                           out_dims=(st_dims, 0))(st_in, imgs, draws)


def tracking_batched_body(cfg: VOConfig, cam: Camera, sts: S.VOState, imgs: torch.Tensor,
                          draws: BatchedDraws, *, height: int, width: int):
    """The vmapped body of :func:`step_tracking_batched`: per stream,
    tracking, then BA (``cfg.ba.enabled``) and the keyframe update computed
    unconditionally and applied where ``tracking_ok`` / ``is_keyframe``
    hold. No host branch and no readback. ``rng`` is left out (None in the
    returned state). Returns (states, StepOutputs), [B] leading."""
    return _vmapped(lambda st, img, d: _track_frame(cfg, cam, st, img, d, height=height,
                                                    width=width), sts, imgs, draws)


def general_batched_body(cfg: VOConfig, cam: Camera, sts: S.VOState, imgs: torch.Tensor,
                         draws: BatchedDraws, *, height: int, width: int):
    """The vmapped body of :func:`step_general_batched`: per stream, the
    frame's features once, then the first-frame branch, the init branch and
    the tracking branch (:func:`_track_frame`), each on the stream's state;
    its stage selects the state and StepOutput, as ``lax.switch`` does
    under ``jax.vmap``. No host branch and no readback. ``rng`` is left out
    (None in the returned state). Returns (states, StepOutputs), [B]
    leading."""

    def one(st, img, d):
        feats = features_from_config(img, cfg.orb)
        lg.mark("batch.features")
        s_first, o_first = step_first(cfg, cam, st, img, feats=feats)
        s_init, o_init = step_init(cfg, cam, st, img, u_e=d.init_e, u_h=d.init_h,
                                   G_e=d.init_G, feats=feats)
        lg.mark("batch.init")
        s_track, o_track = _track_frame(cfg, cam, st, img, d, height=height, width=width,
                                        feats=feats)
        lg.mark("batch.track")
        blank = st.stage == S.STAGE_BLANK
        init = st.stage == S.STAGE_INITIALIZING
        return (_tree_select(blank, s_first, _tree_select(init, s_init, s_track)),
                _tree_select(blank, o_first, _tree_select(init, o_init, o_track)))

    return _vmapped(one, sts, imgs, draws)


# ---------------------------------------------------------------------------
# captured programs: the single-stream stages and the batched bodies
# ---------------------------------------------------------------------------


# the stage programs' spans (utils/logging.py), in the order they run: each
# ends at the ``lg.mark`` of its name, the last one at the program's end
TRACK_SPANS = ("track.features", "track.match", "track.pnp", "track.ba", "track.keyframe")
INIT_SPANS = ("init.features", "init.match", "init.twoview", "init.gate")
GENERAL_SPANS = ("batch.features", "batch.init", "batch.track", "batch.select")
_STAGE_SPANS = {S.STAGE_INITIALIZING: INIT_SPANS, S.STAGE_TRACKING: TRACK_SPANS}


def _snapshot(record):
    """A copy of a record's tensors (None fields kept): a captured program's
    results stay valid only until its next call."""
    return tree_map(lambda t: None if t is None else t.clone(), record)


def _advance_key(key: int, stage: int, is_kf: bool) -> int:
    """A single stream's key after a frame in ``stage`` (:func:`_next_keys`)."""
    return int(_next_keys(torch.tensor([key], dtype=torch.int64), [stage], [int(is_kf)])[0])


def _stage_draws(cfg: VOConfig, stage: int, key: int, device) -> BatchedDraws:
    """One stream's draws for a frame in ``stage``, from its key as
    :func:`step` draws them (no batch dim; empty for a first frame)."""
    rng = torch.tensor([key], dtype=torch.int64)
    if stage == S.STAGE_BLANK:
        return BatchedDraws(None, None)
    d = (_draw_init if stage == S.STAGE_INITIALIZING else draw_batched)(cfg, rng, device)
    return BatchedDraws(*(None if t is None else t[0] for t in d))


class StagePrograms:
    """The single-stream step as three stage programs, each a
    :class:`~monocular_visual_odometry_tpu_torch.models.capture.CapturedStep`
    made at its first use: :func:`step_first`, :func:`step_init` and
    :func:`_track_frame`, each branch-free with its draws made on the host.
    On a card each is a CUDA graph, the five-point init's too (its ``eigh``
    takes its wait-free form there). ``mesh`` (a
    ``parallel.mesh.PointsMesh``): the tracking program runs the sharded BA,
    its collectives captured with it under NCCL and counted per replay in
    ``mesh.record``; gloo's collectives cannot be captured, so under gloo
    the tracking program runs eagerly on its buffers (``captured_stages``
    lists the stages that are graphs). The first-frame and init programs
    call no collective. While spans are on, the init and tracking programs
    are made with their spans (``INIT_SPANS``, ``TRACK_SPANS``).

    ``programs(st, img, stage, key)`` advances ``st`` (its key ``key`` and
    stage ``stage`` held on the host) by one frame: returns (new state
    without its key, StepOutput), both valid until the same stage's next
    frame. ``out.stage`` is the new state's stage in every program; the
    caller advances the key with ``out.is_keyframe`` (:func:`_advance_key`)."""

    def __init__(self, cfg: VOConfig, cam: Camera, height: int, width: int, device,
                 mesh=None):
        self.cfg, self.cam, self.height, self.width = cfg, cam, height, width
        self.device = torch.device(device)
        self.mesh = mesh
        uncaptured = () if mesh is None or mesh.backend == "nccl" else (S.STAGE_TRACKING,)
        self.captured_stages = tuple(
            s for s in (S.STAGE_BLANK, S.STAGE_INITIALIZING, S.STAGE_TRACKING)
            if self.device.type == "cuda" and s not in uncaptured)
        self.programs: dict[int, CapturedStep] = {}

    def _fn(self, stage: int):
        # the programs hold no reference to self: an engine's graphs are then
        # freed with it, not later by the cycle collector
        cfg, cam, height, width, mesh = self.cfg, self.cam, self.height, self.width, self.mesh
        if stage == S.STAGE_BLANK:
            return lambda st, img, d: step_first(cfg, cam, st, img)
        if stage == S.STAGE_INITIALIZING:
            return lambda st, img, d: step_init(cfg, cam, st, img, u_e=d.init_e, u_h=d.init_h,
                                                G_e=d.init_G)
        return lambda st, img, d: _track_frame(cfg, cam, st, img, d, height=height, width=width,
                                               mesh=mesh)

    def __call__(self, st: S.VOState, img: torch.Tensor, stage: int, key: int):
        prog = self.programs.get(stage)
        if prog is None:
            prog = self.programs[stage] = CapturedStep(
                self._fn(stage), graph=stage in self.captured_stages,
                mesh=self.mesh if stage == S.STAGE_TRACKING else None,
                spans=_STAGE_SPANS.get(stage, ()))
        with lg.span("engine.draws"):
            d = _stage_draws(self.cfg, stage, key, self.device)
        with lg.span("engine.launch"):
            return prog(st._replace(rng=None), img, d)


_BATCHED: dict = {}  # (kind, B, cfg, cam, H, W, device, spans on) -> CapturedStep


def release_batched() -> int:
    """Drops every captured batched program (JAX's ``jax.clear_caches()``):
    each holds its graph's memory pool for good, so a sweep over
    configurations or batch sizes releases the ones it is done with. The
    next batched step of a released key captures anew. Returns how many
    were dropped."""
    n = len(_BATCHED)
    _BATCHED.clear()
    return n


def _batched_program(kind: str, cfg: VOConfig, cam: Camera, b: int, height: int, width: int,
                     device) -> CapturedStep:
    """The batched body of ``kind`` ("tracking" or "general") as a
    ``CapturedStep`` whose last output is ``[stage before, is_keyframe]``
    [2,B] (the step's one readback); on a card a graph. While spans are on,
    the general body is made with its spans (``GENERAL_SPANS``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kind, b, cfg, cam, height, width, str(device), lg.spans_on())
    prog = _BATCHED.get(key)
    if prog is None:
        body = tracking_batched_body if kind == "tracking" else general_batched_body

        def fn(sts, imgs, draws):
            new, out = body(cfg, cam, sts, imgs, draws, height=height, width=width)
            return new, out, torch.stack([sts.stage, out.is_keyframe.to(sts.stage.dtype)])

        prog = _BATCHED[key] = CapturedStep(fn, spans=GENERAL_SPANS if kind == "general" else ())
    return prog


def _step_batched(kind, cfg, cam, sts, imgs, height, width, draws):
    """One batched step through its captured program: (states, StepOutputs),
    both valid until the program's next call."""
    imgs = _frames_on(imgs, sts.T_w_c.device).to(torch.float32)
    if draws is None:
        with lg.span("batch.draws"):
            draws = (draw_batched if kind == "tracking" else draw_general)(cfg, sts.rng,
                                                                           imgs.device)
    prog = _batched_program(kind, cfg, cam, imgs.shape[0], height, width, imgs.device)
    with lg.span("batch.launch"):
        new, out, flags = prog(sts._replace(rng=None), imgs, draws)
    with lg.span("batch.readback"):
        if prog.slots is None:
            flags = flags.cpu()
        else:
            flags, slots = _bytes_to_host([flags, prog.slots])
            lg.record_marks(prog.spans, slots)
    stage, is_kf = flags.tolist()
    if kind == "tracking" and any(s != S.STAGE_TRACKING for s in stage):
        raise ValueError("step_tracking_batched: every stream must be tracking "
                         f"(stage {S.STAGE_TRACKING}); stages {stage}")
    with lg.span("batch.keys"):
        return new._replace(rng=_next_keys(sts.rng, stage, is_kf)), out


def step_tracking_batched(cfg: VOConfig, cam: Camera, sts: S.VOState, imgs, *,
                          height: int, width: int, draws: Optional[BatchedDraws] = None):
    """B tracking streams (:func:`models.state.stack_states`) advance by one
    frame each, ``imgs`` [B,H,W]: every kernel of the step is issued once
    for all B streams, on a card as one replay of the captured
    :func:`tracking_batched_body`. Each stream's draws come from its key as
    in :func:`step` (``draws`` overrides them); one readback after the body
    (the step's only wait on the device) picks each stream's next key, the
    keyframe update's split kept only where ``is_keyframe``. Every stream
    must be in ``STAGE_TRACKING`` (checked in that readback): raises
    ValueError otherwise. Returns (states, StepOutputs), [B] leading."""
    return _snapshot(_step_batched("tracking", cfg, cam, sts, imgs, height, width, draws))


def step_general_batched(cfg: VOConfig, cam: Camera, sts: S.VOState, imgs, *,
                         height: int, width: int, draws: Optional[BatchedDraws] = None):
    """B streams in any stage (:func:`models.state.stack_states`) advance by
    one frame each, ``imgs`` [B,H,W], through :func:`general_batched_body`:
    every kernel of the step is launched once for all B streams, on a card as
    one replay of the captured body. Each stream's draws come from its key
    as in :func:`step` (:func:`draw_general`; ``draws`` overrides them); one
    readback after the body, of the stages before the step and
    ``is_keyframe``, picks each stream's next key. Returns (states,
    StepOutputs), [B] leading."""
    return _snapshot(_step_batched("general", cfg, cam, sts, imgs, height, width, draws))


def _run_batched(kind, cfg, cam, sts, frames, height, width):
    frames = _frames_on(frames, sts.T_w_c.device)
    n, outs = frames.shape[1], None
    for i in range(n):
        sts, out = _step_batched(kind, cfg, cam, sts, frames[:, i], height, width, None)
        if outs is None:
            outs = S.StepOutput(*(torch.empty((n,) + t.shape, dtype=t.dtype, device=t.device)
                                  for t in out))
        for o, t in zip(outs, out):
            o[i].copy_(t)
    return _snapshot(sts), outs


def run_sequences_batched(cfg: VOConfig, cam: Camera, sts: S.VOState, frames, *,
                          height: int, width: int):
    """:func:`step_tracking_batched` over [B,N,H,W] frame stacks (moved to the
    device once), each step's outputs written into a preallocated [N]
    output. Returns (final states, StepOutput with [N,B] leading on every
    field: scan-major, as the JAX function)."""
    return _run_batched("tracking", cfg, cam, sts, frames, height, width)


def run_sequences_general(cfg: VOConfig, cam: Camera, sts: S.VOState, frames, *,
                          height: int, width: int):
    """:func:`step_general_batched` over [B,N,H,W] frame stacks (moved to the
    device once), from states in any stage: from ``stack_states`` of fresh
    ``init_state``s this is JAX's ``vmap(run_sequence)`` from
    ``vmap(init_state)``. Returns (final states, StepOutput with [N,B]
    leading on every field)."""
    return _run_batched("general", cfg, cam, sts, frames, height, width)


# VOEngine's counters, by name
COUNTERS = ("frames.first", "frames.init", "frames.track", "inits.held", "keyframes",
            "tracking.failures", "ba.rejections", "candidates.overflows")
_FRAMES = {S.STAGE_BLANK: "frames.first", S.STAGE_INITIALIZING: "frames.init",
           S.STAGE_TRACKING: "frames.track"}


class VOEngine:
    """The host side: threads a VOState through the step one frame at a time
    and hands each frame's StepOutput back on the host.

    ``fused=True`` (JAX's ``add_frame`` -> ``step_fused``): the frame goes
    through the stage program of the stage the previous frame's readback
    reported (:class:`StagePrograms`); on a card that is one graph replay
    and one readback per frame, and ``captured_stages`` says which stages
    are graphs. ``fused=False`` takes JAX's staged debugging route instead
    (:meth:`_add_frame_staged`); both give the same poses. ``mesh`` (a
    ``parallel.mesh.PointsMesh``): the stage programs run the windowed BA
    sharded over the mesh's ranks (under NCCL its collectives are replayed
    with the tracking graph, under gloo that program runs eagerly); every
    rank drives its own engine over the same frames, and each picks its next
    program from its own readback, which is bitwise equal on every rank.
    ``cfg.orb.max_keypoints`` and ``cfg.map.max_map_points`` must divide by
    the mesh size, and the route must be the fused one (ValueError).

    ``state`` reads a copy of the engine's state on the fused route (the
    stage programs' buffers change with the next frame); setting it reads
    the new state's stage back once (and, for a tracking state, its BA
    rejections).

    ``counters`` (:data:`COUNTERS`, always kept): host integers counted from
    each frame's ``StepOutput`` as it comes back: frames per stage program
    (the init program's frames are the init attempts), inits that held,
    keyframes, tracking failures, BA trust-region rejections (the growth of
    ``ba_rejected_total``) and frames whose in-frustum candidates overflow
    ``cfg.map.track_candidates``. While spans are on (``utils/logging.py``)
    ``add_frame`` records the host spans ``engine.copy``, ``engine.draws``,
    ``engine.launch``, ``engine.readback`` and ``engine.finish``, and the
    device spans of the init and tracking programs come back with each
    frame's readback."""

    def __init__(self, cfg: VOConfig, height: int, width: int, seed: int = 0,
                 device="cuda", fused: bool = True, mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VOEngine: device 'cuda' requested but no CUDA device "
                               "is available (pass device='cpu' to run on the CPU)")
        if mesh is not None and not fused:
            raise ValueError("VOEngine: the mesh route needs the fused step (fused=True)")
        if mesh is not None:
            dist_ba.check_divides(mesh, cfg.orb.max_keypoints, cfg.map.max_map_points)
        self.fused = fused
        self.mesh = mesh
        self.cfg = cfg
        self.height = height
        self.width = width
        self.cam = Camera.create(cfg.dataset.fx, cfg.dataset.fy,
                                 cfg.dataset.cx, cfg.dataset.cy)
        self.stages = (StagePrograms(cfg, self.cam, height, width, self.device, mesh=mesh)
                       if fused else None)
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.state = S.init_state(cfg, seed, self.device)

    @property
    def captured_stages(self) -> tuple:
        """The stages whose frames are graph replays (none off the card)."""
        return () if self.stages is None else self.stages.captured_stages

    @property
    def state(self) -> S.VOState:
        return self._state if self.stages is None else _snapshot(self._state)

    @state.setter
    def state(self, st: S.VOState) -> None:
        self._state, self._stage = st, int(st.stage)
        # the baseline of the BA rejections: a first-frame or init program
        # leaves the count as it was, so its output gives it
        self._rejected = int(st.ba_rejected) if self._stage == S.STAGE_TRACKING else None

    def add_frame(self, img) -> S.StepOutput:
        """Process one grayscale image [H,W] (uint8 or float). Returns the
        StepOutput with every field on the CPU, read back with one wait."""
        with lg.span("engine.copy"):
            img = torch.as_tensor(np.asarray(img), dtype=torch.float32)
            # a pinned copy goes up without waiting on the stream
            img = img.pin_memory().to(self.device, non_blocking=True) \
                if self.device.type == "cuda" else img
        if not self.fused:
            stage = int(self._state.stage)
            out = self._add_frame_staged(img, stage)
            self._count(stage, out)
            return out
        stage, key = self._stage, int(self._state.rng)
        new, out = self.stages(self._state, img, stage, key)
        with lg.span("engine.readback"):
            prog = self.stages.programs[stage]
            if prog.slots is None:
                out = output_to_host(out)
            else:
                out, slots = output_to_host(out, prog.slots)
                lg.record_marks(prog.spans, slots)
        with lg.span("engine.finish"):
            key = _advance_key(key, stage, bool(out.is_keyframe))
            self._state = new._replace(rng=torch.tensor(key, dtype=torch.int64))
            self._stage = int(out.stage)
            self._count(stage, out)
        return out

    def _count(self, stage: int, out: S.StepOutput) -> None:
        """The counters after a frame run in ``stage`` (``out`` on the host)."""
        c = self.counters
        c[_FRAMES[stage]] += 1
        c["inits.held"] += stage == S.STAGE_INITIALIZING and int(out.stage) == S.STAGE_TRACKING
        c["keyframes"] += bool(out.is_keyframe)
        c["tracking.failures"] += not bool(out.tracking_ok)
        cap = self.cfg.map.track_candidates
        c["candidates.overflows"] += bool(cap) and int(out.n_candidates) > cap
        rejected = int(out.ba_rejected_total)
        if self._rejected is not None:
            c["ba.rejections"] += max(rejected - self._rejected, 0)
        self._rejected = rejected

    def _add_frame_staged(self, img: torch.Tensor, stage: int) -> S.StepOutput:
        """The staged route (JAX's ``_add_frame_staged``) for a frame in
        ``stage``: the stage entry points and ``ba_update_state`` one call
        after another. The tracking stage's output is read back (one wait)
        and decides BA and the keyframe update on the host; the pose, map
        count and BA rejections after them come back with one more."""
        cfg, cam = self.cfg, self.cam
        if stage == S.STAGE_BLANK:
            self._state, out = step_first(cfg, cam, self._state, img)
            return output_to_host(out)
        if stage == S.STAGE_INITIALIZING:
            self._state, out = step_init(cfg, cam, self._state, img)
            return output_to_host(out)
        self._state, out, feats, curr_mp = step_track(cfg, cam, self._state, img,
                                                      height=self.height, width=self.width)
        out = output_to_host(out)
        if cfg.ba.enabled and bool(out.tracking_ok):
            self._state = ba.ba_update_state(cfg, cam, self._state)
        if bool(out.is_keyframe):
            self._state = keyframe_update(cfg, cam, self._state, feats, curr_mp,
                                          height=self.height, width=self.width)
        st = self._state
        return output_to_host(out._replace(T_w_c=st.T_w_c, n_map_points=st.map.n_valid,
                                           ba_rejected_total=st.ba_rejected))


def output_to_host(out: S.StepOutput, slots: Optional[torch.Tensor] = None):
    """``out`` with every field on the CPU, same dtypes, shapes and values,
    read back with one wait (:func:`_bytes_to_host`; a ``.cpu()`` per field
    would wait once per field). CPU fields are returned as they are. With
    ``slots`` (a marked program's slot buffer) they come back in the same
    copy, and the result is ``(out, slots)``."""
    fields = list(out) if slots is None else [*out, slots]
    on_card = [t for t in fields if t.is_cuda]
    if not on_card:
        return out if slots is None else (out, slots)
    back = iter(_bytes_to_host(on_card))
    fields = [next(back) if t.is_cuda else t for t in fields]
    if slots is None:
        return S.StepOutput(*fields)
    return S.StepOutput(*fields[:-1]), fields[-1]


def _bytes_to_host(tensors: list) -> list:
    """``tensors`` (on one device) on the CPU with one copy: their bytes
    packed there into one uint8 tensor, copied once, and split on the host
    into views of their dtypes and shapes. The segments go in order of
    decreasing element size (powers of two), so each starts at a multiple of
    its own element size and every view back is aligned."""
    order = sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())
    host = torch.cat([tensors[i].reshape(-1).view(torch.uint8) for i in order]).cpu()
    out, at = [None] * len(tensors), 0
    for i in order:
        t = tensors[i]
        n = t.numel() * t.element_size()
        out[i] = host[at:at + n].view(t.dtype).reshape(t.shape)
        at += n
    return out
