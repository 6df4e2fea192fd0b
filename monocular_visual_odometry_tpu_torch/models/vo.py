"""The VO pipeline: per-frame stages, windowed bundle adjustment and the
host-side engine.

Port of ``monocular_visual_odometry_tpu.models.vo``. The JAX package runs
the whole frame as one jitted call and selects between branches with
masked selects (``lax.switch`` / ``lax.cond`` / ``_tree_select``). PyTorch
runs eagerly, so here the stage dispatch, the init quality gate, the BA
gate on ``tracking_ok`` and the keyframe decision are host branches on
values read back from the device; each branch computes what the selected
side of the JAX select computes. A tracking frame runs tracking, then
(``cfg.ba.enabled`` and tracking held) ``models/ba.py::ba_update_state``,
then the keyframe update, which sees the corrected pose.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.models import ba
from monocular_visual_odometry_tpu_torch.models import state as S
from monocular_visual_odometry_tpu_torch.ops import lie, matching, pnp, twoview
from monocular_visual_odometry_tpu_torch.ops.camera import Camera, cam2pixel, in_frame
from monocular_visual_odometry_tpu_torch.ops.features import FrameFeatures, features_from_config
from monocular_visual_odometry_tpu_torch.ops.ransac import split_key
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

_DEG = math.pi / 180.0


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median (lower middle) over masked entries; inf if none."""
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, float("inf")))).values
    n = torch.sum(mask)
    return s[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)]


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
    out[tgt] = torch.arange(m, device=mask.device)  # duplicates only at the scratch slot
    return out[:capacity]


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


def _eye4(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _next_key(st: S.VOState):
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


def _step_first_impl(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor):
    dev = img.device
    feats = features_from_config(img, cfg.orb)
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
    true = torch.tensor(True, device=dev)
    out = S.StepOutput(
        T_w_c=eye, stage=new.stage, n_keypoints=feats.n_valid,
        n_matches=_i32(0, dev), n_inliers=_i32(0, dev),
        is_keyframe=true, tracking_ok=true,
        used_homography=torch.tensor(False, device=dev), n_map_points=new.map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid,
        kpt_inlier=torch.zeros(k, dtype=torch.bool, device=dev),
        ba_rejected_total=st.ba_rejected, n_candidates=_i32(0, dev),
    )
    return new, out


# ---------------------------------------------------------------------------
# stage: initialization attempt
# ---------------------------------------------------------------------------


def _step_init_impl(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor):
    dev = img.device
    feats = features_from_config(img, cfg.orb)
    rng, k_est = _next_key(st)
    ref = st.ref_feats

    m = _match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts,
               feats.kpts, cfg.match.max_pixel_dist_init)
    uv1 = ref.kpts[m.query_idx]
    uv2 = feats.kpts[m.train_idx]

    tv = twoview.estimate_relative_pose(
        uv1, uv2, m.valid, cam, k_est,
        threshold_px=cfg.ransac.threshold_px,
        n_hypotheses=cfg.ransac.n_hypotheses,
        use_reference_selection=cfg.init.use_reference_selection,
        essential_minimal=cfg.ransac.essential_minimal,
    )
    T_2_1 = lie.rt_to_T(tv.R, tv.t)
    angles = twoview.triangulation_angles(tv.pts3d_c1, T_2_1)
    good = _angle_filter(angles, tv.inliers, cfg)

    n_good = torch.sum(good)
    mean_disp = matching.mean_pixel_displacement(ref.kpts, feats.kpts,
                                                 m._replace(valid=good))
    med_angle = _masked_median(angles, good)
    is_good = bool(
        (n_good >= cfg.init.min_inlier_matches)
        & (mean_disp > cfg.init.min_pixel_dist)
        & (med_angle > cfg.init.min_median_triang_angle_deg * _DEG))

    k = cfg.orb.max_keypoints
    no_links = torch.full((k,), -1, dtype=torch.int32, device=dev)
    if is_good:
        # depth normalization: mean depth in the current frame -> assumed
        pts_c2 = lie.transform_points(T_2_1, tv.pts3d_c1)
        mean_depth = (torch.sum(torch.where(good, pts_c2[:, 2], torch.zeros_like(angles)))
                      / torch.clamp(n_good, min=1))
        scale = cfg.init.assumed_mean_depth / torch.clamp(mean_depth, min=1e-6)
        T_w_c2 = st.ref_pose @ lie.inv_T(lie.rt_to_T(tv.R, tv.t * scale))
        pts_w = lie.transform_points(st.ref_pose, tv.pts3d_c1 * scale)
        new_map, slots = S.insert_map_points(
            st.map, pts_w, feats.desc[m.train_idx],
            _unit_normals(pts_w, T_w_c2[:3, 3]), good, frame_idx=st.frame_idx,
            gray=feats.gray[m.train_idx])
        curr_mp = scatter_links(no_links, m.train_idx,
                                torch.where(good, slots, torch.full_like(slots, -1)))
        pose_out = T_w_c2
        new = st._replace(
            stage=_i32(S.STAGE_TRACKING, dev), T_w_c=T_w_c2, ref_feats=feats,
            ref_pose=T_w_c2, ref_mp_idx=curr_mp, ref_frame_idx=st.frame_idx,
            last_keyframe_pose=T_w_c2, map=new_map)
        new = S.push_keyframe(new, T_w_c2)
        kpt_inlier = scatter_links(torch.zeros(k, dtype=torch.bool, device=dev),
                                   m.train_idx, good)
    else:
        curr_mp = no_links
        pose_out = st.ref_pose
        new = st._replace(T_w_c=st.ref_pose)
        kpt_inlier = torch.zeros(k, dtype=torch.bool, device=dev)

    ring = st.ring.push(st.frame_idx % cfg.map.frame_buffer, pose_out,
                        feats.kpts, curr_mp, is_kf=is_good)
    new = new._replace(frame_idx=st.frame_idx + 1, ring=ring, rng=rng)
    out = S.StepOutput(
        T_w_c=pose_out, stage=new.stage, n_keypoints=feats.n_valid,
        n_matches=m.n_valid, n_inliers=n_good.to(torch.int32),
        is_keyframe=torch.tensor(is_good, device=dev),
        tracking_ok=torch.tensor(True, device=dev),
        used_homography=tv.used_homography, n_map_points=new.map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid, kpt_inlier=kpt_inlier,
        ba_rejected_total=st.ba_rejected, n_candidates=_i32(0, dev),
    )
    return new, out


# ---------------------------------------------------------------------------
# stage: tracking (PnP against the local map)
# ---------------------------------------------------------------------------


def _step_track_impl(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor,
                     *, height: int, width: int):
    dev = img.device
    feats = features_from_config(img, cfg.orb)
    rng, k_pnp = _next_key(st)

    # frustum scan with the constant-velocity prediction; with the union
    # gate also the stale pose. Asymmetric on purpose (as in the JAX
    # package): the stale projection is pushed to 1e9 when it is out of
    # frame, the predicted one only when it is behind the camera.
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
        cand_desc = st.map.desc[comp_safe]
        cand_proj = proj[comp_safe]
        cand_pts = st.map.pts[comp_safe]
        cand_proj_alt = proj_s[comp_safe] if use_union else None
    else:
        comp_idx = comp_safe = torch.arange(M, device=dev)
        comp_ok = candidates
        cand_desc, cand_proj, cand_pts = st.map.desc, proj, st.map.pts
        cand_proj_alt = proj_s if use_union else None

    m = _match(cfg, cand_desc, feats.desc, comp_ok, feats.valid, cand_proj,
               feats.kpts, cfg.match.max_pixel_dist_pnp, kpts1_alt=cand_proj_alt)
    uv = feats.kpts[m.train_idx]

    res = pnp.solve_pnp_ransac(
        cand_pts, uv, m.valid, cam, k_pnp,
        threshold_px=cfg.ransac.pnp_reproj_threshold_px,
        n_hypotheses=cfg.ransac.pnp_n_hypotheses,
        min_inliers=cfg.ransac.pnp_min_inliers,
    )
    T_w_c_new = lie.inv_T(res.T_c_w)

    # pose-jump rejection and pose freeze on failure
    jump = lie.pose_distance(T_w_c_new, st.T_w_c) > cfg.tracking.max_dist_to_prev_keyframe
    ok = res.ok & ~jump
    pose = torch.where(ok, T_w_c_new, st.T_w_c)

    inl_ok = res.inliers & ok
    matched_add = torch.zeros(M, dtype=torch.int32, device=dev).index_add_(
        0, comp_safe, (inl_ok & comp_ok).to(torch.int32))
    new_map = st.map._replace(visible=visible, matched=st.map.matched + matched_add)
    k = cfg.orb.max_keypoints
    map_slot = comp_idx[m.query_idx].to(torch.int32)
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
        used_homography=torch.tensor(False, device=dev), n_map_points=new_map.n_valid,
        kpts=feats.kpts, kpt_valid=feats.valid, kpt_inlier=kpt_inlier,
        ba_rejected_total=st.ba_rejected,
        n_candidates=torch.sum(candidates.to(torch.int32)),
    )
    return new, out, feats, curr_mp


# ---------------------------------------------------------------------------
# keyframe update: triangulate new points, cull, switch reference
# ---------------------------------------------------------------------------


def _keyframe_update_impl(cfg: VOConfig, cam: Camera, st: S.VOState,
                          feats: FrameFeatures, curr_mp: torch.Tensor,
                          *, height: int, width: int) -> S.VOState:
    """Match against the reference keyframe, epipolar-filter, triangulate
    with the tracked poses, angle-filter, insert with link reuse, cull the
    map and make the current frame the new reference."""
    rng, k_epi = _next_key(st)
    ref = st.ref_feats

    m = _match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts,
               feats.kpts, cfg.match.max_pixel_dist_triang)
    uv1 = ref.kpts[m.query_idx]
    uv2 = feats.kpts[m.train_idx]

    if cfg.ransac.keyframe_use_ransac_filter:
        inl = twoview.find_inlier_matches_by_epipolar(
            uv1, uv2, m.valid, cam, k_epi, threshold_px=cfg.ransac.threshold_px,
            n_hypotheses=cfg.ransac.n_hypotheses // 2)
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
    mp_idx = st.ring.mp_idx.clone()
    mp_idx[slot] = curr_mp
    new = st._replace(
        ref_feats=feats, ref_pose=st.T_w_c, ref_mp_idx=curr_mp,
        ref_frame_idx=st.frame_idx - 1, last_keyframe_pose=st.T_w_c,
        map=new_map, ring=st.ring._replace(mp_idx=mp_idx),
        erase_ratio=erase_ratio, rng=rng,
    )
    return S.push_keyframe(new, st.T_w_c)


# ---------------------------------------------------------------------------
# per-frame step and engine
# ---------------------------------------------------------------------------


def step(cfg: VOConfig, cam: Camera, st: S.VOState, img: torch.Tensor,
         *, height: int, width: int):
    """One frame through the stage its state is in (the counterpart of the
    JAX ``step_fused`` on one device). Returns (new state, StepOutput)."""
    stage = int(st.stage)
    if stage == S.STAGE_BLANK:
        return _step_first_impl(cfg, cam, st, img)
    if stage == S.STAGE_INITIALIZING:
        return _step_init_impl(cfg, cam, st, img)
    new, out, feats, curr_mp = _step_track_impl(cfg, cam, st, img,
                                                height=height, width=width)
    if cfg.ba.enabled and bool(out.tracking_ok):
        new = ba.ba_update_state(cfg, cam, new)
    if bool(out.is_keyframe):
        new = _keyframe_update_impl(cfg, cam, new, feats, curr_mp,
                                    height=height, width=width)
    return new, out._replace(T_w_c=new.T_w_c, n_map_points=new.map.n_valid,
                             ba_rejected_total=new.ba_rejected)


class VOEngine:
    """Host driver: threads a VOState through :func:`step`, one frame at a
    time, and hands each frame's StepOutput back on the host."""

    def __init__(self, cfg: VOConfig, height: int, width: int, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VOEngine: device 'cuda' requested but no CUDA device "
                               "is available (pass device='cpu' to run on the CPU)")
        self.cfg = cfg
        self.height = height
        self.width = width
        self.cam = Camera.create(cfg.dataset.fx, cfg.dataset.fy,
                                 cfg.dataset.cx, cfg.dataset.cy)
        self.state = S.init_state(cfg, seed, self.device)

    def add_frame(self, img) -> S.StepOutput:
        """Process one grayscale image [H,W] (uint8 or float). Returns the
        StepOutput with every field on the CPU."""
        img = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(self.device)
        self.state, out = step(self.cfg, self.cam, self.state, img,
                               height=self.height, width=self.width)
        return S.StepOutput(*(t.cpu() for t in out))
