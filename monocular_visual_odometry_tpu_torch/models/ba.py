"""Sliding-window bundle adjustment with per-point Schur complement.

Port of ``monocular_visual_odometry_tpu.models.ba``: the same window
selection, residuals, analytic Jacobians, IRLS Huber weights, LM with a
fixed iteration count, chi2 re-gate, Schur elimination of the landmark
blocks and trust-region write-back.

The JAX LM is one ``lax.scan`` whose accept/reject, damping and cost are
selects. Here it is a Python loop of ``cfg.ba.iterations`` steps over the
same selects: nothing in :func:`ba_update_state` reads a device value on the
host, so on a card the whole update is queued without waiting on the stream.
That is why the solves are the ``*_ex`` variants with ``check_errors=False``
(the checked ones read LAPACK's ``info`` back), why no tensor is built from
host data inside it (an H2D copy of pageable memory synchronises), and why
a 0-d index tensor never indexes (PyTorch reads it back as an integer).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_visual_odometry_tpu_torch.models import state as S
from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops import precision  # noqa: F401  (TF32 off)
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem extracted from VO state."""

    T_c_w: torch.Tensor      # [W,4,4] camera-from-world per window frame
    obs_uv: torch.Tensor     # [W,K,2] observed pixels
    obs_pid: torch.Tensor    # [W,K] int32 map-point index (clipped, see mask)
    obs_valid: torch.Tensor  # [W,K] bool
    pts: torch.Tensor        # [M,3] landmark positions
    pt_used: torch.Tensor    # [M] bool, observed by some window frame
    frame_valid: torch.Tensor  # [W] bool


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without reading it back."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _used(pid: torch.Tensor, valid: torch.Tensor, m: int) -> torch.Tensor:
    """[m] bool: some valid observation links the point (scatter-OR)."""
    hits = torch.zeros(m, dtype=torch.int32, device=pid.device)
    return hits.index_add_(0, pid.reshape(-1).to(torch.int64),
                           valid.reshape(-1).to(torch.int32)) > 0


def gather_window(cfg: VOConfig, st: S.VOState,
                  cam: Camera | None = None) -> tuple[BAProblem, torch.Tensor]:
    """Extract the BA window from the ring buffer; also returns the ring
    slots [W] for write-back (newest first).

    ``cfg.ba.keyframe_window`` False: the last ``window`` frames. True: the
    current frame and the newest ``window``-1 keyframe slots. With ``cam``
    and ``cfg.ba.obs_gate_px`` > 0, observations whose residual at the
    tracked poses exceeds the gate, or whose landmark is behind the camera,
    are masked out (see the JAX module for why)."""
    W = cfg.ba.window
    F = cfg.map.frame_buffer
    dev = st.T_w_c.device
    M = st.map.valid.shape[0]
    if cfg.ba.keyframe_window:
        last = st.frame_idx.to(torch.int64) - 1               # current frame id
        slot_ids = torch.arange(F, device=dev)
        fid = last - torch.remainder(last - slot_ids, F)      # frame id per slot
        cur_slot = torch.remainder(last, F)
        eligible = (st.ring.occupied & st.ring.is_kf & (fid >= 0)
                    & (slot_ids != cur_slot))
        # jnp.argsort is stable; reversed, ties come in descending slot order
        order = torch.argsort(torch.where(eligible, fid, torch.full_like(fid, -1)),
                              stable=True).flip(0)
        kf_slots = order[: W - 1]
        slots = torch.cat([cur_slot.reshape(1), kf_slots])
        frame_valid = torch.cat([st.ring.occupied[slots[:1]] & (last >= 0),
                                 eligible[kf_slots]])
    else:
        frame_ids = st.frame_idx.to(torch.int64) - 1 - torch.arange(W, device=dev)
        slots = torch.remainder(frame_ids, F)
        frame_valid = (frame_ids >= 0) & st.ring.occupied[slots]

    T_c_w = lie.inv_T(st.ring.poses[slots])                   # [W,4,4]
    obs_uv = st.ring.kpts[slots]                              # [W,K,2]
    pid = st.ring.mp_idx[slots]                               # [W,K]
    pid_safe = torch.clamp(pid, 0, M - 1)
    valid = frame_valid[:, None] & (pid >= 0) & st.map.valid[pid_safe.to(torch.int64)]
    if cam is not None and cfg.ba.obs_gate_px > 0:
        X = st.map.pts[pid_safe.to(torch.int64)]              # [W,K,3]
        p = torch.einsum("wij,wkj->wki", T_c_w[:, :3, :3], X) + T_c_w[:, None, :3, 3]
        z = torch.clamp(p[..., 2], min=1e-6)
        u = p[..., 0] / z * cam.fx + cam.cx
        v = p[..., 1] / z * cam.fy + cam.cy
        err2 = (u - obs_uv[..., 0]) ** 2 + (v - obs_uv[..., 1]) ** 2
        valid = valid & (p[..., 2] > 0) & (err2 < cfg.ba.obs_gate_px * cfg.ba.obs_gate_px)
    return (
        BAProblem(T_c_w=T_c_w, obs_uv=obs_uv, obs_pid=pid_safe, obs_valid=valid,
                  pts=st.map.pts, pt_used=_used(pid_safe, valid, M),
                  frame_valid=frame_valid),
        slots,
    )


def _residuals(T_c_w, pts, obs_uv, obs_pid, cam: Camera):
    """Reprojection residuals [W,K,2], with the camera-frame points [W,K,3]
    and their inverse depths [W,K]."""
    X = pts[obs_pid]                                          # [W,K,3]
    p = torch.einsum("wij,wkj->wki", T_c_w[:, :3, :3], X) + T_c_w[:, None, :3, 3]
    inv_z = 1.0 / torch.clamp(p[..., 2], min=1e-6)
    u = p[..., 0] * inv_z * cam.fx + cam.cx
    v = p[..., 1] * inv_z * cam.fy + cam.cy
    return torch.stack([u - obs_uv[..., 0], v - obs_uv[..., 1]], dim=-1), p, inv_z


def _residuals_and_jacobians(T_c_w, pts, obs_uv, obs_pid, cam: Camera):
    """Residuals [W,K,2], pose Jacobians [W,K,2,6], point Jacobians
    [W,K,2,3]. Left-multiplicative se(3) perturbation on T_c_w, as in
    ops.pnp. (XLA drops the Jacobians where only the residuals are used;
    eager PyTorch would compute them, so the cost pass calls
    :func:`_residuals`.)"""
    r, p, inv_z = _residuals(T_c_w, pts, obs_uv, obs_pid, cam)
    zero = torch.zeros_like(inv_z)
    du_dp = torch.stack([cam.fx * inv_z, zero, -cam.fx * p[..., 0] * inv_z**2], dim=-1)
    dv_dp = torch.stack([zero, cam.fy * inv_z, -cam.fy * p[..., 1] * inv_z**2], dim=-1)
    J_proj = torch.stack([du_dp, dv_dp], dim=-2)              # [W,K,2,3]

    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape + (3,))
    dp_dxi = torch.cat([eye, -lie.hat(p)], dim=-1)            # [W,K,3,6]
    return r, J_proj @ dp_dxi, J_proj @ T_c_w[:, None, :3, :3]


def _weighted_sq(r: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Information-weighted squared residual per observation."""
    return (r[..., 0] ** 2 * info[0, 0] + r[..., 1] ** 2 * info[1, 1]
            + 2.0 * r[..., 0] * r[..., 1] * info[0, 1])


def _robust_weights(r: torch.Tensor, valid: torch.Tensor, info: torch.Tensor,
                    huber: float) -> torch.Tensor:
    """IRLS scalar weight per observation: Huber on the information-weighted
    residual norm, 0 where invalid."""
    e = torch.sqrt(torch.clamp(_weighted_sq(r, info), min=1e-12))
    w = torch.where(e <= huber, torch.ones_like(e), huber / e)
    return torch.where(valid, w, torch.zeros_like(w))


def _info_matrix(cfg: VOConfig, dtype, device) -> torch.Tensor:
    """The 2x2 information matrix on ``device``, filled in place (a copy
    from host memory would synchronise the stream)."""
    info = torch.empty(4, dtype=dtype, device=device)
    for i, v in enumerate(cfg.ba.information_matrix):
        info[i].fill_(v)
    return info.reshape(2, 2)


def ba_solve(cfg: VOConfig, cam: Camera, prob: BAProblem):
    """Run the windowed LM; returns (new T_c_w [W,4,4], new pts [M,3], the
    accepted cost per valid observation after each iteration
    [iterations]), all float32.

    ``cfg.ba.fix_map_points`` keeps the landmarks fixed and the camera
    system block-diagonal; otherwise the landmark blocks are eliminated per
    point (Schur complement), the two oldest valid frames anchor the gauge,
    and the landmarks are recovered by back-substitution. With
    ``cfg.ba.regate_px`` > 0 the observations whose residual at the current
    iterate exceeds the gate are dropped entering iteration
    ``iterations // 2``. ``cfg.ba.deterministic`` runs every reduction in
    float64."""
    W = cfg.ba.window
    M = prob.pts.shape[0]
    dtype = torch.float64 if cfg.ba.deterministic else torch.float32
    dev = prob.pts.device
    T0 = prob.T_c_w.to(dtype)
    pts0 = prob.pts.to(dtype)
    obs_uv = prob.obs_uv.to(dtype)
    obs_pid = prob.obs_pid.to(torch.int64)
    flat_pid = obs_pid.reshape(-1)
    info = _info_matrix(cfg, dtype, dev)
    huber = cfg.ba.huber_delta
    fix_points = cfg.ba.fix_map_points
    regate = cfg.ba.regate_px > 0 and cfg.ba.iterations >= 2
    n1 = cfg.ba.iterations // 2          # the re-gate fires entering iteration n1
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def cost_fn(T_c_w, pts, valid):
        r = _residuals(T_c_w, pts, obs_uv, obs_pid, cam)[0]
        return torch.sum(_robust_weights(r, valid, info, huber) * _weighted_sq(r, info))

    # frames that must not move: out-of-window slots and, in joint mode, the
    # two oldest valid frames (the similarity-gauge anchor)
    fixed = ~prob.frame_valid
    if not fix_points:
        rev_valid = prob.frame_valid.flip(0).to(torch.int32)
        oldest = W - 1 - torch.argmax(rev_valid)   # first max, as jnp.argmax
        rev_valid = torch.where(torch.arange(W, device=dev) == W - 1 - oldest,
                                torch.zeros_like(rev_valid), rev_valid)
        second = W - 1 - torch.argmax(rev_valid)
        frames = torch.arange(W, device=dev)
        fixed = fixed | (frames == oldest) | (frames == second)
        diag = torch.arange(W, device=dev)
        wk_idx = (diag[:, None] * M + obs_pid).reshape(-1)   # flat (frame, point)
    stiff = (fixed.to(dtype) * 1e8)[:, None, None] * eye6

    T_c_w, pts = T0, pts0
    valid, pt_used = prob.obs_valid, prob.pt_used
    lam = torch.full((), cfg.ba.init_lambda, dtype=dtype, device=dev)
    cost_old = cost_fn(T_c_w, pts, valid)
    costs = []
    for i in range(cfg.ba.iterations):
        r, J_c, J_p = _residuals_and_jacobians(T_c_w, pts, obs_uv, obs_pid, cam)
        if regate and i == n1:
            # chi2 re-gate at the current iterate (ORB-SLAM's two-stage
            # local BA); a frame left under 3 links keeps its mask
            err2 = r[..., 0] ** 2 + r[..., 1] ** 2
            z = (torch.einsum("wij,wkj->wki", T_c_w[:, :3, :3], pts[obs_pid])
                 + T_c_w[:, None, :3, 3])[..., 2]
            gate2 = torch.full((), cfg.ba.regate_px * cfg.ba.regate_px, dtype=dtype,
                               device=dev)
            if cfg.ba.regate_sigma_mult > 0:
                flat = torch.sort(torch.where(valid, err2,
                                              torch.full_like(err2, float("inf"))).reshape(-1)).values
                nv = torch.sum(valid)
                med2 = _take(flat, torch.clamp(torch.div(nv - 1, 2, rounding_mode="floor"),
                                               min=0))
                med2 = torch.where(torch.isfinite(med2), med2, torch.zeros_like(med2))
                gate2 = torch.maximum(gate2, cfg.ba.regate_sigma_mult ** 2 * med2)
            keep = valid & (z > 0) & (err2 < gate2)
            enough = torch.sum(keep, dim=1) >= 3
            valid = torch.where(enough[:, None], keep, valid)
            if not fix_points:
                pt_used = _used(obs_pid, valid, M)
            # re-base the accepted cost on the new mask at the current state
            cost_old = torch.sum(_robust_weights(r, valid, info, huber) * _weighted_sq(r, info))
        n_obs = torch.clamp(torch.sum(valid), min=1)
        w = _robust_weights(r, valid, info, huber)

        # per-observation weighted blocks; info folded into the 2-axis
        Wr2 = torch.einsum("ab,wkb->wka", info, r) * w[..., None]        # [W,K,2]
        JcW = torch.einsum("wkai,ab->wkbi", J_c, info) * w[..., None, None]
        H_cc = torch.einsum("wkai,wkaj->wij", JcW, J_c) + stiff          # [W,6,6]
        g_c = torch.einsum("wkai,wka->wi", J_c, Wr2)                     # [W,6]
        g_c = torch.where(fixed[:, None], torch.zeros_like(g_c), g_c)

        if fix_points:
            delta_c = -torch.linalg.solve_ex(H_cc + lam * eye6, g_c[..., None],
                                             check_errors=False).result[..., 0]
            delta_p = torch.zeros_like(pts)
        else:
            JpW = torch.einsum("wkai,ab->wkbi", J_p, info) * w[..., None, None]
            Hpp_obs = torch.einsum("wkai,wkaj->wkij", JpW, J_p).reshape(-1, 3, 3)
            gp_obs = torch.einsum("wkai,wka->wki", J_p, Wr2).reshape(-1, 3)
            # scatter-adds are atomics on a card: f32 sums vary in the last
            # bits from run to run (cfg.ba.deterministic runs them in f64)
            A = torch.zeros((M, 3, 3), dtype=dtype, device=dev).index_add_(0, flat_pid, Hpp_obs)
            b_p = torch.zeros((M, 3), dtype=dtype, device=dev).index_add_(0, flat_pid, gp_obs)
            # damping with a relative Tikhonov floor (see the JAX module)
            dmax = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).amax(-1), min=1e-12)
            A = A + (lam + 1e-2 * dmax)[:, None, None] * eye3
            A = torch.where(pt_used[:, None, None], A, eye3.expand(A.shape))
            A_inv = torch.linalg.inv_ex(A, check_errors=False).inverse        # [M,3,3]

            # camera-point coupling U[w,p] = sum_k Jc^T W Jp
            U_obs = torch.einsum("wkai,wkaj->wkij", JcW, J_p).reshape(-1, 6, 3)
            U = torch.zeros((W * M, 6, 3), dtype=dtype, device=dev).index_add_(
                0, wk_idx, U_obs).reshape(W, M, 6, 3)

            # reduced camera system S = H_cc - U A^-1 U^T (coupled blocks)
            UAinv = torch.einsum("wpij,pjk->wpik", U, A_inv)              # [W,M,6,3]
            S_ = -torch.einsum("wpik,vplk->wvil", UAinv, U)               # [W,W,6,6]
            S_[diag, diag] = S_[diag, diag] + H_cc + lam * eye6
            g_red = g_c - torch.einsum("wpik,pk->wi", UAinv, b_p)         # [W,6]
            S_full = S_.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
            delta_c = -torch.linalg.solve_ex(S_full, g_red.reshape(-1, 1),
                                             check_errors=False).result.reshape(W, 6)
            # zero the gauge-fixed frames BEFORE back-substitution, so the
            # landmark update matches the camera update actually applied
            delta_c = torch.where(fixed[:, None], torch.zeros_like(delta_c), delta_c)
            rhs = b_p + torch.einsum("wpij,wi->pj", U, delta_c)
            delta_p = -torch.einsum("pij,pj->pi", A_inv, rhs)
            delta_p = torch.where(pt_used[:, None], delta_p, torch.zeros_like(delta_p))

        delta_c = torch.where(fixed[:, None], torch.zeros_like(delta_c), delta_c)
        T_new = lie.se3_exp(delta_c) @ T_c_w
        pts_new = pts + delta_p

        cost_new = cost_fn(T_new, pts_new, valid)
        accept = cost_new < cost_old
        T_c_w = torch.where(accept, T_new, T_c_w)
        pts = torch.where(accept, pts_new, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        # the accepted state's cost: monotone within each round
        cost_old = torch.where(accept, cost_new, cost_old)
        costs.append(cost_old / n_obs)
    costs = torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev)
    return T_c_w.float(), pts.float(), costs.float()


def write_back(cfg: VOConfig, st: S.VOState, prob: BAProblem, slots: torch.Tensor,
               T_c_w: torch.Tensor, pts: torch.Tensor) -> S.VOState:
    """Write a solved window back: poses into the ring (and the current
    pose, and the reference keyframe's if it still lives in the ring),
    landmark positions into the map.

    Trust region (``cfg.ba.max_pose_correction`` > 0): if the solve moved
    the current frame's pose further than that from its tracked value, the
    state is returned unchanged but for ``ba_rejected``, counted up."""
    F = cfg.map.frame_buffer
    poses_w_c = lie.inv_T(T_c_w)                                   # [W,4,4]
    upd = torch.where(prob.frame_valid[:, None, None], poses_w_c, st.ring.poses[slots])
    # With too few keyframes the window repeats the current slot, and XLA's
    # scatter lets the last write win; a duplicate index_put_ has no order
    # on a card, so every entry whose slot recurs later goes to scratch row F.
    dup_later = torch.triu(slots[:, None] == slots[None, :], diagonal=1).any(dim=1)
    target = torch.where(dup_later, torch.full_like(slots, F), slots)
    ring_poses = torch.cat([st.ring.poses, st.ring.poses[:1]])
    ring_poses[target] = upd
    ring_poses = ring_poses[:F]
    map_pts = torch.where((prob.pt_used & st.map.valid)[:, None], pts, st.map.pts)
    T_curr = torch.where(prob.frame_valid[0], poses_w_c[0], st.T_w_c)

    # re-sync the reference keyframe pose if it still lives in the ring
    ref_age = st.frame_idx - st.ref_frame_idx
    ref_fresh = (ref_age >= 1) & (ref_age <= F)
    ref_pose = torch.where(ref_fresh, _take(ring_poses, torch.remainder(st.ref_frame_idx, F)),
                           st.ref_pose)
    kf_pose = torch.where(ref_fresh, ref_pose, st.last_keyframe_pose)

    ba_rejected = st.ba_rejected
    if cfg.ba.max_pose_correction > 0:
        # select only the fields written above: the rest are unchanged, and
        # the CPU-side rng stays out of it
        ok = lie.pose_distance(T_curr, st.T_w_c) <= cfg.ba.max_pose_correction
        T_curr = torch.where(ok, T_curr, st.T_w_c)
        ring_poses = torch.where(ok, ring_poses, st.ring.poses)
        map_pts = torch.where(ok, map_pts, st.map.pts)
        ref_pose = torch.where(ok, ref_pose, st.ref_pose)
        kf_pose = torch.where(ok, kf_pose, st.last_keyframe_pose)
        ba_rejected = ba_rejected + (~ok).to(torch.int32)
    return st._replace(
        T_w_c=T_curr,
        ring=st.ring._replace(poses=ring_poses),
        map=st.map._replace(pts=map_pts),
        ref_pose=ref_pose,
        last_keyframe_pose=kf_pose,
        ba_rejected=ba_rejected,
    )


def ba_update_state(cfg: VOConfig, cam: Camera, st: S.VOState) -> S.VOState:
    """Full BA step on the VO state: gather the window, solve, write back."""
    prob, slots = gather_window(cfg, st, cam)
    T_c_w, pts, _ = ba_solve(cfg, cam, prob)
    ba_update_state.calls += 1
    return write_back(cfg, st, prob, slots, T_c_w, pts)


ba_update_state.calls = 0  # calls since the last reset
