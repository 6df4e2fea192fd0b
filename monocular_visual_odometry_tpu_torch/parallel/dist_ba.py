"""Sliding-window BA sharded over the ranks of a ``points`` mesh.

Port of ``monocular_visual_odometry_tpu.parallel.dist_ba``. Both big axes
of the problem are split over the mesh, as in the JAX module:

- the observation grid [W, K] in contiguous blocks of K/D columns, so the
  residuals, Jacobians, robust weights, the camera Gram sums and the cost
  are computed on 1/D of the observations per rank;
- the landmarks in contiguous blocks of M/D: each rank scatter-adds its
  observations' point blocks into full [M]-indexed buffers, one
  ``psum_scatter`` leaves each rank the complete sums of its own block, and
  the 3x3 elimination and the back-substitution run on that block only;
- the reduced camera system is ``psum``'d and the dense [6W, 6W] solve runs
  on every rank.

With the landmarks fixed (``cfg.ba.fix_map_points``, the default) only the
camera Gram and the cost are summed over the mesh, and the landmark pool is
gathered once before the loop.

JAX runs the body under ``shard_map``; here every rank runs
:func:`dist_lm` on its own shard and calls the mesh's collectives where JAX
calls its primitives. Each LM iteration calls, in order: one ``psum`` of
the camera Gram and gradient; in joint mode one ``psum_scatter`` of the
point blocks (A, b and the camera-point coupling U packed into one [M, .]
buffer) and one ``psum`` of the Schur terms; one ``all_gather`` of the
updated landmark blocks (joint mode); one ``psum`` of the cost. These are
the terms of ``scaling.comm_model``. The re-gate (``cfg.ba.regate_px``)
adds its own at the iteration where it fires.

The accept test compares a ``psum``'d cost, bitwise equal on every rank, so
every rank takes the same accept/reject path and the replicated poses stay
bitwise equal. The body mirrors the port's ``models/ba.py::ba_solve``: no
value is read back on the host inside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_visual_odometry_tpu_torch.models import ba as BA
from monocular_visual_odometry_tpu_torch.models import state as S
from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.parallel.mesh import PointsMesh
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig


class LocalProblem(NamedTuple):
    """One rank's shard of a :class:`models.ba.BAProblem`."""

    T_c_w: torch.Tensor        # [W,4,4] replicated
    obs_uv: torch.Tensor       # [W,K/D,2] this rank's observation columns
    obs_pid: torch.Tensor      # [W,K/D] global landmark ids
    obs_valid: torch.Tensor    # [W,K/D]
    pts: torch.Tensor          # [M/D,3] this rank's landmark block
    pt_used: torch.Tensor      # [M/D]
    frame_valid: torch.Tensor  # [W] replicated


def check_divides(mesh: PointsMesh, K: int, M: int) -> None:
    """ValueError unless the observation capacity K and the landmark pool M
    split evenly over the mesh."""
    if K % mesh.size or M % mesh.size:
        raise ValueError(f"dist_ba: K={K} observations per frame and M={M} landmarks must "
                         f"both divide by the mesh size {mesh.size}")


def local_problem(mesh: PointsMesh, prob: BA.BAProblem) -> LocalProblem:
    """This rank's shard of a full problem: its columns of the observation
    grid and its block of the landmarks."""
    check_divides(mesh, prob.obs_pid.shape[1], prob.pts.shape[0])
    return LocalProblem(
        T_c_w=prob.T_c_w, obs_uv=mesh.local(prob.obs_uv, 1), obs_pid=mesh.local(prob.obs_pid, 1),
        obs_valid=mesh.local(prob.obs_valid, 1), pts=mesh.local(prob.pts, 0),
        pt_used=mesh.local(prob.pt_used, 0), frame_valid=prob.frame_valid)


def dist_lm(cfg: VOConfig, cam: Camera, mesh: PointsMesh, lp: LocalProblem):
    """The LM on this rank's shard. Returns (T_c_w [W,4,4] replicated, this
    rank's landmark block [M/D,3], the accepted cost per valid observation
    after each iteration [iterations], replicated), all float32."""
    W = cfg.ba.window
    M_loc = lp.pts.shape[0]
    M = M_loc * mesh.size
    dtype = torch.float64 if cfg.ba.deterministic else torch.float32
    dev = lp.pts.device
    obs_uv = lp.obs_uv.to(dtype)
    obs_pid = lp.obs_pid.to(torch.int64)
    flat_pid = obs_pid.reshape(-1)
    info = BA._info_matrix(cfg.ba, dtype, dev)
    huber = cfg.ba.huber_delta
    fix_points = cfg.ba.fix_map_points
    regate = cfg.ba.regate_px > 0 and cfg.ba.iterations >= 2
    n1 = cfg.ba.iterations // 2          # the re-gate fires entering iteration n1
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def local_cost(T_c_w, pts_full, valid):
        r = BA._residuals(T_c_w, pts_full, obs_uv, obs_pid, cam)[0]
        return torch.sum(BA._robust_weights(r, valid, info, huber) * BA._weighted_sq(r, info))

    def count(valid):
        return mesh.psum(torch.sum(valid, dtype=torch.int64))

    # frames that must not move (as models/ba.py): out-of-window slots and,
    # in joint mode, the two oldest valid frames
    frame_valid = lp.frame_valid
    fixed = ~frame_valid
    if not fix_points:
        rev_valid = frame_valid.flip(0).to(torch.int32)
        oldest = W - 1 - torch.argmax(rev_valid)
        rev_valid = torch.where(torch.arange(W, device=dev) == W - 1 - oldest,
                                torch.zeros_like(rev_valid), rev_valid)
        second = W - 1 - torch.argmax(rev_valid)
        frames = torch.arange(W, device=dev)
        fixed = fixed | (frames == oldest) | (frames == second)
        diag = torch.arange(W, device=dev)
        wk_idx = (diag[:, None] * M + obs_pid).reshape(-1)   # flat (frame, point)
    stiff = (fixed.to(dtype) * 1e8)[:, None, None] * eye6

    T_c_w = lp.T_c_w.to(dtype)
    p_shard = lp.pts.to(dtype)
    # obs_pid is global: the residuals need the whole pool, gathered once
    # here and, in joint mode, once per iteration after the update
    pts = mesh.all_gather(p_shard, 0)
    valid, pt_used = lp.obs_valid, lp.pt_used
    lam = torch.full((), cfg.ba.init_lambda, dtype=dtype, device=dev)
    cost_old = mesh.psum(local_cost(T_c_w, pts, valid))
    n_obs = torch.clamp(count(valid), min=1)
    costs = []
    for i in range(cfg.ba.iterations):
        r, J_c, J_p = BA._residuals_and_jacobians(T_c_w, pts, obs_uv, obs_pid, cam)
        if regate and i == n1:
            # chi2 re-gate at the current iterate; every statistic of the mask
            # is reduced over the mesh, so every rank applies the same gate
            err2 = r[..., 0] ** 2 + r[..., 1] ** 2
            z = (torch.einsum("wij,wkj->wki", T_c_w[:, :3, :3], pts[obs_pid])
                 + T_c_w[:, None, :3, 3])[..., 2]
            gate2 = torch.full((), cfg.ba.regate_px * cfg.ba.regate_px, dtype=dtype, device=dev)
            if cfg.ba.regate_sigma_mult > 0:
                # the median of the GLOBAL residual set
                err2_full = mesh.all_gather(
                    torch.where(valid, err2, torch.full_like(err2, float("inf"))), 1)
                flat = torch.sort(err2_full.reshape(-1)).values
                nv = count(valid)
                med2 = BA._take(flat, torch.clamp(torch.div(nv - 1, 2, rounding_mode="floor"),
                                                  min=0))
                med2 = torch.where(torch.isfinite(med2), med2, torch.zeros_like(med2))
                gate2 = torch.maximum(gate2, cfg.ba.regate_sigma_mult ** 2 * med2)
            keep = valid & (z > 0) & (err2 < gate2)
            # never gate a frame below the reference's >=3-links rule
            enough = mesh.psum(torch.sum(keep, dim=1, dtype=torch.int64)) >= 3
            valid = torch.where(enough[:, None], keep, valid)
            if not fix_points:
                pt_used = mesh.psum_scatter(
                    BA._used(obs_pid, valid, M).to(torch.int64), 0) > 0
            # re-base the accepted cost on the new mask at the current state
            cost_old = mesh.psum(torch.sum(BA._robust_weights(r, valid, info, huber)
                                           * BA._weighted_sq(r, info)))
            n_obs = torch.clamp(count(valid), min=1)
        w = BA._robust_weights(r, valid, info, huber)

        Wr2 = torch.einsum("ab,wkb->wka", info, r) * w[..., None]        # [W,K/D,2]
        JcW = torch.einsum("wkai,ab->wkbi", J_c, info) * w[..., None, None]
        # camera Gram and gradient: partial sums over this rank's columns,
        # summed over the mesh in one collective
        Hg = mesh.psum(torch.cat([torch.einsum("wkai,wkaj->wij", JcW, J_c).reshape(W, 36),
                                  torch.einsum("wkai,wka->wi", J_c, Wr2)], dim=1))
        H_cc = Hg[:, :36].reshape(W, 6, 6) + stiff
        g_c = torch.where(fixed[:, None], torch.zeros_like(Hg[:, 36:]), Hg[:, 36:])

        if fix_points:
            delta_c = -torch.linalg.solve_ex(H_cc + lam * eye6, g_c[..., None],
                                             check_errors=False).result[..., 0]
            delta_p = torch.zeros_like(p_shard)
        else:
            JpW = torch.einsum("wkai,ab->wkbi", J_p, info) * w[..., None, None]
            Hpp_obs = torch.einsum("wkai,wkaj->wkij", JpW, J_p).reshape(-1, 9)
            gp_obs = torch.einsum("wkai,wka->wki", J_p, Wr2).reshape(-1, 3)
            U_obs = torch.einsum("wkai,wkaj->wkij", JcW, J_p).reshape(-1, 18)
            # this rank's contributions in full [M]-indexed buffers (invalid
            # observations carry w=0), then one psum_scatter: each rank gets
            # the complete sums of its own block. A [M,9] | b [M,3] | U
            # [M, W*18] side by side, so the scatter runs along M.
            A_part = torch.zeros((M, 9), dtype=dtype, device=dev).index_add(0, flat_pid, Hpp_obs)
            b_part = torch.zeros((M, 3), dtype=dtype, device=dev).index_add(0, flat_pid, gp_obs)
            U_part = torch.zeros((W * M, 18), dtype=dtype, device=dev).index_add(0, wk_idx, U_obs)
            packed = mesh.psum_scatter(torch.cat(
                [A_part, b_part, U_part.reshape(W, M, 18).permute(1, 0, 2).reshape(M, W * 18)],
                dim=1), 0)                                                # [M/D, 12+18W]
            A = packed[:, :9].reshape(M_loc, 3, 3)
            b_p = packed[:, 9:12]
            U = packed[:, 12:].reshape(M_loc, W, 6, 3).permute(1, 0, 2, 3)  # [W,M/D,6,3]

            # damping with the relative Tikhonov floor of models/ba.py
            dmax = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).amax(-1), min=1e-12)
            A = A + (lam + 1e-2 * dmax)[:, None, None] * eye3
            A = torch.where(pt_used[:, None, None], A, eye3.expand(A.shape))
            A_inv = torch.linalg.inv_ex(A, check_errors=False).inverse        # [M/D,3,3]

            # this block's part of the Schur complement, summed over the mesh
            UAinv = torch.einsum("wpij,pjk->wpik", U, A_inv)                 # [W,M/D,6,3]
            schur = mesh.psum(torch.cat(
                [torch.einsum("wpik,vplk->wvil", UAinv, U).reshape(-1),
                 torch.einsum("wpik,pk->wi", UAinv, b_p).reshape(-1)]))
            S_ = -schur[:W * W * 36].reshape(W, W, 6, 6)
            S_[diag, diag] = S_[diag, diag] + H_cc + lam * eye6
            g_red = g_c - schur[W * W * 36:].reshape(W, 6)
            S_full = S_.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
            delta_c = -torch.linalg.solve_ex(S_full, g_red.reshape(-1, 1),
                                             check_errors=False).result.reshape(W, 6)
            delta_c = torch.where(fixed[:, None], torch.zeros_like(delta_c), delta_c)
            rhs = b_p + torch.einsum("wpij,wi->pj", U, delta_c)
            delta_p = -torch.einsum("pij,pj->pi", A_inv, rhs)
            delta_p = torch.where(pt_used[:, None], delta_p, torch.zeros_like(delta_p))

        delta_c = torch.where(fixed[:, None], torch.zeros_like(delta_c), delta_c)
        T_new = lie.se3_exp(delta_c) @ T_c_w
        if fix_points:
            p_new, pts_new = p_shard, pts
        else:
            p_new = p_shard + delta_p
            pts_new = mesh.all_gather(p_new, 0)
        cost_new = mesh.psum(local_cost(T_new, pts_new, valid))
        accept = cost_new < cost_old
        T_c_w = torch.where(accept, T_new, T_c_w)
        if not fix_points:
            p_shard = torch.where(accept, p_new, p_shard)
            pts = torch.where(accept, pts_new, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost_old = torch.where(accept, cost_new, cost_old)
        costs.append(cost_old / n_obs)
    costs = torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev)
    return T_c_w.float(), p_shard.float(), costs.float()


def dist_ba_solve(cfg: VOConfig, cam: Camera, mesh: PointsMesh, prob: BA.BAProblem):
    """The sharded LM on a full problem that every rank holds: each rank
    solves its shard, and the landmark blocks are gathered back. Returns
    (T_c_w [W,4,4], pts [M,3], costs [iterations]), float32, the same on
    every rank. K and M must divide by the mesh size (ValueError)."""
    T_c_w, p_shard, costs = dist_lm(cfg, cam, mesh, local_problem(mesh, prob))
    if cfg.ba.fix_map_points:
        return T_c_w, prob.pts.float(), costs
    return T_c_w, mesh.all_gather(p_shard, 0), costs


def make_dist_ba(cfg: VOConfig, cam: Camera, mesh: PointsMesh):
    """solve(prob) -> (T_c_w, pts, costs): :func:`dist_ba_solve` bound to
    ``cfg``, ``cam`` and ``mesh``."""

    def solve(prob: BA.BAProblem):
        return dist_ba_solve(cfg, cam, mesh, prob)

    return solve


def ba_update_state_dist(cfg: VOConfig, cam: Camera, mesh: PointsMesh,
                         st: S.VOState) -> S.VOState:
    """The sharded counterpart of ``models.ba.ba_update_state``: gather the
    window from the state (every rank holds it whole), solve sharded, write
    back. The mesh route of ``models.vo.step`` calls it."""
    prob, slots = BA.gather_window(cfg, st, cam)
    T_c_w, pts, _ = dist_ba_solve(cfg, cam, mesh, prob)
    ba_update_state_dist.calls += 1
    return BA.write_back(cfg, st, prob, slots, T_c_w, pts)


ba_update_state_dist.calls = 0  # calls since the last reset
