"""The sharded BA's work and communication account.

Port of ``monocular_visual_odometry_tpu.parallel.scaling``. The JAX module
compiles the sharded solver on virtual CPU meshes of several sizes in one
process and reads per-device FLOPs from XLA's cost analysis and the
collectives from the compiled HLO. Here a mesh size is a number of
processes, so :func:`measure` and :func:`measure_comm` account for the mesh
this process belongs to:

- per-rank FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which
  counts matmul-class operations only (the einsums' and products' ``mm`` /
  ``bmm``; not the solves, inverses or elementwise work);
- the collectives from the mesh's record (``mesh.PointsMesh.record``),
  priced by :func:`collective_inventory` with the ring factors the JAX
  module applies to the HLO;
- wall time per solve by CUDA events on a card (and the host clock), or
  the host clock on the CPU, beside the single-device ``ba_solve`` in turns;
  device kernels per solve from ``torch.profiler`` on a card.

Ranks that share one card, or CPU cores, share their compute: the times
are not a scaling signal, as the JAX module says of its virtual mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.models import ba as BA
from monocular_visual_odometry_tpu_torch.ops.camera import Camera
from monocular_visual_odometry_tpu_torch.parallel import dist_ba
from monocular_visual_odometry_tpu_torch.parallel.mesh import Collective, PointsMesh
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

NOT_A_SCALING_SIGNAL = ("ranks that share one card (or CPU cores) share its compute: "
                        "not a scaling signal on one card")


def make_problem(W: int = 5, K: int = 1024, M: int = 4096, seed: int = 0, device="cuda"):
    """A realistic windowed-BA problem: M landmarks in a slab, W cameras on
    a short baseline, every frame observing K points with 0.5 px noise. The
    same numpy draws as the JAX module, so the arrays are equal to its."""
    rng = np.random.default_rng(seed)
    cam = Camera.create(615.0, 615.0, 320.0, 240.0)
    pts = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                    rng.uniform(3, 9, M)], axis=1).astype(np.float32)
    T_c_w = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for w in range(W):
        T_c_w[w, 0, 3] = -0.06 * w
        T_c_w[w, 1, 3] = 0.02 * np.sin(w)
    obs_pid = rng.integers(0, M, size=(W, K)).astype(np.int32)
    p = (np.einsum("wij,wkj->wki", T_c_w[:, :3, :3], pts[obs_pid])
         + T_c_w[:, None, :3, 3])
    uv = p[..., :2] / p[..., 2:3] * 615.0 + np.asarray([320.0, 240.0])
    uv += rng.normal(0, 0.5, uv.shape)
    pt_used = np.zeros(M, bool)
    pt_used[np.unique(obs_pid)] = True
    # perturb the initial state so the solver does real work
    pts_init = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prob = BA.BAProblem(
        T_c_w=t(T_c_w), obs_uv=t(uv.astype(np.float32)), obs_pid=t(obs_pid),
        obs_valid=t(np.ones((W, K), bool)), pts=t(pts_init.astype(np.float32)),
        pt_used=t(pt_used), frame_valid=t(np.ones(W, bool)))
    return prob, cam


def collective_inventory(record: list[Collective], n: int) -> dict:
    """The collectives of a mesh's record priced with the JAX module's ring
    factors, per rank: all-reduce (psum) of B result bytes 2B(n-1)/n,
    all-gather producing B bytes B(n-1)/n, reduce-scatter (psum_scatter) to
    a B-byte block B(n-1). ``by_op`` sums the priced bytes per primitive,
    ``result_by_op`` the result bytes (which stay non-zero at n = 1)."""
    factors = {"psum": lambda b: 2.0 * b * (n - 1) / n,
               "all_gather": lambda b: b * (n - 1) / n,
               "psum_scatter": lambda b: b * (n - 1)}
    ops, by_op, result_by_op = [], {}, {}
    for c in record:
        moved = factors[c.op](c.result_bytes)
        ops.append({"op": c.op, "result_bytes": c.result_bytes,
                    "bytes_moved_per_device": round(moved, 1)})
        by_op[c.op] = by_op.get(c.op, 0.0) + moved
        result_by_op[c.op] = result_by_op.get(c.op, 0) + c.result_bytes
    return {"n_collectives": len(ops), "ops": ops, "by_op": by_op,
            "result_by_op": result_by_op}


def comm_model(W: int = 5, K: int = 1024, M: int = 4096, n: int = 8) -> dict:
    """Analytic per-LM-iteration interconnect bytes per rank for the
    dist_ba partition (observation columns and landmark blocks sharded over
    n ranks), with the ring factors above. Copied from the JAX module."""
    f_ar = 2.0 * (n - 1) / n
    f_ag = (n - 1) / n
    f_rs_full = (n - 1) / n          # applied to the FULL pre-scatter size
    joint = {
        # the updated landmark pool: all-gather [M,3] f32
        "all_gather_pts": 12 * M * f_ag,
        # psum cost scalar + H_cc [W,6,6] + g_c [W,6]
        "psum_cost_Hg": (4 + 144 * W + 24 * W) * f_ar,
        # psum_scatter A [M,3,3], b [M,3], U [W,M,6,3] (full sizes)
        "psum_scatter_A_b_U": (36 * M + 12 * M + 72 * W * M) * f_rs_full,
        # psum S_off [W,W,6,6] + g_corr [W,6]
        "psum_schur": (144 * W * W + 24 * W) * f_ar,
    }
    joint["total_per_iteration"] = sum(joint.values())
    fix = {
        # the landmarks never change: the pool is gathered once, and per
        # iteration only the camera Gram psums remain
        "psum_cost_Hg": (4 + 144 * W + 24 * W) * f_ar,
        "all_gather_pts_once": 12 * M * f_ag,
    }
    fix["total_per_iteration"] = fix["psum_cost_Hg"]
    return {"mesh": n, "window": W, "obs_per_frame": K, "landmarks": M,
            "joint_mode_bytes": {k: round(v, 1) for k, v in joint.items()},
            "fix_points_bytes": {k: round(v, 1) for k, v in fix.items()}}


def model_by_op(model: dict, joint: bool) -> dict:
    """``comm_model``'s terms of one LM iteration summed per JAX primitive,
    as ``collective_inventory``'s ``by_op`` sums a record."""
    if joint:
        b = model["joint_mode_bytes"]
        return {"psum": b["psum_cost_Hg"] + b["psum_schur"], "all_gather": b["all_gather_pts"],
                "psum_scatter": b["psum_scatter_A_b_U"]}
    return {"psum": model["fix_points_bytes"]["psum_cost_Hg"], "all_gather": 0.0,
            "psum_scatter": 0.0}


def model_result_bytes(W: int, M: int, n: int, joint: bool) -> dict:
    """The result bytes per rank of one LM iteration's collectives, per JAX
    primitive: the sizes :func:`comm_model` prices (f32), which its ring
    factors zero out at n = 1."""
    if joint:
        return {"psum": 4 + 168 * W + 144 * W * W + 24 * W, "all_gather": 12 * M,
                "psum_scatter": (48 * M + 72 * W * M) // n}
    return {"psum": 4 + 168 * W, "all_gather": 0, "psum_scatter": 0}


def one_iteration(mesh: PointsMesh, cfg: VOConfig, cam: Camera, prob: BA.BAProblem) -> dict:
    """One LM iteration's collectives, measured: the records of a solve of
    ``cfg.ba.iterations`` and of one more iteration, priced by
    :func:`collective_inventory`; their difference per primitive (the
    schedule of an iteration is fixed while the re-gate is off)."""
    invs = []
    for it in (cfg.ba.iterations, cfg.ba.iterations + 1):
        c = cfg.replace(ba=dataclasses.replace(cfg.ba, iterations=it))
        mesh.record.clear()
        dist_ba.dist_ba_solve(c, cam, mesh, prob)
        invs.append(collective_inventory(list(mesh.record), mesh.size))
    a, b = invs
    diff = lambda key: {k: b[key].get(k, 0.0) - a[key].get(k, 0.0)
                        for k in set(a[key]) | set(b[key])}
    return {"collectives": b["n_collectives"] - a["n_collectives"], "by_op": diff("by_op"),
            "result_by_op": diff("result_by_op")}


def live_cfg(W: int = 5, iterations: int = 20) -> VOConfig:
    """The default config with the live shape's BA: joint, window W."""
    cfg = VOConfig()
    return cfg.replace(ba=dataclasses.replace(cfg.ba, fix_map_points=False, window=W,
                                              iterations=iterations))


def _device_kernels(fn) -> tuple[int, float]:
    """(device kernels, device busy ms) of one call of ``fn`` on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ks), sum(e.time_range.elapsed_us() for e in ks) / 1e3


def measure(mesh: PointsMesh, W=5, K=1024, M=4096, iterations=20, turns=4, reps=3,
            device="cuda") -> dict:
    """The sharded LM at the live shape (joint) on ``mesh``, beside the
    single-device ``ba_solve`` in the same process, in turns (dist, single,
    single, dist, ...): this rank's matmul-class FLOPs per solve, ms per
    solve (the median over ``turns`` of ``reps`` solves; by CUDA events and
    the host clock on a card, the host clock on the CPU), device kernels and
    busy ms per solve (on a card), and how far the two solutions part."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = live_cfg(W, iterations)
    prob, cam = make_problem(W=W, K=K, M=M, device=device)
    calls = {"dist": lambda: dist_ba.dist_ba_solve(cfg, cam, mesh, prob),
             "single": lambda: BA.ba_solve(cfg, cam, prob)}
    sol = {name: [t.cpu().numpy() for t in fn()] for name, fn in calls.items()}  # warm too
    with FlopCounterMode(display=False) as fc:
        calls["dist"]()
    on_card = torch.device(device).type == "cuda"
    ms = {name: ([], []) for name in calls}                  # (CUDA events, host clock)
    for turn in range(turns):
        for name in list(calls)[::1 if turn % 2 == 0 else -1]:
            if on_card:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[name]()
            if on_card:
                end.record()
                torch.cuda.synchronize()
                ms[name][0].append(start.elapsed_time(end) / reps)
            ms[name][1].append(1e3 * (time.perf_counter() - t0) / reps)
    kernels = {name: _device_kernels(fn) if on_card else None for name, fn in calls.items()}
    (T_d, p_d, c_d), (T_s, p_s, c_s) = sol["dist"], sol["single"]
    used = prob.pt_used.cpu().numpy()
    return {
        "problem": {"window": W, "obs_per_frame": K, "landmarks": M,
                    "lm_iterations": iterations, "mode": "joint"},
        "mesh": mesh.size, "rank": mesh.rank, "backend": mesh.backend,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "matmul_flops_per_rank": int(fc.get_total_flops()),
        "ms_per_solve_cuda_events": ({k: float(np.median(v[0])) for k, v in ms.items()}
                                     if on_card else None),
        "ms_per_solve_host": {k: float(np.median(v[1])) for k, v in ms.items()},
        "turns": {k: v[0] if on_card else v[1] for k, v in ms.items()},
        "kernels_per_solve": {k: v[0] for k, v in kernels.items()} if on_card else None,
        "device_busy_ms_per_solve": {k: v[1] for k, v in kernels.items()} if on_card else None,
        "pose_err": float(np.abs(T_d - T_s).max()),
        "point_err": float(np.abs(p_d[used] - p_s[used]).max()),
        "final_cost_rel": float(abs(c_d[-1] - c_s[-1]) / abs(c_s[-1])),
        "note": ("matmul_flops_per_rank counts matmul-class operations only "
                 "(torch.utils.flop_counter); " + NOT_A_SCALING_SIGNAL),
    }


def measure_comm(mesh: PointsMesh, W=5, K=1024, M=4096, iterations=20,
                 device="cuda") -> dict:
    """The communication account at the live shape on ``mesh``: the model
    (:func:`comm_model`) beside one LM iteration's measured record
    (:func:`one_iteration`), and this rank's matmul FLOPs per iteration."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = live_cfg(W, iterations)
    prob, cam = make_problem(W=W, K=K, M=M, device=device)
    model = comm_model(W=W, K=K, M=M, n=mesh.size)
    it = one_iteration(mesh, cfg, cam, prob)
    flops = []
    for n_it in (1, 2):
        c = cfg.replace(ba=dataclasses.replace(cfg.ba, iterations=n_it))
        with FlopCounterMode(display=False) as fc:
            dist_ba.dist_ba_solve(c, cam, mesh, prob)
        flops.append(fc.get_total_flops())
    flops_it = flops[1] - flops[0]
    bytes_it = model["joint_mode_bytes"]["total_per_iteration"]
    return {
        "problem": model, "mesh": mesh.size, "backend": mesh.backend,
        "bytes_per_rank_per_iteration_model": bytes_it,
        "measured_per_iteration": it,
        "model_by_op": model_by_op(model, joint=True),
        "model_result_bytes": model_result_bytes(W, M, mesh.size, joint=True),
        "matmul_flops_per_rank_per_iteration": int(flops_it),
        "comm_intensity_bytes_per_matmul_flop": bytes_it / flops_it if flops_it else None,
        "note": "FLOPs count matmul-class operations only; " + NOT_A_SCALING_SIGNAL,
    }


def main(argv: Optional[list] = None) -> int:
    """``python -m monocular_visual_odometry_tpu_torch.parallel.scaling``:
    :func:`measure` and :func:`measure_comm` on the world of
    ``parallel.mesh.init_distributed`` (its ``MVO_*`` variables; without a
    coordinator, a world of this one process over a file store in
    ``--store``), printed as one JSON object by rank 0."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=str(Path(__file__).resolve().parents[2] / "build"
                                           / "scaling_store"),
                    help="file store of the one-process world (removed first)")
    ap.add_argument("--iterations", type=int, default=20)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("scaling: device 'cuda' requested but no CUDA device is available "
              "(pass --device cpu --backend gloo)", file=sys.stderr)
        return 1
    if os.environ.get("MVO_COORDINATOR"):
        PM.init_distributed(backend=args.backend)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(args.store)), exist_ok=True)
        if os.path.exists(args.store):
            os.remove(args.store)
        PM.init_distributed(f"file://{os.path.abspath(args.store)}", 1, 0, backend=args.backend)
    mesh = PM.points_mesh()
    out = {"flops_partition": measure(mesh, iterations=args.iterations, device=args.device),
           "communication": measure_comm(mesh, iterations=args.iterations, device=args.device)}
    if mesh.rank == 0:
        print(json.dumps(out, indent=2))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
