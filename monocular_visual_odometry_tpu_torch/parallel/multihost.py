"""Multi-process distributed BA: N processes, one rank each, over
``torch.distributed``.

Port of ``monocular_visual_odometry_tpu.parallel.multihost``. Every process
builds the SAME seeded problem (``scaling.make_problem``), takes its own
observation columns and landmark block, runs the sharded LM
(``parallel.dist_ba``), gathers the landmark blocks, and checks the result
against the single-device ``models.ba.ba_solve`` run locally; process 0
writes the JSON report (the JAX module's keys).

Run one process per rank, each with the same rendezvous (``host:port``, a
``tcp://`` URL, or a ``file://`` path no earlier run left behind):

    python -m monocular_visual_odometry_tpu_torch.parallel.multihost \\
        --process-id 0 --num-processes 2 --coordinator file:///tmp/mh_store \\
        --report /tmp/mh_report.json
    python -m monocular_visual_odometry_tpu_torch.parallel.multihost \\
        --process-id 1 --num-processes 2 --coordinator file:///tmp/mh_store

``--backend gloo`` (the default) runs on CPU or CUDA tensors; two ranks may
share one card that way. ``--backend nccl`` needs one card per rank.
``--device`` defaults to ``cuda``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", required=True,
                    help="host:port, tcp://host:port or file:///path (one per run)")
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="a process drives one device; only 1 is accepted")
    ap.add_argument("--report", default=None, help="JSON report path (written by process 0)")
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--obs-per-frame", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=15)
    ap.add_argument("--deterministic", action="store_true",
                    help="float64 sums (cfg.ba.deterministic): the distributed and the "
                         "single-device LM follow the same accept/reject path")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="seconds a collective may wait before it fails")
    args = ap.parse_args(argv)
    if args.devices_per_process != 1:
        ap.error("--devices-per-process: a process drives one device (1)")
    return args


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch
    import torch.distributed as dist

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("multihost: device 'cuda' requested but no CUDA device is available "
              "(pass --device cpu)", file=sys.stderr)
        return 1
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba
    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM
    from monocular_visual_odometry_tpu_torch.parallel.scaling import make_problem
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    PM.init_distributed(args.coordinator, args.num_processes, args.process_id,
                        backend=args.backend, timeout_s=args.timeout)
    if dist.get_world_size() != args.num_processes:
        raise RuntimeError(f"world of {dist.get_world_size()}, expected {args.num_processes}")
    mesh = PM.points_mesh()

    cfg = VOConfig()
    cfg = cfg.replace(ba=dataclasses.replace(
        cfg.ba, fix_map_points=False, window=5, iterations=args.iterations,
        deterministic=args.deterministic))
    # every process builds the identical seeded problem
    prob, cam = make_problem(W=5, K=args.obs_per_frame, M=args.landmarks, device=args.device)

    # single-device reference, local to each process
    T_ref, pts_ref, c_ref = (t.cpu().numpy() for t in BA.ba_solve(cfg, cam, prob))

    # this process's columns and landmark block, solved sharded
    T_d, p_shard, c_d = dist_ba.dist_lm(cfg, cam, mesh, dist_ba.local_problem(mesh, prob))
    pts_d = mesh.all_gather(p_shard, 0)
    T_d_np, c_d_np, pts_d_np = (t.cpu().numpy() for t in (T_d, c_d, pts_d))

    used = prob.pt_used.cpu().numpy()
    pose_err = float(np.abs(T_d_np - T_ref).max())
    pt_err = float(np.abs(pts_d_np[used] - pts_ref[used]).max())

    # both solutions priced by one evaluator: the robust cost on the full
    # local problem (the solvers' own final costs sit at the noise floor)
    info = BA._info_matrix(cfg.ba, torch.float32, prob.pts.device)

    def robust_cost(T, pts):
        T = torch.from_numpy(T).to(prob.pts.device)
        pts = torch.from_numpy(pts).to(prob.pts.device)
        r = BA._residuals(T, pts, prob.obs_uv, prob.obs_pid.to(torch.int64), cam)[0]
        w = BA._robust_weights(r, prob.obs_valid, info, cfg.ba.huber_delta)
        return float(torch.sum(w * BA._weighted_sq(r, info))
                     / torch.clamp(torch.sum(prob.obs_valid), min=1))

    cost_rel = float(abs(c_d_np[-1] - c_ref[-1]) / max(abs(c_ref[-1]), 1e-12))
    report = {
        "num_processes": dist.get_world_size(),
        "devices_per_process": 1,
        "global_devices": mesh.size,
        "backend": torch.device(args.device).type,
        "collectives": mesh.backend,
        "collective_ops": sorted({c.op for c in mesh.record}),
        "device": (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                   else "cpu"),
        "problem": {"window": 5, "obs_per_frame": args.obs_per_frame,
                    "landmarks": args.landmarks, "lm_iterations": args.iterations,
                    "mode": "joint", "deterministic": bool(args.deterministic)},
        "pose_err_vs_single_device": pose_err,
        "point_err_vs_single_device": pt_err,
        "cost_of_single_solution": robust_cost(T_ref, pts_ref),
        "cost_of_distributed_solution": robust_cost(T_d_np, pts_d_np),
        "final_cost_rel_err": cost_rel,
        "final_cost_single": float(c_ref[-1]),
        "final_cost_distributed": float(c_d_np[-1]),
    }
    print(f"[proc {args.process_id}] {json.dumps(report)}", flush=True)
    if args.process_id == 0 and args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
