"""Worker processes for the port's ``parallel`` tests (gloo on the CPU).

A test writes its inputs to an ``.npz`` (arrays, and a JSON string under
``"spec"``), starts D ranks of one job with :func:`launch`, and reads each
rank's ``rank<r>.npz`` back. Each rank runs with one torch thread and joins
the world over a ``FileStore`` in the test's temporary directory, so no port
is taken and concurrent test processes cannot meet.

Jobs (``python tests/torch_dist_worker.py JOB RANK WORLD DIR``):

- ``ba``        ``dist_ba_solve`` on each case of the spec (a problem and its
                BA settings); per case the solution and the collective record
- ``mesh``      the three collectives on the spec's arrays, ``points_mesh``
                subsets, DTensor placements
- ``timeout``   rank 1 skips a collective: rank 0 must raise within the
                timeout, that of a group made for the job (the world's is the default)
- ``pipeline``  ``VOEngine(mesh=...)`` over frames, per config of the spec
- ``single``    the same runs without a mesh (one process, no world)
- ``programs``  per config of the spec: the eager ``step(mesh=...)`` loop,
                then ``VOEngine(mesh=...)`` (the stage programs) and
                ``run_sequence(mesh=...)`` over the same frames; outputs, the
                collectives each frame recorded, the sharded BA's calls
- ``jax``       the JAX package's ``VOEngine(mesh=points_mesh())`` on its
                8-device virtual CPU mesh, per config of the spec (one
                process, so that its compiles run beside the others)

Imports torch and the port; the ``jax`` job alone imports JAX and the JAX
package, inside its function.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("psum", "psum_scatter", "all_gather")
TIMEOUT_S = 120.0       # the world's collective timeout in these jobs


def launch(job: str, world: int, workdir: str, timeout: float = 600.0) -> list[dict]:
    """Run ``world`` ranks of ``job`` on ``workdir/inputs.npz``; returns each
    rank's outputs (``workdir/rank<r>.npz`` as a dict). Raises with the
    ranks' output if one exits non-zero."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), workdir], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{job} rank {r} exited {p.returncode}:\n{log[-6000:]}")
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz"), allow_pickle=False) as z:
            out.append({k: z[k] for k in z.files})
    return out


def record_array(record) -> np.ndarray:
    """A mesh record as an int64 [n, 2] array: op (an index into OPS),
    result bytes."""
    return np.array([[OPS.index(c.op), c.result_bytes] for c in record],
                    np.int64).reshape(-1, 2)


def _cfg(fields):
    from monocular_visual_odometry_tpu_torch import convert

    return convert.config_to_torch(fields)


def _job_ba(mesh, inp, spec):
    import torch

    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.ops.camera import Camera
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    cam = Camera.create(615.0, 615.0, 320.0, 240.0)
    out = {}
    for i, case in enumerate(spec["cases"]):
        prob = BA.BAProblem(*(torch.from_numpy(inp[f"{case['problem']}_{f}"])
                              for f in BA.BAProblem._fields))
        cfg = _cfg(spec["config"])
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, **case["ba"]))
        mesh.record.clear()
        T, pts, costs = dist_ba.dist_ba_solve(cfg, cam, mesh, prob)
        out.update({f"{i}_T": T.numpy(), f"{i}_pts": pts.numpy(), f"{i}_costs": costs.numpy(),
                    f"{i}_rec": record_array(mesh.record)})
    return out


def _job_mesh(mesh, inp, spec):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

    out = {}
    D, r = mesh.size, mesh.rank
    x = torch.from_numpy(inp["x"])                # [8D, 2D, 5], the same on every rank
    xr = torch.from_numpy(inp["x_per_rank"][r])   # this rank's own (different) tensor
    out["psum"] = mesh.psum(xr).numpy()
    for dim in (0, 1):
        out[f"psum_scatter_{dim}"] = mesh.psum_scatter(xr, dim).numpy()
        out[f"all_gather_{dim}"] = mesh.all_gather(mesh.local(x, dim), dim).numpy()
        out[f"all_gather_untiled_{dim}"] = mesh.all_gather(mesh.local(x, dim), dim,
                                                           tiled=False).numpy()
    # untiled psum_scatter: the scattered dimension has size D and is dropped
    out["psum_scatter_untiled"] = mesh.psum_scatter(xr[:D], 0, tiled=False).numpy()
    out["psum_int"] = mesh.psum(torch.tensor([r, 1], dtype=torch.int64)).numpy()
    out["rec"] = record_array(mesh.record)
    # placements
    dt = distribute_tensor(x, mesh.device_mesh, PM.points_sharded(mesh))
    out["sharded_local"] = dt.to_local().numpy()
    out["sharded_full"] = dt.full_tensor().numpy()
    rt = distribute_tensor(x, mesh.device_mesh, PM.replicated(mesh))
    out["replicated_local"] = rt.to_local().numpy()
    # a mesh of the first D-1 ranks (every rank calls; the last gets None)
    sub = PM.points_mesh(D - 1, timeout_s=TIMEOUT_S)
    out["sub_size"] = np.array(-1 if sub is None else sub.size)
    if sub is not None:
        out["sub_psum"] = sub.psum(torch.ones(3)).numpy()
    dist.barrier()
    return out


def _job_timeout(mesh, inp, spec):
    """The world joins, and the job's group connects, with the default
    timeout: on a loaded host the ranks' start-up can be seconds apart. Only
    then does the group take the spec's timeout, for the collective under
    test."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

    group = dist.new_group(list(range(mesh.size)),
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
    dist.barrier(group=group)
    dist.distributed_c10d._set_pg_timeout(datetime.timedelta(seconds=spec["timeout_s"]), group)
    mesh = PM.PointsMesh(DeviceMesh.from_group(group, "cpu",
                                               mesh_dim_names=(PM.POINTS_AXIS,)), group)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        try:
            mesh.psum(torch.ones(4))
            raised = ""
        except RuntimeError as e:           # gloo raises when the timeout passes
            raised = str(e)[:500]
    else:
        time.sleep(spec["timeout_s"] + 5.0)
        raised = ""
    return {"raised": np.array(raised), "seconds": np.array(time.perf_counter() - t0)}


def _run_engine(cfg, frames, mesh):
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    eng = VOEngine(cfg, frames.shape[1], frames.shape[2], seed=0, device="cpu", mesh=mesh)
    poses, stages, ok, n_rec = [], [], [], []
    dist_ba.ba_update_state_dist.calls = 0
    for f in frames:
        if mesh is not None:
            mesh.record.clear()
        out = eng.add_frame(f)
        poses.append(out.T_w_c.numpy())
        stages.append(int(out.stage))
        ok.append(bool(out.tracking_ok))
        n_rec.append(len(mesh.record) if mesh is not None else 0)
    pts = eng.state.map.pts[eng.state.map.valid].numpy()
    ba_calls = dist_ba.ba_update_state_dist.calls
    # one more frame, blank: tracking fails, and the mesh route must call the
    # same collectives as on a frame where it holds
    if mesh is not None:
        mesh.record.clear()
    fail = eng.add_frame(np.zeros_like(frames[0]))
    return {"poses": np.stack(poses), "stages": np.array(stages), "ok": np.array(ok),
            "fail_ok": np.array(bool(fail.tracking_ok)), "fail_stage": np.array(int(fail.stage)),
            "fail_n_rec": np.array(len(mesh.record) if mesh is not None else 0),
            "n_rec": np.array(n_rec), "ba_calls": np.array(ba_calls),
            "pts_z_pos": np.array(float((pts[:, 2] > 0).mean()) if len(pts) else 0.0),
            "pts_finite": np.array(bool(np.isfinite(pts).all()))}


def _job_pipeline(mesh, inp, spec):
    out = {}
    for name, fields in spec["configs"].items():
        for k, v in _run_engine(_cfg(fields), inp["frames"], mesh).items():
            out[f"{name}_{k}"] = v
    return out


def _frame_records(records) -> np.ndarray:
    """Per-frame mesh records as an int64 [n, 3] array: frame, op, bytes."""
    rows = [np.concatenate([np.full((len(r), 1), i), record_array(r)], axis=1)
            for i, r in enumerate(records)]
    return np.concatenate(rows).astype(np.int64) if rows else np.zeros((0, 3), np.int64)


def _job_programs(mesh, inp, spec):
    """The mesh route through the stage programs against the eager step."""
    import torch

    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba

    frames = inp["frames"]
    H, W = frames.shape[1:]
    out = {}
    for name, fields in spec["configs"].items():
        cfg = _cfg(fields)
        eng = V.VOEngine(cfg, H, W, seed=0, device="cpu", mesh=mesh)
        runs = {"eager": [], "engine": []}
        records = {"eager": [], "engine": []}
        calls = {}
        st = S.init_state(cfg, 0, "cpu")
        for route in runs:
            dist_ba.ba_update_state_dist.calls = 0
            for f in frames:
                mesh.record.clear()
                if route == "eager":
                    st, o = V.step(cfg, eng.cam, st, torch.from_numpy(f).float(), height=H,
                                   width=W, mesh=mesh)
                else:
                    o = eng.add_frame(f)
                runs[route].append(o)
                records[route].append(list(mesh.record))
            calls[route] = dist_ba.ba_update_state_dist.calls
        for route, outs in runs.items():
            for f in ("T_w_c", "stage", "is_keyframe", "tracking_ok", "n_matches", "n_inliers",
                      "n_map_points"):
                out[f"{name}_{route}_{f}"] = np.stack([getattr(o, f).numpy() for o in outs])
            out[f"{name}_{route}_rec"] = _frame_records(records[route])
            out[f"{name}_{route}_ba_calls"] = np.array(calls[route])
        out[f"{name}_captured"] = np.array(eng.captured_stages, np.int64)
        prog = eng.stages.programs[S.STAGE_TRACKING]
        out[f"{name}_tracking_graph"] = np.array(prog.graph)
        out[f"{name}_per_call_rec"] = record_array(prog.per_call_record)
        if spec.get("run_sequence") == name:
            mesh.record.clear()
            final, seq = V.run_sequence(cfg, eng.cam, S.init_state(cfg, 0, "cpu"),
                                        frames, height=H, width=W, mesh=mesh)
            out[f"{name}_seq_T_w_c"] = seq.T_w_c.numpy()
            out[f"{name}_seq_stage"] = seq.stage.numpy()
            out[f"{name}_seq_n_rec"] = np.array(len(mesh.record))
    return out


def _job_jax(mesh, inp, spec):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from monocular_visual_odometry_tpu.models.vo import VOEngine
    from monocular_visual_odometry_tpu.parallel import mesh as JM
    from monocular_visual_odometry_tpu.utils.config import VOConfig

    out = {}
    for name, fields in spec["configs"].items():
        cfg = VOConfig()
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **{
            f: tuple(x) if isinstance(x, list) else x for f, x in v.items()})
            for k, v in fields.items() if isinstance(v, dict)})
        eng = VOEngine(cfg, inp["frames"].shape[1], inp["frames"].shape[2],
                       mesh=JM.points_mesh())
        out[f"{name}_poses"] = np.stack([np.asarray(eng.add_frame(f).T_w_c)
                                         for f in inp["frames"]])
    return out


def main(job, rank, world, workdir):
    import torch

    torch.set_num_threads(1)
    with np.load(os.path.join(workdir, "inputs.npz"), allow_pickle=False) as z:
        inp = {k: z[k] for k in z.files}
    spec = json.loads(str(inp.pop("spec")))
    mesh = None
    if job not in ("single", "jax"):
        from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

        PM.init_distributed(f"file://{os.path.join(workdir, 'store')}", world, rank,
                            backend="gloo", timeout_s=TIMEOUT_S)
        mesh = PM.points_mesh()
    jobs = {"ba": _job_ba, "mesh": _job_mesh, "timeout": _job_timeout,
            "pipeline": _job_pipeline, "single": _job_pipeline, "jax": _job_jax,
            "programs": _job_programs}
    out = jobs[job](mesh, inp, spec)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    if mesh is not None and job != "timeout":
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
