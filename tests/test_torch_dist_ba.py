"""Port parity: the sharded windowed BA (``parallel/dist_ba.py``) in 2 and 4
gloo processes, against JAX's ``make_dist_ba`` on the 8-device virtual CPU
mesh and against the port's single-device ``ba_solve``.

Problems come from ``tests/test_ba.py::_make_problem`` (W 5, K 64, M 256 or
512) and are handed to the ranks through ``torch_dist_worker.py``. The
gates are ``tests/test_dist_ba.py``'s, against each reference:

- one LM iteration over seeds 0-19: pose < 1e-4, point p75 < 0.01, worst
  point < 0.02 (the relative Tikhonov floor bounds how far f32 summation
  order moves a point block);
- 15 iterations: final cost within 1e-3 (relative);
- 30 iterations from an exact gauge: pose error to GT < 5e-3;
- ``deterministic`` (float64 sums): against the port's ``ba_solve`` the
  multi-process gates of ``tests/test_multihost.py`` (final cost 1e-9
  relative, pose 1e-9, points 1e-8); against JAX's solver under
  ``jax.enable_x64`` the float64 parity of ``tests/test_torch_ba.py``
  (rtol 1e-6, atol 1e-7: both round float64 iterates to float32).

The replicated results (poses, costs, the gathered landmarks) must be
bitwise equal on every rank, and one LM iteration's collectives, priced by
``scaling.collective_inventory``, must equal ``scaling.comm_model``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.ops.camera import Camera as JCam
from monocular_visual_odometry_tpu.parallel import dist_ba as JD
from monocular_visual_odometry_tpu.parallel import mesh as JM
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.models import ba as TB
from monocular_visual_odometry_tpu_torch.ops.camera import Camera as TCam
from monocular_visual_odometry_tpu_torch.parallel import dist_ba as TD
from monocular_visual_odometry_tpu_torch.parallel import scaling as TS
from monocular_visual_odometry_tpu_torch.parallel.mesh import Collective
from test_ba import _make_problem, _pose_errs
from torch_dist_worker import OPS, launch

D_VALUES = (2, 4)
SEEDS = range(20)
TCAM = TCam.create(615.0, 615.0, 320.0, 240.0)


def _outliers(prob, seed=0):
    """10% of each frame's observations moved 30-80 px."""
    uv = np.asarray(prob.obs_uv).copy()
    rng = np.random.default_rng(seed)
    for w in range(uv.shape[0]):
        bad = rng.choice(uv.shape[1], uv.shape[1] // 10, replace=False)
        uv[w, bad] += rng.uniform(30, 80, (len(bad), 2))
    return prob._replace(obs_uv=jnp.asarray(uv))


def _problems():
    """name -> (JAX problem, GT poses)."""
    out = {}
    for seed in SEEDS:
        prob, _, T_gt, _ = _make_problem(M=256, noise_px=0.3, pose_noise=0.02, pt_noise=0.03,
                                         seed=seed)
        out[f"s{seed}"] = (prob, T_gt)
    prob, _, T_gt, _ = _make_problem(M=512, noise_px=0.0, pose_noise=0.02, pt_noise=0.05)
    T_init = np.asarray(prob.T_c_w).copy()
    T_init[3:] = T_gt[3:]
    out["gt"] = (prob._replace(T_c_w=jnp.asarray(T_init)), T_gt)
    out["outliers"] = (_outliers(out["s0"][0]), out["s0"][1])
    return out


# name -> (problem, BA settings); the settings over the default VOConfig's
JOINT = dict(fix_map_points=False, window=5)
CASES = {**{f"one_iteration_s{s}": (f"s{s}", dict(JOINT, iterations=1)) for s in SEEDS},
         "cost15": ("s0", dict(JOINT, iterations=15)),
         "cost16": ("s0", dict(JOINT, iterations=16)),
         "converge": ("gt", dict(JOINT, iterations=30)),
         "deterministic": ("s0", dict(JOINT, iterations=15, deterministic=True)),
         "fixed": ("s0", dict(fix_map_points=True, iterations=15)),
         "fixed16": ("s0", dict(fix_map_points=True, iterations=16)),
         "regate_f64": ("outliers", dict(JOINT, iterations=10, regate_px=2.0,
                                         deterministic=True)),
         "regate_fixed_f64": ("outliers", dict(fix_map_points=True, iterations=10,
                                               regate_px=2.0, deterministic=True))}


def _jcfg(ba):
    cfg = JConfig()
    return cfg.replace(ba=dataclasses.replace(cfg.ba, **ba))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The problems on disk for the ranks, and per case JAX's distributed
    solution (8-device mesh) and the port's single-device one."""
    probs = _problems()
    jcam = JCam.create(615.0, 615.0, 320.0, 240.0)
    arrays = {}
    for name, (prob, _) in probs.items():
        for f, v in jax.device_get(prob)._asdict().items():
            arrays[f"{name}_{f}"] = np.asarray(v)
    spec = {"config": dataclasses.asdict(JConfig()),
            "cases": [{"problem": p, "ba": ba} for p, ba in CASES.values()]}
    work = tmp_path_factory.mktemp("dist_ba_inputs")
    np.savez(work / "inputs.npz", spec=json.dumps(spec), **arrays)
    mesh = JM.points_mesh()
    jax_out, single, solvers = {}, {}, {}
    for name, (pname, ba) in CASES.items():
        prob = probs[pname][0]
        jcfg = _jcfg(ba)
        key = json.dumps(ba, sort_keys=True)          # one compiled solver per setting
        solvers.setdefault(key, JD.make_dist_ba(jcfg, jcam, mesh))
        with jax.enable_x64(bool(ba.get("deterministic"))):
            jax_out[name] = tuple(np.asarray(a) for a in solvers[key](prob))
        tcfg = convert.config_to_torch(dataclasses.asdict(jcfg))
        single[name] = tuple(a.numpy() for a in TB.ba_solve(
            tcfg, TCAM, convert.problem_from_numpy(jax.device_get(prob), "cpu")))
    return work, probs, jax_out, single


@pytest.fixture(scope="module", params=D_VALUES, ids=lambda d: f"D{d}")
def ranks(request, reference, tmp_path_factory):
    """Each rank's solution per case: {case: (T, pts, costs, record)} per rank."""
    D = request.param
    src = reference[0]
    work = tmp_path_factory.mktemp(f"dist_ba_D{D}")
    (work / "inputs.npz").symlink_to(src / "inputs.npz")
    out = launch("ba", D, str(work), timeout=600)
    return D, [{name: tuple(r[f"{i}_{k}"] for k in ("T", "pts", "costs", "rec"))
                for i, name in enumerate(CASES)} for r in out]


def _refs(reference):
    _, probs, jax_out, single = reference
    return probs, {"jax dist (8 devices)": jax_out, "port ba_solve": single}


def test_one_iteration_matches_over_20_seeds(reference, ranks):
    probs, refs = _refs(reference)
    D, got = ranks
    for ref_name, ref in refs.items():
        worst, p75, pose_worst = 0.0, 0.0, 0.0
        for s in SEEDS:
            name = f"one_iteration_s{s}"
            T, pts = got[0][name][:2]
            pose_worst = max(pose_worst, float(np.abs(T - ref[name][0]).max()))
            used = np.asarray(probs[f"s{s}"][0].pt_used)
            d = np.abs(pts[used] - ref[name][1][used]).max(1)
            worst = max(worst, float(d.max()))
            p75 = max(p75, float(np.percentile(d, 75)))
        assert pose_worst < 1e-4, (ref_name, pose_worst)
        assert p75 < 0.01, (ref_name, p75)
        assert worst < 0.02, (ref_name, worst)


def test_reaches_the_single_device_cost(reference, ranks):
    _, refs = _refs(reference)
    D, got = ranks
    dist = float(got[0]["cost15"][2][-1])
    for ref_name, ref in refs.items():
        want = float(ref["cost15"][2][-1])
        assert abs(want - dist) < 1e-3 * want, (ref_name, want, dist)


def test_converges_to_gt(reference, ranks):
    probs, _ = _refs(reference)
    D, got = ranks
    after = _pose_errs(got[0]["converge"][0], probs["gt"][1])
    assert after.max() < 5e-3, after


@pytest.mark.parametrize("case", ["deterministic", "regate_f64", "regate_fixed_f64"])
def test_deterministic_float64(reference, ranks, case):
    """float64 sums: the same accept/reject path as the single-device solver
    (the re-gate's median and masks included)."""
    _, refs = _refs(reference)
    D, got = ranks
    T, pts, costs, _ = got[0][case]
    T_s, pts_s, c_s = refs["port ba_solve"][case]
    assert abs(costs[-1] - c_s[-1]) / abs(c_s[-1]) < 1e-9
    assert np.abs(T - T_s).max() < 1e-9
    assert np.abs(pts - pts_s).max() < 1e-8
    if case == "deterministic":
        for g, w in zip((T, pts, costs), refs["jax dist (8 devices)"][case]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_fixed_landmarks(reference, ranks):
    """Pose-only mode: the landmarks come back unchanged, the poses as the
    single-device solver's."""
    probs, refs = _refs(reference)
    D, got = ranks
    T, pts, costs, _ = got[0]["fixed"]
    np.testing.assert_array_equal(pts, np.asarray(probs["s0"][0].pts))
    for ref_name, ref in refs.items():
        assert np.abs(T - ref["fixed"][0]).max() < 1e-4, ref_name
        assert abs(costs[-1] - ref["fixed"][2][-1]) < 1e-3 * ref["fixed"][2][-1], ref_name


def test_ranks_are_bitwise_equal(ranks):
    D, got = ranks
    for r in range(1, D):
        for name in CASES:
            for a, b in zip(got[r][name], got[0][name]):
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("mode", ["joint", "fixed"])
def test_one_iteration_collectives_equal_comm_model(ranks, mode):
    """The records of 15 and 16 iterations differ by one LM iteration: its
    collectives per JAX primitive, priced with the ring factors, are
    ``comm_model``'s terms at this mesh size (W 5, K 64, M 256); their
    result bytes are the sizes the terms price."""
    D, got = ranks
    a, b = (got[0][c][3] for c in (("cost15", "cost16") if mode == "joint"
                                    else ("fixed", "fixed16")))
    rec = lambda arr: [Collective(OPS[o], int(b)) for o, b in arr]
    inv_a, inv_b = TS.collective_inventory(rec(a), D), TS.collective_inventory(rec(b), D)
    assert inv_b["n_collectives"] - inv_a["n_collectives"] == (5 if mode == "joint" else 2)
    want = TS.model_by_op(TS.comm_model(W=5, K=64, M=256, n=D), joint=mode == "joint")
    sizes = TS.model_result_bytes(5, 256, D, joint=mode == "joint")
    for op in OPS:
        moved = inv_b["by_op"].get(op, 0.0) - inv_a["by_op"].get(op, 0.0)
        assert moved == pytest.approx(want[op], abs=0.2), op
        size = inv_b["result_by_op"].get(op, 0) - inv_a["result_by_op"].get(op, 0)
        assert size == sizes[op], op


def test_indivisible_shapes_raise():
    class _Mesh:
        size = 3

    prob = TB.BAProblem(torch.eye(4).expand(5, 4, 4), torch.zeros(5, 64, 2),
                        torch.zeros(5, 64, dtype=torch.int32), torch.ones(5, 64, dtype=torch.bool),
                        torch.zeros(256, 3), torch.ones(256, dtype=torch.bool),
                        torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="divide"):
        TD.local_problem(_Mesh(), prob)


@pytest.mark.parametrize("deterministic", [False, True], ids=["f32", "f64"])
def test_multihost_entry_point(tmp_path, deterministic):
    """``python -m ...parallel.multihost`` in two gloo processes on the CPU
    (its defaults: M 1,024, K 256, 15 iterations, joint), with
    ``tests/test_multihost.py``'s gates on rank 0's report."""
    import os
    import subprocess
    import sys

    from torch_dist_worker import ROOT

    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "monocular_visual_odometry_tpu_torch.parallel.multihost",
         "--process-id", str(r), "--num-processes", "2", "--device", "cpu",
         "--coordinator", f"file://{tmp_path / 'store'}", "--report", str(report), "--timeout",
         "120"] + (["--deterministic"] if deterministic else []),
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    rep = json.loads(report.read_text())
    assert rep["num_processes"] == rep["global_devices"] == 2
    assert rep["problem"]["deterministic"] is deterministic
    if deterministic:
        assert rep["final_cost_rel_err"] < 1e-9, rep
        assert rep["pose_err_vs_single_device"] < 1e-9, rep
        assert rep["point_err_vs_single_device"] < 1e-8, rep
    else:
        assert rep["final_cost_rel_err"] < 1e-3, rep
        assert rep["pose_err_vs_single_device"] < 1e-4, rep
        assert rep["point_err_vs_single_device"] < 1e-3, rep
        assert rep["cost_of_distributed_solution"] <= 1.001 * rep["cost_of_single_solution"]
    assert np.isfinite(rep["final_cost_distributed"])
