"""Port parity: ``parallel/mesh.py`` and ``parallel/scaling.py`` of the
PyTorch package against the JAX package (CPU).

The mesh tests mirror ``tests/test_parallel_mesh.py``. The collectives run
in 2 and 4 gloo processes (``torch_dist_worker.py``: one torch thread each,
a file store in the test's directory) and must return exactly what JAX's
``psum`` / ``psum_scatter`` / ``all_gather`` return under ``shard_map`` on as
many devices of the virtual CPU mesh, for the same per-rank inputs (sums of
a few floats: equal to float32 rounding, rtol 1e-6).

``make_problem`` must equal JAX's arrays bit for bit, and ``comm_model`` and
the ring-factor pricing of ``collective_inventory`` JAX's numbers exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from monocular_visual_odometry_tpu.parallel import mesh as JM
from monocular_visual_odometry_tpu.parallel import scaling as JS
from monocular_visual_odometry_tpu_torch.parallel import mesh as TM
from monocular_visual_odometry_tpu_torch.parallel import scaling as TS
from torch_dist_worker import OPS, launch

D_VALUES = (2, 4)


def test_init_distributed_is_a_no_op_without_coordinator(monkeypatch):
    monkeypatch.delenv("MVO_COORDINATOR", raising=False)
    TM.init_distributed()  # must not raise or hang
    assert not dist.is_initialized()


def test_coordinator_forms():
    assert TM._init_method("127.0.0.1:9731") == "tcp://127.0.0.1:9731"
    assert TM._init_method("file:///tmp/store") == "file:///tmp/store"
    assert TM._init_method("tcp://10.0.0.1:1") == "tcp://10.0.0.1:1"


def test_points_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        TM.points_mesh()


def _jax_collectives(x, x_per_rank, D):
    """What each JAX primitive returns on each of D devices (leading [D])."""
    mesh = Mesh(np.asarray(jax.devices()[:D]), (JM.POINTS_AXIS,))
    ax = JM.POINTS_AXIS

    def per_device(body, arr):
        fn = jax.shard_map(lambda a: body(a[0])[None], mesh=mesh, in_specs=P(ax),
                           out_specs=P(ax), check_vma=False)
        return np.asarray(fn(jnp.asarray(arr)))

    out = {"psum": per_device(lambda a: jax.lax.psum(a, ax), x_per_rank)}
    for dim in (0, 1):
        out[f"psum_scatter_{dim}"] = per_device(
            lambda a, d=dim: jax.lax.psum_scatter(a, ax, scatter_dimension=d, tiled=True),
            x_per_rank)
        local = np.stack(np.split(x, D, axis=dim))          # rank r's block of x
        out[f"all_gather_{dim}"] = per_device(
            lambda a, d=dim: jax.lax.all_gather(a, ax, axis=d, tiled=True), local)
        out[f"all_gather_untiled_{dim}"] = per_device(
            lambda a, d=dim: jax.lax.all_gather(a, ax, axis=d, tiled=False), local)
    out["psum_scatter_untiled"] = per_device(
        lambda a: jax.lax.psum_scatter(a[:D], ax, scatter_dimension=0, tiled=False),
        x_per_rank)
    return out


@pytest.fixture(scope="module", params=D_VALUES, ids=lambda d: f"D{d}")
def mesh_run(request, tmp_path_factory):
    D = request.param
    rng = np.random.default_rng(D)
    x = rng.normal(size=(8 * D, 2 * D, 5)).astype(np.float32)
    x_per_rank = rng.normal(size=(D, 8 * D, 4 * D, 3)).astype(np.float32)
    work = tmp_path_factory.mktemp(f"mesh{D}")
    np.savez(work / "inputs.npz", x=x, x_per_rank=x_per_rank, spec=json.dumps({}))
    ranks = launch("mesh", D, str(work), timeout=300)
    return D, x, x_per_rank, ranks, _jax_collectives(x, x_per_rank, D)


def test_collectives_return_what_jax_returns(mesh_run):
    D, _, _, ranks, want = mesh_run
    for name, per_device in want.items():
        for r in range(D):
            got = ranks[r][name]
            assert got.shape == per_device[r].shape, (name, r)
            np.testing.assert_allclose(got, per_device[r], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} rank {r}")
    for r in range(D):   # integer sums, exactly
        np.testing.assert_array_equal(ranks[r]["psum_int"], [sum(range(D)), D])


def test_ranks_hold_bitwise_equal_replicated_results(mesh_run):
    D, _, _, ranks, _ = mesh_run
    for name in ("psum", "all_gather_0", "all_gather_1", "all_gather_untiled_1"):
        for r in range(1, D):
            np.testing.assert_array_equal(ranks[r][name], ranks[0][name])


def test_record_names_each_primitive_and_its_bytes(mesh_run):
    D, x, x_per_rank, ranks, _ = mesh_run
    rec = ranks[0]["rec"]
    ops = [OPS[o] for o in rec[:, 0]]
    assert ops == (["psum"] + ["psum_scatter", "all_gather", "all_gather"] * 2
                   + ["psum_scatter", "psum"])
    assert rec[0, 1] == x_per_rank[0].nbytes                   # psum: the whole tensor
    assert rec[1, 1] == x_per_rank[0].nbytes // D              # psum_scatter: one block
    assert rec[2, 1] == x.nbytes                               # all_gather: the whole result


def test_points_mesh_size_subset_and_placements(mesh_run):
    """``points_mesh()`` spans the world; ``points_mesh(D-1)`` its first D-1
    ranks (None on the last); Shard(0) gives each rank its contiguous block
    and Replicate() the whole, as JAX's points_sharded / replicated."""
    D, x, _, ranks, _ = mesh_run
    for r in range(D):
        assert int(ranks[r]["sub_size"]) == (D - 1 if r < D - 1 else -1)
        if r < D - 1:
            np.testing.assert_array_equal(ranks[r]["sub_psum"], np.full(3, D - 1.0))
        np.testing.assert_array_equal(ranks[r]["sharded_local"], np.split(x, D)[r])
        np.testing.assert_array_equal(ranks[r]["sharded_full"], x)
        np.testing.assert_array_equal(ranks[r]["replicated_local"], x)


def test_a_split_collective_schedule_raises_instead_of_hanging(tmp_path):
    """Rank 1 never calls the collective rank 0 waits in: with the world's
    3 s timeout rank 0 raises, well before the job's limit."""
    np.savez(tmp_path / "inputs.npz", spec=json.dumps({"timeout_s": 3.0}))
    ranks = launch("timeout", 2, str(tmp_path), timeout=120)
    assert str(ranks[0]["raised"]), "rank 0's collective returned without rank 1"
    assert 2.5 < float(ranks[0]["seconds"]) < 30.0


@pytest.mark.parametrize("shape", [(5, 1024, 4096, 0), (5, 64, 256, 3), (3, 96, 512, 7)],
                         ids=lambda s: "W{}_K{}_M{}_seed{}".format(*s))
def test_make_problem_equals_jax(shape):
    W, K, M, seed = shape
    jprob, jcam = JS.make_problem(W=W, K=K, M=M, seed=seed)
    tprob, tcam = TS.make_problem(W=W, K=K, M=M, seed=seed, device="cpu")
    for f in jprob._fields:
        j, t = np.asarray(getattr(jprob, f)), getattr(tprob, f).numpy()
        assert j.dtype == t.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert tuple(tcam) == tuple(float(v) for v in (jcam.fx, jcam.fy, jcam.cx, jcam.cy))


@pytest.mark.parametrize("wkmn", [(5, 1024, 4096, 8), (5, 1024, 4096, 1), (5, 1024, 4096, 2),
                                  (3, 256, 1024, 4), (20, 512, 2048, 16)],
                         ids=lambda s: "W{}_K{}_M{}_n{}".format(*s))
def test_comm_model_equals_jax(wkmn):
    W, K, M, n = wkmn
    assert TS.comm_model(W=W, K=K, M=M, n=n) == JS.comm_model(W=W, K=K, M=M, n=n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_collective_inventory_prices_as_jax_prices_hlo(n):
    """The same collectives, once as a mesh record and once as the HLO text
    JAX's inventory reads: the same bytes per op."""
    record = [TM.Collective("psum", 4 * 5 * 42), TM.Collective("psum_scatter", 4 * 64 * 102),
              TM.Collective("all_gather", 4 * 256 * 3), TM.Collective("psum", 4)]
    hlo = "\n".join([
        "%a = f32[5,42]{1,0} all-reduce(f32[5,42]{1,0} %x), replica_groups={}",
        "%b = f32[64,102]{1,0} reduce-scatter(f32[128,102]{1,0} %y), dimensions={0}",
        "%c = f32[256,3]{1,0} all-gather(f32[128,3]{1,0} %z), dimensions={0}",
        "%d = f32[] all-reduce(f32[] %w), replica_groups={}"])
    got = TS.collective_inventory(record, n)
    want = JS.collective_inventory(hlo, n)
    assert got["n_collectives"] == want["n_collectives"] == 4
    assert ([o["bytes_moved_per_device"] for o in got["ops"]]
            == [o["bytes_moved_per_device"] for o in want["ops"]])
    assert [o["result_bytes"] for o in got["ops"]] == [o["result_bytes"] for o in want["ops"]]


def test_model_by_op_adds_comm_model_terms():
    m = TS.comm_model(W=5, K=64, M=256, n=4)
    j = m["joint_mode_bytes"]
    by_op = TS.model_by_op(m, joint=True)
    assert sum(by_op.values()) == pytest.approx(j["total_per_iteration"], abs=0.2)
    assert TS.model_by_op(m, joint=False)["psum"] == m["fix_points_bytes"]["total_per_iteration"]
    # at n = 1 nothing moves, but the results keep their sizes
    assert TS.model_result_bytes(5, 256, 1, True)["psum_scatter"] == 48 * 256 + 72 * 5 * 256
    assert TS.model_result_bytes(5, 256, 4, True)["psum_scatter"] == (48 + 72 * 5) * 64


def test_a_backend_refuses_tensors_it_does_not_take():
    """NCCL takes CUDA tensors only: a CPU tensor raises before any call."""
    mesh = object.__new__(TM.PointsMesh)
    mesh.backend, mesh.size, mesh.rank, mesh.record = "nccl", 1, 0, []
    for call in (mesh.psum, mesh.psum_scatter, mesh.all_gather):
        with pytest.raises(ValueError, match="nccl backend takes no cpu tensors"):
            call(torch.zeros(4))
    assert mesh.record == []


def test_scaling_entry_point_in_two_processes(tmp_path):
    """``python -m ...parallel.scaling`` as two gloo ranks on the CPU, joined
    through ``MVO_COORDINATOR`` / ``MVO_NUM_PROCESSES`` / ``MVO_PROCESS_ID``:
    rank 0 prints the FLOPs, times and communication account at the live
    shape (3 LM iterations), the sharded solution within
    ``tests/test_multihost.py``'s f32 gates of ``ba_solve``'s, the measured
    iteration equal to ``comm_model``."""
    import os
    import subprocess
    import sys

    from torch_dist_worker import ROOT

    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   MVO_COORDINATOR=f"file://{tmp_path / 'store'}", MVO_NUM_PROCESSES="2",
                   MVO_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "monocular_visual_odometry_tpu_torch.parallel.scaling",
             "--device", "cpu", "--backend", "gloo", "--iterations", "3"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert outs[1][0].strip() == ""            # rank 0 prints
    rep = json.loads(outs[0][0])
    flops, comm = rep["flops_partition"], rep["communication"]
    assert flops["mesh"] == 2 and flops["device"] == "cpu"
    assert flops["matmul_flops_per_rank"] > 0 and flops["ms_per_solve_cuda_events"] is None
    assert set(flops["ms_per_solve_host"]) == {"dist", "single"}
    assert flops["final_cost_rel"] < 1e-3 and flops["pose_err"] < 1e-4
    assert "not a scaling signal" in flops["note"] and "matmul-class" in flops["note"]
    measured = comm["measured_per_iteration"]
    assert measured["collectives"] == 5
    for op, want in comm["model_by_op"].items():
        assert measured["by_op"][op] == pytest.approx(want, abs=0.2), op
        assert measured["result_by_op"][op] == comm["model_result_bytes"][op], op
    assert comm["matmul_flops_per_rank_per_iteration"] > 0
