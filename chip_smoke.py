#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into a pass):

1. environment: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA kernel of ``monocular_visual_odometry_tpu_torch/
   csrc`` with nvcc for sm_90a (one nvcc per source, started together);
3. kernels: calls each kernel's wrapper on the card at the main path's shapes
   and at edge cases (multi-stage and ragged K2, ragged K1, K1=1, K2=1) and
   requires ``torch.equal`` with its plain PyTorch version; times kernel,
   plain version and a library yardstick with CUDA events, and works out the
   least time the card needs for the same work. Then, in turns in this one
   call, the matcher against its first version (PR 1's wrapper and kernel,
   when their copies are in ``build/pr1/``: ``hamming.py`` and
   ``hamming_nn_top2.cu``; "not measured" otherwise), beside the launch floor
   of a graph node (a one-element ``fill_``); and the kernel's time split by
   input: one train point (launch, set-up, the gate pass over one stage
   buffer, which has a fixed size, and the merge; next to no staging), r=0
   (the same plus staging the whole train set, no popcounts), the main
   path's r (all of it);
4. main path: renders the 150-frame synthetic benchmark in memory and runs the
   port's ``VOEngine`` (default config at full width, windowed BA on) on
   ``cuda``; checks that it reaches tracking, fails tracking on at most 5
   frames, keeps the Sim(3) ATE under 3% of the path length, that every
   kernel of the path launched once per ``match_features`` call and
   ``ba_update_state`` once per tracking frame whose tracking held (counts
   reset just before the run, read just after);
   4a. the same with BA off, for the fps beside BA on in this call;
   4b. profiles a window of steady tracking frames (BA on) with
   ``torch.profiler`` and prints the device-busy share and the kernels that
   take the most time;
   4c. runs one ``ba_update_state`` on the state after that window under
   ``torch.cuda.set_sync_debug_mode("error")`` (the LM never waits on the
   host), holds it against the same call on a CPU copy of the state, times
   it with CUDA events and counts its device kernels;
   4d. runs the five-point configuration (``essential_minimal="5pt"``, BA
   on) over the 150 frames with the checks of phase 4 (the 3% ATE budget is
   one of the whole path; each run also prints its ATE over the first 60
   frames, which reads higher);
   4e. the batched steady state (``run_sequences_batched``): eight 60-frame
   sequences (seeds 0-7), each warmed up single-stream over 15 frames, then
   frames 15-59 single-stream (the reference) and batched at B = 1, 2, 4, 8;
   checks 2 matcher launches and 1 ``ba_update_state`` call per batched step
   whatever B, every stream tracking (<= 5 failures), its first step its
   single-stream step up to rounding (pose distance < 1e-3, same decisions),
   the whole B=1 run the single-stream run, and its ATE within max(0.02,
   half) of its single-stream ATE or not above the worst single-stream ATE
   of the call (at B > 1 rounding can flip a keyframe decision, after which
   the keys part and the run is another run); profiles 5 batched steps per B
   (device kernels per step: B=8 at most 1.5x B=1), runs one B=8 vmapped body
   under ``set_sync_debug_mode("error")`` and holds one B=2 step against a CPU
   copy fed the same draws (matches, inliers and map points within 5%, the
   other counts equal, poses within 1e-3);
5. prints one JSON line describing the kernels, then, as the last line, the
   device JSON.

Phase 3 also holds batched launches (B streams in one launch: B=8 at the
tracking and keyframe shapes, B=3 ragged with a stream without valid queries
and one with a single valid train point, B=3 with K2=1) against the plain
version per stream and times one batched launch against B single launches.
The sequences are rendered by a pool of processes at the start of phase 4.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 150
H, W = 480, 640
PROFILE_FROM, PROFILE_FRAMES = 40, 20  # a steady tracking window
WARM_FRAMES = 10         # frames of a throw-away engine per config, to reach BA
BA_TOL = 1e-4            # ba_update_state, card against CPU (tests/test_torch_cuda.py)
EARLY_FRAMES = 60        # also read the ATE over these first frames: the 3% budget
                         # is one of the whole path, and a short run reads higher
# popcount throughput per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
POPC_PER_SM_CLK = 16
LOGIC_PER_SM_CLK = 64    # 32-bit bitwise AND/OR/XOR, same table
GRAPH_CALLS = 20         # calls captured in one CUDA graph for device timing
BATCH_SEQS, BATCH_FRAMES, BATCH_WARM = 8, 60, 15  # phase 4e: streams, frames, warm-up
BATCH_SIZES = (1, 2, 4, 8)
BATCH_PROFILE_STEPS = 5
KERNELS_PER_STEP_RATIO = 1.5  # B=8 device kernels per batched step, at most x B=1's
RENDER_CHUNK = 30        # frames per rendering job
FP32_PEAK = 67e12        # H100 SXM, non-tensor fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
# PR 1's wrapper (hamming.py) and kernel (hamming_nn_top2.cu), for the A/B
# in turns; placed here by hand, never reached by the package
PR1_DIR = Path(ROOT) / "build" / "pr1"
DESIGN = ("train set staged in shared memory by 1-D bulk async copies on mbarriers "
          "(positions+validity and descriptors on separate barriers), 1024-point "
          "stages in a 2-buffer ring; one warp per query, ceil(K1/SMs) queries per "
          "block (at most 16); a lane gates 16 point pairs into a bit mask, then "
          "popcounts only the gated pairs; union-gate and single-gate kernels")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, iters: int) -> float:
    """CUDA-event time of ``iters`` calls of ``run()``, per call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn()``.

    A call from Python costs tens of microseconds on the host, more than
    these kernels take on the card, so back-to-back eager calls time the
    host. The device time is taken from a CUDA graph that holds
    ``GRAPH_CALLS`` captured calls, replayed ``iters`` times; the eager time
    (what a caller pays, host included) from plain back-to-back calls, the
    median of 5 runs of ``iters`` calls (the host's time varies more)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = _events_ms(graph.replay, iters) / GRAPH_CALLS
    return device_ms, float(np.median([_events_ms(fn, iters) for _ in range(5)]))


def _wrapper_with(module_path, lib_path, tag):
    """A private copy of a wrapper module whose kernel library (``_lib``) is
    ``lib_path``."""
    spec = importlib.util.spec_from_file_location(f"hamming_{tag}", module_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.hamming_nn_top2_launch.argtypes = [P, P, P, P, ctypes.c_int, P, P, P, ctypes.c_int,
                                           ctypes.c_float, P, P, P, P]
    lib.hamming_nn_top2_launch.restype = ctypes.c_int
    mod._lib = lib
    return mod


def _hamming_inputs(k1, k2, seed, *, alt=False, invalid=0.1, dev="cuda"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    d1 = rng.integers(0, 256, (k1, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (k2, 32), dtype=np.uint8)
    uv1 = rng.uniform([0, 0], [W, H], (k1, 2)).astype(np.float32)
    uv2 = rng.uniform([0, 0], [W, H], (k2, 2)).astype(np.float32)
    v1 = rng.uniform(size=k1) >= invalid
    v2 = rng.uniform(size=k2) >= invalid
    uv1_alt = (uv1 + rng.normal(0, 30, (k1, 2))).astype(np.float32) if alt else None
    return (t(d1), t(uv1), t(v1), t(d2), t(uv2), t(v2),
            None if uv1_alt is None else t(uv1_alt))


def _on_radius_inputs(seed, dev="cuda"):
    """Queries at (100, 100) and train points whose fp32 squared distance
    (two rounded products, one rounded sum) is exactly r*r = 2500 while a
    fused multiply-add would round it differently."""
    rng = np.random.default_rng(seed)
    k1, k2 = 64, 512
    base = np.float32(100.0)
    pts = []
    while len(pts) < k2 // 2:
        du = np.float32(rng.uniform(1.0, 49.0))
        dv = np.float32(np.sqrt(np.float32(2500.0) - du * du))
        tx, ty = np.float32(base + du), np.float32(base + dv)
        du_e, dv_e = np.float32(base - tx), np.float32(base - ty)
        p2 = np.float32(np.float32(du_e * du_e) + np.float32(dv_e * dv_e))
        fused = np.float32(np.float64(du_e) * np.float64(du_e) + np.float64(np.float32(dv_e * dv_e)))
        if p2 == np.float32(2500.0) and fused != p2:
            pts.append((tx, ty))
    pts += [tuple(rng.uniform(50, 150, 2).astype(np.float32)) for _ in range(k2 - len(pts))]
    uv2 = np.asarray(pts, np.float32)[rng.permutation(k2)]
    uv1 = np.full((k1, 2), base, np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    d1 = rng.integers(0, 256, (k1, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (k2, 32), dtype=np.uint8)
    ones1, ones2 = np.ones(k1, bool), np.ones(k2, bool)
    return t(d1), t(uv1), t(ones1), t(d2), t(uv2), t(ones2), None


def _tie_inputs(seed, dev="cuda"):
    """Every train descriptor duplicated 4x: best == second and the
    lowest duplicate index must win."""
    d1, uv1, v1, d2, uv2, v2, _ = _hamming_inputs(256, 1024, seed, invalid=0.0, dev=dev)
    d2 = d2[:256].repeat(4, 1).contiguous()
    uv2 = uv2[:256].repeat(4, 1).contiguous()
    return d1, uv1, v1, d2, uv2, v2, None


def _render(job):
    """Frames lo..hi-1 of a synthetic sequence (runs in a pool process)."""
    seed, n, step, lo, hi = job
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    return syn.render_sequence_arrays(n, seed=seed, height=H, width=W, translation_step=step,
                                      span=(lo, hi))


def _render_all(seqs):
    """[(frames, gt)] for (seed, n_frames, translation_step) in ``seqs``,
    rendered in chunks by a pool of processes (closed before returning)."""
    jobs = [(seed, n, step, lo, min(lo + RENDER_CHUNK, n))
            for seed, n, step in seqs for lo in range(0, n, RENDER_CHUNK)]
    # one BLAS thread per worker: the workers are as many as the cores
    # (with a pool of threads each, rendering took 4x as long)
    threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                               "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in threads})
    try:
        with ProcessPoolExecutor(max_workers=min(len(jobs), os.cpu_count() or 1),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            parts = iter(list(ex.map(_render, jobs)))
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = []
    for seed, n, step in seqs:
        chunk = [next(parts) for _ in range(0, n, RENDER_CHUNK)]
        out.append((np.concatenate([f for f, _ in chunk]), chunk[0][1]))
    return out


def _batched_inputs(b, k1, k2, seed, *, alt=False, ragged=False):
    """B streams of ``_hamming_inputs`` stacked; ``ragged``: stream 1 has no
    valid query, stream 2 a single valid train point."""
    streams = [list(_hamming_inputs(k1, k2, seed + i, alt=alt)) for i in range(b)]
    if ragged:
        streams[1][2] = torch.zeros_like(streams[1][2])
        one = torch.zeros_like(streams[2][5])
        one[k2 // 2] = True
        streams[2][5] = one
    return tuple(None if ts[0] is None else torch.stack(ts) for ts in zip(*streams))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.ops import lie
    from monocular_visual_odometry_tpu_torch.ops.cuda import build
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.utils import metrics
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    t_start = time.perf_counter()

    def elapsed(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    # ---- 1. environment --------------------------------------------------
    card = _nvidia_smi("name,power.limit")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- 2. build (one nvcc per source, all started together) -------------
    sources = sorted(p[:-3] for p in os.listdir(build.CSRC) if p.endswith(".cu"))
    jobs = [(name, None) for name in sources]
    have_pr1 = (PR1_DIR / "hamming.py").exists() and (PR1_DIR / "hamming_nn_top2.cu").exists()
    if have_pr1:
        jobs.append(("hamming_nn_top2_pr1", PR1_DIR / "hamming_nn_top2.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(zip((j[0] for j in jobs), ex.map(lambda j: build.build(*j), jobs)))
    print(f"build: {len(jobs)} kernel librar(ies) from {len(sources)} source(s) in the "
          f"package in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (path, secs, log) in built.items():
        print(f"  {name}: {path.name} ({secs:.2f} s)\n{log.strip()}", flush=True)

    elapsed("phase 3")
    # ---- 3. kernel against plain version ---------------------------------
    # the three main-path shapes: init 1024x1024 r=100, tracking 1536x1024
    # r=50 with the union gate, keyframe update 1024x1024 r=100
    main_shapes = [("init", 1024, 1024, 100.0, False),
                   ("track", 1536, 1024, 50.0, True),
                   ("keyframe", 1024, 1024, 100.0, False)]
    edge_cases = [("r0", _hamming_inputs(256, 512, 11), 0.0),
                  ("all_invalid", _hamming_inputs(256, 512, 12, invalid=1.0), 1e6),
                  ("tie", _tie_inputs(13), 1e6),
                  ("on_radius", _on_radius_inputs(14), 50.0),
                  ("ragged", _hamming_inputs(1000, 777, 15, alt=True), 80.0),
                  # every pair gated in: the two-buffer ring runs 4.5 stages
                  ("multi_stage", _hamming_inputs(1536, 4608, 16, alt=True), 1e6),
                  ("k2_2560", _hamming_inputs(512, 2560, 17), 150.0),
                  # K1 not a multiple of 4, 8 or 16; a last stage of one point
                  ("stage_tail", _hamming_inputs(1003, 2049, 18), 120.0),
                  ("k2_1001", _hamming_inputs(1000, 1001, 19), 80.0),
                  ("k1_1", _hamming_inputs(1, 1024, 20, invalid=0.0), 1e6),
                  ("k2_1", _hamming_inputs(1024, 1, 21, invalid=0.0), 1e6),
                  ("k1_1_k2_1", _hamming_inputs(1, 1, 22, invalid=0.0), 1e6)]
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    popc_rate = n_sm * POPC_PER_SM_CLK * clock_mhz * 1e6
    logic_rate = n_sm * LOGIC_PER_SM_CLK * clock_mhz * 1e6

    def bound(args, r):
        """(bound ms, what bounds it, gated pairs, bytes) of a call on these
        inputs: each input read once, each output written once, and the
        operations the gated pairs need."""
        d1, uv1, v1, d2, uv2, v2, uv1_alt = args
        k1, k2 = d1.shape[0], d2.shape[0]
        n_pos = 2 if uv1_alt is not None else 1
        nbytes = (k1 * (32 + 8 * n_pos + 1) + k2 * (32 + 8 + 1) + k1 * (4 + 4 + 4))
        # pairs that pass the validity and radius gate: those need popcounts
        p2 = HM.pixel_dist2_matrix(uv1, uv2)
        if uv1_alt is not None:
            p2 = torch.minimum(p2, HM.pixel_dist2_matrix(uv1_alt, uv2))
        r2 = float(np.float32(r) * np.float32(r))
        pairs = int(((p2 <= r2) & v1[:, None] & v2[None, :]).sum())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # 8 XOR and 8 popcounts for each pair that passes the gate; the gate
        # itself is 2 sub, 2 mul, 1 add, 1 compare per pair and query position
        ops_ms = (pairs * 8 / popc_rate + pairs * 8 / logic_rate
                  + k1 * k2 * 6 * n_pos / FP32_PEAK) * 1e3
        return (max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes",
                pairs, nbytes)

    def check(tag, args, r, fn=HM.hamming_nn_top2):
        d1, uv1, v1, d2, uv2, v2, alt = args
        got = fn(d1, uv1, v1, d2, uv2, v2, r, uv1_alt=alt)
        want = HM.hamming_nn_top2_reference(d1, uv1, v1, d2, uv2, v2, r, uv1_alt=alt)
        torch.cuda.synchronize()
        for g, w_, what in zip(got, want, ("best", "second", "idx")):
            if not torch.equal(g, w_):
                bad = int((g != w_).sum())
                raise AssertionError(f"hamming_nn_top2 {tag}: {what} differs from the "
                                     f"plain version in {bad} of {g.numel()} queries")
        return max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))

    max_err = 0.0
    for tag, args, r in edge_cases:
        max_err = max(max_err, check(tag, args, r))
        print(f"kernel hamming_nn_top2 {tag}: equal to plain version", flush=True)

    # PR 1's wrapper and kernel
    others = {}
    if have_pr1:
        others["pr1"] = _wrapper_with(PR1_DIR / "hamming.py", built["hamming_nn_top2_pr1"][0],
                                      "pr1").hamming_nn_top2
    floor_buf = torch.zeros(1, device="cuda")

    shape_rows = []
    for i, (tag, k1, k2, r, alt) in enumerate(main_shapes):
        args = _hamming_inputs(k1, k2, 100 + i, alt=alt)
        max_err = max(max_err, check(tag, args, r))
        for name, fn in others.items():
            check(f"{tag} ({name})", args, r, fn)
        d1, uv1, v1, d2, uv2, v2, uv1_alt = args
        # in turns, mirrored (floor, this kernel, PR 1's, then back), one
        # CUDA-graph device time and one eager time per turn
        calls = {"floor": lambda: floor_buf.fill_(1.0),
                 "new": lambda: HM.hamming_nn_top2(*args[:6], r, uv1_alt=uv1_alt)}
        calls.update({name: (lambda fn=fn: fn(*args[:6], r, uv1_alt=uv1_alt))
                      for name, fn in others.items()})
        turns = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            turns[name].append(_time_ms(calls[name], 100))
        mean = {name: tuple(float(np.mean(v)) for v in zip(*ts)) for name, ts in turns.items()}
        ms, eager_ms = mean["new"]
        pr1_ms, pr1_eager_ms = mean.get("pr1", (None, None))
        # the kernel's time split by input, device ms: one train point (launch,
        # set-up, the fixed-size gate pass over one stage buffer, merge), r=0
        # (the same plus staging the whole train set, no popcounts)
        one_ms = _time_ms(lambda: HM.hamming_nn_top2(d1, uv1, v1, d2[:1], uv2[:1], v2[:1], r,
                                                     uv1_alt=uv1_alt), 100)[0]
        r0_ms = _time_ms(lambda: HM.hamming_nn_top2(*args[:6], 0.0, uv1_alt=uv1_alt), 100)[0]
        plain_ms, plain_eager_ms = _time_ms(
            lambda: HM.hamming_nn_top2_reference(*args[:6], r, uv1_alt=uv1_alt), 20)
        a = HM.unpack_pm1(d1).to(torch.bfloat16)
        b = HM.unpack_pm1(d2).to(torch.bfloat16)
        library_ms, _ = _time_ms(lambda: torch.matmul(a, b.T), 100)
        bound_ms, bound_by, pairs, nbytes = bound(args, r)
        row = dict(shape=tag, k1=k1, k2=k2, r=r, union_gate=alt, ms=ms, eager_ms=eager_ms,
                   pr1_ms=pr1_ms, pr1_eager_ms=pr1_eager_ms, launch_floor_ms=mean["floor"][0],
                   one_train_point_ms=one_ms, r0_ms=r0_ms,
                   turns={name: [list(t) for t in ts] for name, ts in turns.items()},
                   plain_ms=plain_ms, plain_eager_ms=plain_eager_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, gated_pairs=pairs, bytes=nbytes)
        shape_rows.append(row)
        print(f"kernel hamming_nn_top2 {tag} {k1}x{k2} r={r}: equal; "
              f"device: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 matmul "
              f"{library_ms:.4f} ms; eager: kernel {eager_ms:.4f} ms, plain {plain_eager_ms:.4f} ms; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), {pairs} gated pairs",
              flush=True)
        fmt = lambda v: "not measured" if v is None else f"{v:.6f} ms"
        print(f"kernel hamming_nn_top2 {tag} in turns "
              f"({' '.join(list(calls) + list(calls)[::-1])}): device this design "
              f"{fmt(ms)}, PR 1 {fmt(pr1_ms)}; eager this wrapper and design {fmt(eager_ms)}, "
              f"PR 1 {fmt(pr1_eager_ms)}; launch floor (yardstick: one-element fill_ as a "
              f"graph node) {fmt(mean['floor'][0])}", flush=True)
        print(f"kernel hamming_nn_top2 {tag} split by input (device): one train point "
              f"{fmt(one_ms)}, r=0 {fmt(r0_ms)}, r={r} {fmt(ms)}", flush=True)

    elapsed("phase 3, batched launches")
    # batched launches: B streams in one launch, each stream against the
    # plain version; one batched launch against B single launches in turns
    batched_cases = [("track_b8", 8, 1536, 1024, 50.0, True, False),
                     ("keyframe_b8", 8, 1024, 1024, 100.0, False, False),
                     ("ragged_b3", 3, 1003, 777, 80.0, True, True),
                     ("k2_1_b3", 3, 1003, 1, 1e6, False, False)]
    batched_rows = []
    for i, (tag, nb, k1, k2, r, alt, ragged) in enumerate(batched_cases):
        args = _batched_inputs(nb, k1, k2, 200 + 10 * i, alt=alt, ragged=ragged)
        d1, uv1, v1, d2, uv2, v2, uv1_alt = args
        got = HM.hamming_nn_top2_batched(*args[:6], r, uv1_alt=uv1_alt)
        # each stream's inputs on their own (aligned) storage, for single launches
        singles = [tuple(None if t is None else t[b].clone() for t in args) for b in range(nb)]
        for b, one in enumerate(singles):
            want = HM.hamming_nn_top2_reference(*one[:6], r, uv1_alt=one[6])
            torch.cuda.synchronize()
            for g, w_, what in zip(got, want, ("best", "second", "idx")):
                if not torch.equal(g[b], w_):
                    bad = int((g[b] != w_).sum())
                    raise AssertionError(f"hamming_nn_top2 batched {tag}: stream {b} {what} "
                                         f"differs from the plain version in {bad} of "
                                         f"{w_.numel()} queries")
            max_err = max(max_err, float((got[0][b] - want[0]).abs().max()),
                          float((got[1][b] - want[1]).abs().max()))
        calls = {"batched": lambda: HM.hamming_nn_top2_batched(*args[:6], r, uv1_alt=uv1_alt),
                 "singles": lambda: [HM.hamming_nn_top2(*one[:6], r, uv1_alt=one[6])
                                     for one in singles]}
        turns = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            turns[name].append(_time_ms(calls[name], 50))
        mean = {name: tuple(float(np.mean(v)) for v in zip(*ts)) for name, ts in turns.items()}
        plain_ms, plain_eager_ms = _time_ms(
            lambda: [HM.hamming_nn_top2_reference(*one[:6], r, uv1_alt=one[6])
                     for one in singles], 5)
        a = HM.unpack_pm1(d1).to(torch.bfloat16)
        bm = HM.unpack_pm1(d2).to(torch.bfloat16)
        library_ms, _ = _time_ms(lambda: torch.bmm(a, bm.transpose(1, 2)), 50)
        per_stream = [bound(one, r) for one in singles]
        bound_ms = sum(p[0] for p in per_stream)
        row = dict(shape=tag, batch=nb, k1=k1, k2=k2, r=r, union_gate=alt, ms=mean["batched"][0],
                   eager_ms=mean["batched"][1], singles_ms=mean["singles"][0],
                   singles_eager_ms=mean["singles"][1],
                   turns={name: [list(t) for t in ts] for name, ts in turns.items()},
                   plain_ms=plain_ms, plain_eager_ms=plain_eager_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=per_stream[0][1],
                   gated_pairs=sum(p[2] for p in per_stream),
                   bytes=sum(p[3] for p in per_stream))
        batched_rows.append(row)
        print(f"kernel hamming_nn_top2 batched {tag} B={nb} {k1}x{k2} r={r}: every stream "
              f"equal to the plain version; device: one batched launch {row['ms']:.6f} ms, "
              f"{nb} single launches {row['singles_ms']:.6f} ms; eager: batched "
              f"{row['eager_ms']:.6f} ms, singles {row['singles_eager_ms']:.6f} ms (in turns: "
              f"batched singles singles batched); plain {plain_ms:.4f} ms; bf16 bmm "
              f"{library_ms:.6f} ms (partial yardstick); bound {bound_ms:.6f} ms "
              f"({row['bound_by']}, B x the single-stream bounds), {row['gated_pairs']} "
              f"gated pairs", flush=True)

    elapsed("phase 4")
    # ---- 4. main path: the default config (BA on), then BA off, then 5pt ---
    t0 = time.perf_counter()
    (frames, gt), *batch_seqs = _render_all(
        [(0, N_FRAMES, 0.04)] + [(seed, BATCH_FRAMES, 0.05) for seed in range(BATCH_SEQS)])
    print(f"rendered {N_FRAMES} + {BATCH_SEQS} x {BATCH_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = VOConfig()
    cfg_no_ba = cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=False))
    cfg_5pt = cfg.replace(ransac=dataclasses.replace(cfg.ransac, essential_minimal="5pt"))
    for c in (cfg, cfg_5pt):  # library init (cuSOLVER, cuBLAS) off the clock
        warm = VOEngine(c, H, W, seed=0, device="cuda")
        for f in frames[:WARM_FRAMES]:
            warm.add_frame(f)
    torch.cuda.synchronize()

    def run_path(name, c, n):
        """Drive a fresh engine over the first n frames; the kernel and BA
        counts are set to 0 just before and read just after."""
        eng = VOEngine(c, H, W, seed=0, device="cuda")
        torch.cuda.synchronize()
        HM.hamming_nn_top2.launches = 0
        BA.ba_update_state.calls = 0
        est, n_fail, n_match, n_ba, stage, per_frame = [], 0, 0, 0, S.STAGE_BLANK, []
        t0 = time.perf_counter()
        for f in frames[:n]:
            before = HM.hamming_nn_top2.launches
            out = eng.add_frame(f)
            per_frame.append(HM.hamming_nn_top2.launches - before)
            n_match += {S.STAGE_BLANK: 0, S.STAGE_INITIALIZING: 1}.get(
                stage, 1 + int(bool(out.is_keyframe)))
            n_ba += int(c.ba.enabled and stage == S.STAGE_TRACKING and bool(out.tracking_ok))
            stage = int(out.stage)
            if stage == S.STAGE_TRACKING and not bool(out.tracking_ok):
                n_fail += 1
            est.append(out.T_w_c.numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = dict(name=name, frames=n, wall_s=wall, fps=n / wall, stage=stage, n_fail=n_fail,
                 launches=HM.hamming_nn_top2.launches, match_calls=n_match,
                 ba_calls=BA.ba_update_state.calls, ba_expected=n_ba,
                 ba_rejected=int(out.ba_rejected_total), per_frame_max=max(per_frame))
        est = np.stack(est)
        if not np.isfinite(est).all():
            raise AssertionError(f"{name}: non-finite pose in the trajectory")
        r["est"] = est
        r["ate"] = metrics.ate_rmse(est, gt[:n])
        r["length"] = metrics.trajectory_length(gt[:n])
        early_ate = metrics.ate_rmse(est[:EARLY_FRAMES], gt[:EARLY_FRAMES])
        early_len = metrics.trajectory_length(gt[:EARLY_FRAMES])
        print(f"{name}: {n} frames in {wall:.2f} s = {r['fps']:.2f} fps; final stage {stage}, "
              f"tracking failures {n_fail}, Sim3 ATE {r['ate']:.4f} on a {r['length']:.3f} "
              f"path ({100 * r['ate'] / r['length']:.2f}%; over the first {EARLY_FRAMES} frames "
              f"{early_ate:.4f} on {early_len:.3f}, {100 * early_ate / early_len:.2f}%), "
              f"kernel launches {r['launches']}, "
              f"match_features calls {n_match} (max {r['per_frame_max']} per frame), "
              f"ba_update_state calls {r['ba_calls']} (tracking frames with tracking_ok "
              f"{n_ba}), ba_rejected_total {r['ba_rejected']}", flush=True)
        if stage != S.STAGE_TRACKING:
            raise AssertionError(f"{name}: the VO never reached tracking")
        if n_fail > 5:
            raise AssertionError(f"{name}: {n_fail} tracking failures (budget 5)")
        if not r["ate"] < 0.03 * r["length"]:
            raise AssertionError(f"{name}: ATE {r['ate']:.4f} is not below 3% of the path "
                                 f"length {r['length']:.3f}")
        if r["launches"] <= 0 or r["launches"] != n_match:
            raise AssertionError(f"{name}: hamming_nn_top2 launched {r['launches']} times, "
                                 f"expected {n_match} (one per match_features call)")
        if r["ba_calls"] != n_ba or (c.ba.enabled and n_ba == 0):
            raise AssertionError(f"{name}: ba_update_state ran {r['ba_calls']} times, expected "
                                 f"{n_ba} (one per tracking frame whose tracking held)")
        return r

    elapsed("phase 4, main path")
    main = run_path("main path (default config, BA on)", cfg, N_FRAMES)
    no_ba = run_path("4a BA off (cfg3)", cfg_no_ba, N_FRAMES)
    print(f"4a: in this call, BA on {main['fps']:.2f} fps against BA off {no_ba['fps']:.2f} "
          f"fps: {1e3 * (main['wall_s'] - no_ba['wall_s']) / max(main['ba_calls'], 1):.2f} ms "
          f"more per BA call", flush=True)

    elapsed("phase 4b")
    # ---- 4b. where a tracking frame's time goes (profiler window) ----------
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def device_kernels(prof):
        """(name, device ms, count) per kernel name, most time first: summed
        over the trace's device events directly (``key_averages()`` takes
        minutes over the ~10^5 events of a profiled window)."""
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        return sorted(((k, ms, n) for k, (ms, n) in by_name.items() if ms > 0),
                      key=lambda r: -r[1])

    prof_eng = VOEngine(cfg, H, W, seed=0, device="cuda")
    for f in frames[:PROFILE_FROM]:
        prof_eng.add_frame(f)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in frames[PROFILE_FROM:PROFILE_FROM + PROFILE_FRAMES]:
            prof_eng.add_frame(f)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_by_time = device_kernels(prof)
    busy_ms = sum(ms for _, ms, _ in kernels_by_time)
    n_kernels = sum(c for _, _, c in kernels_by_time)
    print(f"profile: {PROFILE_FRAMES} tracking frames ({PROFILE_FROM}..."
          f"{PROFILE_FROM + PROFILE_FRAMES - 1}, BA on), wall {prof_wall_ms:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms ({100 * busy_ms / prof_wall_ms:.1f}%), "
          f"{n_kernels} device kernels ({n_kernels / PROFILE_FRAMES:.0f} per frame)", flush=True)
    for name, ms, count in kernels_by_time[:8]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)
    ham_ms = sum(ms for n, ms, _ in kernels_by_time if "hamming_nn_top2" in n)
    ham_n = sum(c for n, _, c in kernels_by_time if "hamming_nn_top2" in n)
    print(f"profile: hamming_nn_top2 {ham_ms:.3f} ms over {ham_n} launches "
          f"({ham_ms / max(ham_n, 1):.4f} ms each, {100 * ham_ms / max(busy_ms, 1e-9):.2f}% "
          f"of device busy time)", flush=True)

    elapsed("phase 4c")
    # ---- 4c. one ba_update_state on the state after frame PROFILE_FROM+PROFILE_FRAMES
    st = prof_eng.state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any wait on the stream raises
    try:
        got = BA.ba_update_state(cfg, prof_eng.cam, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = BA.ba_update_state(cfg, prof_eng.cam, S.state_to(st, "cpu"))
    ba_err = max(float((getattr(got, f).cpu() - getattr(want, f)).abs().max())
                 for f in ("T_w_c", "ref_pose", "last_keyframe_pose"))
    ba_err = max(ba_err, float((got.ring.poses.cpu() - want.ring.poses).abs().max()),
                 float((got.map.pts.cpu() - want.map.pts).abs().max()))
    ba_ms = _events_ms(lambda: BA.ba_update_state(cfg, prof_eng.cam, st), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        BA.ba_update_state(cfg, prof_eng.cam, st)
    torch.cuda.synchronize()
    ba_wall_ms = (time.perf_counter() - t0) * 1e3 / 20
    with torch.profiler.profile(activities=acts) as prof:
        BA.ba_update_state(cfg, prof_eng.cam, st)
        torch.cuda.synchronize()
    ba_kernels = device_kernels(prof)
    with _OpCount() as ops:  # the host's side: aten ops dispatched, views included
        BA.ba_update_state(cfg, prof_eng.cam, st)
    ba_busy = sum(ms for _, ms, _ in ba_kernels)
    ba_n = sum(c for _, _, c in ba_kernels)
    share = ba_ms * main["ba_calls"] / (1e3 * main["wall_s"])
    print(f"4c: ba_update_state after frame {PROFILE_FROM + PROFILE_FRAMES}: ran under "
          f"set_sync_debug_mode('error') without a sync; card against CPU max abs diff "
          f"{ba_err:.3e} (tolerance {BA_TOL}); {ba_ms:.3f} ms per call (CUDA events over 20 "
          f"calls, host included; host clock {ba_wall_ms:.3f} ms), {ops.n} aten ops "
          f"dispatched and {ba_n} device kernels per call, device busy {ba_busy:.3f} "
          f"ms per call; x {main['ba_calls']} calls = {100 * share:.1f}% of the main path's "
          f"wall time", flush=True)
    if not ba_err <= BA_TOL:
        raise AssertionError(f"ba_update_state on the card differs from the CPU by {ba_err}")

    elapsed("phase 4d")
    # ---- 4d. the five-point configuration ----------------------------------
    five = run_path("4d five-point (essential_minimal='5pt', BA on)", cfg_5pt, N_FRAMES)
    print(f"4d: largest pose difference from the main path's trajectory "
          f"{float(np.abs(five['est'] - main['est']).max()):.3e}", flush=True)

    elapsed("phase 4e")
    # ---- 4e. the batched steady state: B streams, one vmapped step ---------
    n_steps = BATCH_FRAMES - BATCH_WARM
    engines = []
    t0 = time.perf_counter()
    for seed, (seq, _) in enumerate(batch_seqs):
        eng = VOEngine(cfg, H, W, seed=seed, device="cuda")
        for f in seq[:BATCH_WARM]:
            out = eng.add_frame(f)
        if int(out.stage) != S.STAGE_TRACKING:
            raise AssertionError(f"4e: stream {seed} is not tracking after {BATCH_WARM} frames")
        engines.append(eng)
    warm = [eng.state for eng in engines]
    cam = engines[0].cam
    print(f"4e: {BATCH_SEQS} streams warmed up single-stream over {BATCH_WARM} frames in "
          f"{time.perf_counter() - t0:.1f} s, all tracking", flush=True)

    elapsed("phase 4e, single-stream reference")
    # the single-stream reference over frames BATCH_WARM.. of each stream
    single = []
    for seed, (eng, (seq, seq_gt)) in enumerate(zip(engines, batch_seqs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [eng.add_frame(f) for f in seq[BATCH_WARM:]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        est = np.stack([o.T_w_c.numpy() for o in outs])
        single.append(dict(wall_s=wall, fps=n_steps / wall, est=est,
                           is_kf=np.array([bool(o.is_keyframe) for o in outs]),
                           ok=np.array([bool(o.tracking_ok) for o in outs]),
                           n_fail=sum(not bool(o.tracking_ok) for o in outs),
                           ate=metrics.ate_rmse(est, seq_gt[BATCH_WARM:])))
    worst_single_ate = max(r["ate"] for r in single)
    single_fps_sum = sum(r["fps"] for r in single)
    single_fps_seq = BATCH_SEQS * n_steps / sum(r["wall_s"] for r in single)
    print(f"4e single-stream reference: {n_steps} frames per stream, fps per stream "
          f"{[round(r['fps'], 3) for r in single]}, sum {single_fps_sum:.2f} fps, one stream "
          f"after another {single_fps_seq:.2f} fps; ATE {[round(r['ate'], 4) for r in single]}",
          flush=True)

    elapsed("phase 4e, batched runs")
    frames_b = torch.from_numpy(np.stack([seq[BATCH_WARM:] for seq, _ in batch_seqs])).cuda()
    # one throw-away batched step: one-time set-up (batched solvers) off the clock
    V.run_sequences_batched(cfg, cam, S.stack_states(warm[:1]), frames_b[:1, :1],
                            height=H, width=W)
    batched = {}
    for nb in BATCH_SIZES:
        sts = S.stack_states(warm[:nb])
        torch.cuda.synchronize()
        HM.hamming_nn_top2.launches = 0
        BA.ba_update_state.calls = 0
        t0 = time.perf_counter()
        final, outs = V.run_sequences_batched(cfg, cam, sts, frames_b[:nb], height=H, width=W)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, ba_calls = HM.hamming_nn_top2.launches, BA.ba_update_state.calls
        poses = outs.T_w_c.cpu().numpy()
        ok = outs.tracking_ok.cpu().numpy()
        is_kf = outs.is_keyframe.cpu().numpy()
        stages = final.stage.cpu().tolist()
        # each stream against its single-stream run, step by step (pose_distance)
        dist = [np.linalg.norm(poses[:, b, :3, 3] - single[b]["est"][:, :3, 3], axis=-1)
                for b in range(nb)]
        kf_split = [int(np.argmax(is_kf[:, b] != single[b]["is_kf"]))
                    if (is_kf[:, b] != single[b]["is_kf"]).any() else None for b in range(nb)]
        r = dict(batch=nb, wall_s=wall, fps=nb * n_steps / wall, ms_per_step=1e3 * wall / n_steps,
                 launches=launches, ba_calls=ba_calls, n_fail=(~ok).sum(0).tolist(),
                 stage=stages, ate=[metrics.ate_rmse(poses[:, b], batch_seqs[b][1][BATCH_WARM:])
                                    for b in range(nb)],
                 first_step_dist=[float(d[0]) for d in dist], max_dist=[float(d.max()) for d in dist],
                 first_kf_split=kf_split)
        batched[nb] = r
        print(f"4e batched B={nb}: {n_steps} steps in {wall:.2f} s = {r['fps']:.2f} fps aggregate "
              f"({r['ms_per_step']:.1f} ms per batched step; single-stream in this call: sum "
              f"{single_fps_sum:.2f} fps, one after another {single_fps_seq:.2f} fps); matcher "
              f"launches {launches}, ba_update_state calls {ba_calls}; tracking failures "
              f"{r['n_fail']}, final stages {stages}, ATE {[round(a, 4) for a in r['ate']]} "
              f"(single-stream {[round(s_['ate'], 4) for s_ in single[:nb]]}); against the "
              f"single-stream run: first-step pose distance "
              f"{[float(f'{d:.3g}') for d in r['first_step_dist']]}, first step whose keyframe "
              f"decision differs {kf_split}, largest pose distance "
              f"{[float(f'{d:.3g}') for d in r['max_dist']]}", flush=True)
        if launches != 2 * n_steps:
            raise AssertionError(f"4e B={nb}: {launches} matcher launches, expected "
                                 f"{2 * n_steps} (tracking and keyframe update, per step)")
        if ba_calls != n_steps:
            raise AssertionError(f"4e B={nb}: {ba_calls} ba_update_state calls, expected {n_steps}")
        for b in range(nb):
            ref = single[b]["ate"]
            if stages[b] != S.STAGE_TRACKING or r["n_fail"][b] > 5:
                raise AssertionError(f"4e B={nb}: stream {b} stage {stages[b]}, "
                                     f"{r['n_fail'][b]} tracking failures (budget 5)")
            # the same state, frame and draws: the first step is the
            # single-stream step up to rounding
            if not (dist[b][0] < 1e-3 and is_kf[0, b] == single[b]["is_kf"][0]
                    and ok[0, b] == single[b]["ok"][0]):
                raise AssertionError(f"4e B={nb}: stream {b}'s first step is not its "
                                     f"single-stream step (pose distance {dist[b][0]:.3g})")
            # at B=1 the kernels are the single-stream ones: the whole run too
            if nb == 1 and (kf_split[b] is not None or not dist[b].max() < 1e-3):
                raise AssertionError(f"4e B=1: the run parts from the single-stream run "
                                     f"(keyframe decisions from step {kf_split[b]}, pose "
                                     f"distance up to {dist[b].max():.3g})")
            # At B > 1 the batched ops round differently (other GEMM and
            # reduction shapes), a keyframe decision can flip and the keys then
            # part, so the run is another run of the stream: its ATE is held to
            # the band, or to the worst single-stream ATE of this call.
            if not (abs(r["ate"][b] - ref) <= max(0.02, 0.5 * ref)
                    or r["ate"][b] <= worst_single_ate):
                raise AssertionError(f"4e B={nb}: stream {b} ATE {r['ate'][b]:.4f} is neither "
                                     f"within max(0.02, half) of its single-stream ATE "
                                     f"{ref:.4f} nor below the worst single-stream ATE "
                                     f"{worst_single_ate:.4f}")

    elapsed("phase 4e, profile")
    # device kernels per batched step and the busy share (profiler)
    for nb in BATCH_SIZES:
        sts = S.stack_states(warm[:nb])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(BATCH_PROFILE_STEPS):
                sts, _ = V.step_tracking_batched(cfg, cam, sts, frames_b[:nb, i], height=H,
                                                 width=W)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ks = device_kernels(prof)
        busy = sum(ms for _, ms, _ in ks)
        n_k = sum(c for _, _, c in ks)
        batched[nb].update(kernels_per_step=n_k / BATCH_PROFILE_STEPS,
                           busy_ms_per_step=busy / BATCH_PROFILE_STEPS,
                           busy_share=busy / wall_ms)
        print(f"4e profile B={nb}: {BATCH_PROFILE_STEPS} batched steps, wall {wall_ms:.1f} ms "
              f"under the profiler, device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
              f"{n_k / BATCH_PROFILE_STEPS:.0f} device kernels per batched step", flush=True)
        for name, ms, count in ks[:4]:
            print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)
    ratio = batched[BATCH_SIZES[-1]]["kernels_per_step"] / batched[1]["kernels_per_step"]
    print(f"4e: device kernels per batched step, B={BATCH_SIZES[-1]} against B=1: {ratio:.3f}x "
          f"(limit {KERNELS_PER_STEP_RATIO}x)", flush=True)
    if ratio > KERNELS_PER_STEP_RATIO:
        raise AssertionError(f"4e: B={BATCH_SIZES[-1]} issues {ratio:.2f}x the kernels of B=1 "
                             f"per batched step: a per-stream loop in the step?")

    elapsed("phase 4e, no waits")
    # the vmapped body of one B=8 step never waits on the host
    sts = S.stack_states(warm[:BATCH_SIZES[-1]])
    imgs = frames_b[:BATCH_SIZES[-1], 0].float()
    draws = V.draw_batched(cfg, sts.rng, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        V.tracking_batched_body(cfg, cam, sts, imgs, draws, height=H, width=W)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"4e: the vmapped body of a B={BATCH_SIZES[-1]} step ran under "
          f"set_sync_debug_mode('error') without a sync", flush=True)

    elapsed("phase 4e, card against CPU")
    # one B=2 step on the card against a CPU copy fed the same draws
    sts = S.stack_states(warm[:2])
    imgs = frames_b[:2, 0].float()
    draws = V.draw_batched(cfg, sts.rng, "cuda")
    _, got = V.step_tracking_batched(cfg, cam, sts, imgs, height=H, width=W, draws=draws)
    _, want = V.step_tracking_batched(
        cfg, cam, S.state_to(sts, "cpu"), imgs.cpu(), height=H, width=W,
        draws=V.BatchedDraws(*(None if d is None else d.cpu() for d in draws)))
    got = S.StepOutput(*(t.cpu() for t in got))
    # the features round differently on the card (the pyramid's GEMMs, the box
    # sums), so a near-tied keypoint can move one match: the counts that
    # follow from the matches agree within 5%, the rest exactly
    exact = ("stage", "n_keypoints", "n_candidates", "is_keyframe", "tracking_ok",
             "ba_rejected_total")
    close = ("n_matches", "n_inliers", "n_map_points")
    dists = [float(lie.pose_distance(got.T_w_c[b], want.T_w_c[b])) for b in range(2)]
    print(f"4e: one B=2 step, card against CPU with the same draws (card/CPU): "
          + ", ".join(f"{f} {getattr(got, f).tolist()}/{getattr(want, f).tolist()}"
                      for f in exact + close)
          + f"; pose distance {dists}", flush=True)
    for f in exact:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"4e: card and CPU differ in {f}")
    for f in close:
        g, w_ = getattr(got, f), getattr(want, f)
        if not ((g - w_).abs() <= 0.05 * w_).all():
            raise AssertionError(f"4e: card and CPU {f} differ by more than 5%")
    if not max(dists) < 1e-3:
        raise AssertionError(f"4e: card and CPU poses differ by {max(dists)}")

    elapsed("phase 5")
    # ---- 5. kernels line and device line ---------------------------------
    track = shape_rows[1]
    kernels = [{
        "name": "hamming_nn_top2",
        "route": "cuda",
        "source": "monocular_visual_odometry_tpu_torch/csrc/hamming_nn_top2.cu",
        "replaces": "monocular_visual_odometry_tpu/ops/pallas/hamming.py:125",
        "launches": main["launches"],
        "exact": True,
        "max_abs_err": max_err,
        "ms": track["ms"],
        "kernel_ms": track["ms"],
        "plain_ms": track["plain_ms"],
        "bound_ms": track["bound_ms"],
        "bound_by": track["bound_by"],
        "library_ms": track["library_ms"],
        "library": "torch.matmul bf16 +/-1 distance product only (partial yardstick)",
        "eager_ms": track["eager_ms"],
        "launch_floor_ms": track["launch_floor_ms"],
        "pr1_ms": track["pr1_ms"],
        "design": DESIGN,
        "main_path_ms_per_launch": ham_ms / max(ham_n, 1),
        "shapes": shape_rows,
        "batched_shapes": batched_rows,
        "batched_launches": {str(nb): r["launches"] for nb, r in batched.items()},
        "batched_steps": n_steps,
        "batched_fps": {str(nb): r["fps"] for nb, r in batched.items()},
        "single_stream_fps_sum": single_fps_sum,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
