#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into a pass):

1. environment: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA kernel of ``monocular_visual_odometry_tpu_torch/
   csrc`` with nvcc for sm_90a (one nvcc per source, started together);
3. kernels: calls each kernel's wrapper on the card at the main path's shapes
   and at edge cases and requires ``torch.equal`` with its plain PyTorch
   version; times kernel, plain version and a library yardstick with CUDA
   events, and works out the least time the card needs for the same work;
4. main path: renders the 150-frame synthetic benchmark in memory and runs the
   port's ``VOEngine`` (default config at full width, BA off) on ``cuda``;
   checks that it reaches tracking, fails tracking on at most 5 frames, keeps
   the Sim(3) ATE under 3% of the path length, and that every kernel of the
   path launched (counts reset just before the run, read just after);
   then profiles a window of steady tracking frames with ``torch.profiler``
   and prints the device-busy share and the kernels that take the most time;
5. prints one JSON line describing the kernels, then, as the last line, the
   device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 150
H, W = 480, 640
PROFILE_FROM, PROFILE_FRAMES = 40, 20  # a steady tracking window
# popcount throughput per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
POPC_PER_SM_CLK = 16
LOGIC_PER_SM_CLK = 64    # 32-bit bitwise AND/OR/XOR, same table
GRAPH_CALLS = 20         # calls captured in one CUDA graph for device timing
FP32_PEAK = 67e12        # H100 SXM, non-tensor fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12


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
    (what a caller pays, host included) from plain back-to-back calls."""
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
    return device_ms, _events_ms(fn, iters)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.ops.cuda import build
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.utils import metrics
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    # ---- 1. environment --------------------------------------------------
    card = _nvidia_smi("name,power.limit")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- 2. build (one nvcc per source, all started together) -------------
    sources = sorted(p[:-3] for p in os.listdir(build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        built = dict(zip(sources, ex.map(build.build, sources)))
    print(f"build: {len(sources)} kernel source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (path, secs, log) in built.items():
        print(f"  {name}: {path.name} ({secs:.2f} s)\n{log.strip()}", flush=True)

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
                  ("ragged", _hamming_inputs(1000, 777, 15, alt=True), 80.0)]
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    popc_rate = n_sm * POPC_PER_SM_CLK * clock_mhz * 1e6
    logic_rate = n_sm * LOGIC_PER_SM_CLK * clock_mhz * 1e6

    def check(tag, args, r):
        d1, uv1, v1, d2, uv2, v2, alt = args
        got = HM.hamming_nn_top2(d1, uv1, v1, d2, uv2, v2, r, uv1_alt=alt)
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

    shape_rows = []
    for i, (tag, k1, k2, r, alt) in enumerate(main_shapes):
        args = _hamming_inputs(k1, k2, 100 + i, alt=alt)
        max_err = max(max_err, check(tag, args, r))
        d1, uv1, v1, d2, uv2, v2, uv1_alt = args
        ms, eager_ms = _time_ms(lambda: HM.hamming_nn_top2(*args[:6], r, uv1_alt=uv1_alt), 100)
        plain_ms, plain_eager_ms = _time_ms(
            lambda: HM.hamming_nn_top2_reference(*args[:6], r, uv1_alt=uv1_alt), 20)
        a = HM.unpack_pm1(d1).to(torch.bfloat16)
        b = HM.unpack_pm1(d2).to(torch.bfloat16)
        library_ms, _ = _time_ms(lambda: torch.matmul(a, b.T), 100)
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
        row = dict(shape=tag, k1=k1, k2=k2, r=r, union_gate=alt, ms=ms, eager_ms=eager_ms,
                   plain_ms=plain_ms, plain_eager_ms=plain_eager_ms, library_ms=library_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   gated_pairs=pairs, bytes=nbytes)
        shape_rows.append(row)
        print(f"kernel hamming_nn_top2 {tag} {k1}x{k2} r={r}: equal; "
              f"device: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 matmul "
              f"{library_ms:.4f} ms; eager: kernel {eager_ms:.4f} ms, plain {plain_eager_ms:.4f} ms; "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), {pairs} gated pairs",
              flush=True)

    # ---- 4. main path -----------------------------------------------------
    t0 = time.perf_counter()
    frames, gt = syn.render_sequence_arrays(N_FRAMES, seed=0, height=H, width=W,
                                            translation_step=0.04)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = VOConfig()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=False))
    warm = VOEngine(cfg, H, W, seed=0, device="cuda")  # library init off the clock
    for f in frames[:4:3]:
        warm.add_frame(f)
    eng = VOEngine(cfg, H, W, seed=0, device="cuda")
    torch.cuda.synchronize()

    HM.hamming_nn_top2.launches = 0
    est, n_fail, n_match_calls, stage, per_frame = [], 0, 0, S.STAGE_BLANK, []
    t0 = time.perf_counter()
    for f in frames:
        before = HM.hamming_nn_top2.launches
        out = eng.add_frame(f)
        per_frame.append(HM.hamming_nn_top2.launches - before)
        n_match_calls += {S.STAGE_BLANK: 0, S.STAGE_INITIALIZING: 1}.get(
            stage, 1 + int(bool(out.is_keyframe)))
        stage = int(out.stage)
        if stage == S.STAGE_TRACKING and not bool(out.tracking_ok):
            n_fail += 1
        est.append(out.T_w_c.numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = HM.hamming_nn_top2.launches

    est = np.stack(est)
    if not np.isfinite(est).all():
        raise AssertionError("non-finite pose in the trajectory")
    ate = metrics.ate_rmse(est, gt)
    length = metrics.trajectory_length(gt)
    print(f"main path: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.2f} fps; "
          f"final stage {stage}, tracking failures {n_fail}, Sim3 ATE {ate:.4f} on a "
          f"{length:.3f} path ({100 * ate / length:.2f}%), kernel launches {launches}, "
          f"match_features calls {n_match_calls}, launches per frame max {max(per_frame)} "
          f"mean {launches / N_FRAMES:.3f}", flush=True)
    if stage != S.STAGE_TRACKING:
        raise AssertionError("the VO never reached tracking")
    if n_fail > 5:
        raise AssertionError(f"{n_fail} tracking failures (budget 5)")
    if not ate < 0.03 * length:
        raise AssertionError(f"ATE {ate:.4f} is not below 3% of the path length {length:.3f}")
    if launches <= 0 or launches != n_match_calls:
        raise AssertionError(f"hamming_nn_top2 launched {launches} times, expected "
                             f"{n_match_calls} (one per match_features call)")

    # ---- 4b. where a tracking frame's time goes (profiler window) ----------
    prof_eng = VOEngine(cfg, H, W, seed=0, device="cuda")
    for f in frames[:PROFILE_FROM]:
        prof_eng.add_frame(f)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in frames[PROFILE_FROM:PROFILE_FROM + PROFILE_FRAMES]:
            prof_eng.add_frame(f)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_by_time = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels_by_time)
    print(f"profile: {PROFILE_FRAMES} tracking frames ({PROFILE_FROM}..."
          f"{PROFILE_FROM + PROFILE_FRAMES - 1}), wall {prof_wall_ms:.1f} ms under the profiler, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / prof_wall_ms:.1f}%), "
          f"{sum(c for _, _, c in kernels_by_time)} device kernels", flush=True)
    for name, ms, count in kernels_by_time[:8]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)
    ham_ms = sum(ms for n, ms, _ in kernels_by_time if "hamming_nn_top2" in n)
    ham_n = sum(c for n, _, c in kernels_by_time if "hamming_nn_top2" in n)
    print(f"profile: hamming_nn_top2 {ham_ms:.3f} ms over {ham_n} launches "
          f"({ham_ms / max(ham_n, 1):.4f} ms each, {100 * ham_ms / max(busy_ms, 1e-9):.2f}% "
          f"of device busy time)", flush=True)

    # ---- 5. kernels line and device line ---------------------------------
    track = shape_rows[1]
    kernels = [{
        "name": "hamming_nn_top2",
        "route": "cuda",
        "source": "monocular_visual_odometry_tpu_torch/csrc/hamming_nn_top2.cu",
        "replaces": "monocular_visual_odometry_tpu/ops/pallas/hamming.py:125",
        "launches": launches,
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
        "main_path_ms_per_launch": ham_ms / max(ham_n, 1),
        "shapes": shape_rows,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
