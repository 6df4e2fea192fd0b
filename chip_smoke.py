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
   path's r (all of it); then the BA LM kernel (``ba_lm_pose``, BA_SHAPES:
   the live window, in float64 too, the parity width, an 8-frame window and
   the batch cell's B = 25 as one vmapped launch) against its plain version
   (``models/ba.py::lm_loop``) on the card, poses within BA_TOL, each
   stream of the batched launch equal to its own launch, one launch per
   call; its device and eager ms beside the plain version's, and its bound;
4. main path: renders the 150-frame synthetic benchmark in memory and runs the
   port's ``VOEngine`` (default config at full width, windowed BA on) on
   ``cuda``: the graph route, one replay of a captured stage program and one
   readback per frame; checks that it reaches tracking, fails tracking on at
   most 5 frames, keeps the Sim(3) ATE under 3% of the path length, that
   every kernel of the path launched once per ``match_features`` call
   (counted per replay: a tracking frame runs the keyframe update's match
   too), ``ba_update_state`` was computed once per tracking frame (applied
   where ``tracking_ok`` held) and launched ``ba_lm_pose`` once per call
   (this check also holds in 4c, 4e, 4f, 4g, 4i, 4j and 4k), one replay per frame (counts reset just
   before the run, read just after), and prints each stage's warm-up and
   capture seconds; in turns with it (graph, eager, eager, graph) the eager
   host-branch ``step`` over the same frames (BA computed where
   ``tracking_ok`` held), which the graph route must match: the same init
   frame and keyframe decisions, pose distance <= 1e-4 on every frame;
   4a. the same with BA off (graph, then eager), for the fps beside BA on in
   this call; then ``add_frame``'s readback over 20 tracking frames: after
   ``step`` returns, the ``StepOutput`` comes back with exactly one
   synchronizing call (counted with ``torch.cuda.set_sync_debug_mode("warn")``),
   equal field by field to a ``.cpu()`` per field (which waits once per
   field), and the host ms of both, in turns; and the graph route's whole
   ``add_frame`` over the same frames: exactly one synchronizing call;
   4b. profiles a window of steady tracking frames (BA on) with
   ``torch.profiler`` (device activity), the graph route's replays and the
   eager step's frames, and prints kernels per frame, the device-busy share
   and the kernels that take the most time; the replays must show
   ``hamming_nn_top2`` twice per frame;
   4c. runs one ``ba_update_state`` on the state after that window under
   ``torch.cuda.set_sync_debug_mode("error")`` (the LM never waits on the
   host), holds it against the same call on a CPU copy of the state, times
   it with CUDA events and counts its device kernels;
   4d. runs the five-point configuration (``essential_minimal="5pt"``, BA
   on) over the 150 frames with the checks of phase 4 (the 3% ATE budget is
   one of the whole path; each run also prints its ATE over the first 60
   frames, which reads higher) on the graph route, whose every stage is a
   graph (the init's ``eigh`` is the Jacobi of ``ops/lie.py`` there:
   captured stages [0, 1, 2], one replay per frame), in turns with the eager
   ``step`` (graph, eager, eager, graph: the same init frame, keyframe and
   tracking decisions, pose distance <= 1e-4 on every frame); prints which
   model won on each init frame; calls a captured init program once more
   under ``set_sync_debug_mode("error")`` and profiles one replay (device
   kernels and ms), and the Jacobi ``eigh`` per call at the solver's shapes
   (64 9x9, 64x8 10x10, float64); and on every init frame holds the card's
   five-point E-RANSAC (captured) against the same call on a CPU copy
   (LAPACK) with the same draws: inlier counts and the largest difference
   in E up to sign, printed (the two bases are two charts of one solution
   set, so a root one misses can change the winner);
   4e. the batched steady state (``run_sequences_batched``, one replay of the
   captured body per step; each B captured off the clock): eight 60-frame
   sequences (seeds 0-7), each warmed up single-stream over 15 frames, then
   frames 15-59 single-stream (the reference) and batched at B = 1, 2, 4, 8,
   at B = 1 and 8 also the eager vmapped body over the same steps (every
   decision equal, poses within 1e-4, its fps beside the graph's);
   checks 2 matcher launches and 1 ``ba_update_state`` call per batched step
   whatever B, every stream tracking (<= 5 failures), its first step its
   single-stream step up to rounding (pose distance < 1e-3, same decisions),
   the whole B=1 run the single-stream run, and its ATE within max(0.02,
   half) of its single-stream ATE or not above the worst single-stream ATE
   of the call (at B > 1 rounding can flip a keyframe decision, after which
   the keys part and the run is another run); profiles 2 batched steps at
   B = 1 and 8, graph and eager (device kernels per step: B=8 at most 1.5x
   B=1), runs one B=8 vmapped body under ``set_sync_debug_mode("error")``,
   counts one wait in a graph-route B=8 step, and holds one B=2 step
   against a CPU copy fed the same draws (matches, inliers and map points within 5%, the
   other counts equal, poses within 1e-3);
   4f. the command-line entry point: writes phase 4's 150 frames and their
   ground truth with the port's PNG writer and trajectory I/O to
   ``build/cli/synthetic_seq/`` and times the port's PNG decode over them
   (one call after another, and the prefetching loader); runs
   ``cli.main(["--synthetic", ...])`` in-process (``--checkpoint-every 50
   --viewer --save-frames``) and checks exit 0, the loader line, 150 rows
   in ``cam_traj.txt``, Sim(3) ATE < 3% of the path, <= 5 ``TRACK-FAIL``
   banners, matcher launches = ``match_features`` calls and BA calls =
   tracking frames (both read from the banners: the CLI's engine is the
   graph route), the
   viewer, the 150 annotated frames and the three checkpoints; prints the
   largest pose distance to phase 4's run of the same frames (and, if it is
   above 1e-4, runs phase 4's engine again to show whether two runs on the
   card part: then the budgets are the check); resumes a fresh engine from
   ``state_00099.npz`` over frames 100-149 against the CLI's rows, twice
   (the frames from memory, then through the loader) and prints the host ms
   per frame of each beside phase 4's and the CLI's own step time; runs
   ``python3 -m monocular_visual_odometry_tpu_torch.cli --config`` as a
   subprocess on a reference-layout YAML over 30 frames (exit 0, 30 rows,
   an ATE in ``report.json``); prints the CLI's fps beside phase 4's;
   4g. the paths the scene generators and camera tools open, each through
   ``VOEngine`` on the card at the depth its budgets were set at, with the
   launch and BA counts of phase 4: planar init (``planar_scene``, 40 frames)
   under the reference (ORB-SLAM score) and the tournament selection rule at
   512 keypoints, gated as ``tests/test_planar_sequence.py`` (tracking,
   0 < init frame <= 15, H at init under the reference rule, ATE < 8% of the
   path, ``tracking_ok`` on >= N - init - 2 frames), and at 1024 keypoints
   (recorded); the robustness matrix of ``tests/test_robustness.py`` (150
   frames, default config: seven perturbations, each within its ATE and
   end-drift budgets, and the severe case, ATE < 30%); calibrate (10
   chessboard views, rms < 0.1 px) -> distort 40 ideal renders with the true
   lens -> undistort with the calibrated one -> track with the calibrated
   intrinsics (ATE < 6%), and the undistort loop of
   ``tests/test_undistort_loop.py`` (clean, undistorted, raw distorted);
   bench's reference-parity cfg6 (1500 keypoints, reference rule, keyframe
   E-RANSAC filter, last-W-frames BA window) over phase 4's 150 frames (ATE
   < 3%, <= 5 failures), its fps beside phase 4's; every cell but cfg6 runs
   in a pool of four processes, four at once (their fps is with the others
   running);
   4h. the mesh route (``parallel/``: BA sharded over the ranks of a process
   group, ``VOEngine(mesh=...)``): (a) a one-rank NCCL world over a file store
   in ``build/4h/``: the default config over phase 4's 150 frames with phase
   4's budgets on the stage programs (every stage a graph, the tracking
   graph replaying the sharded BA's NCCL collectives: one replay per frame)
   in turns with the eager ``step(mesh=...)`` (graph, eager, graph: the
   same decisions, pose distance <= 1e-4), matcher launches =
   ``match_features`` calls and ``ba_update_state_dist`` calls = tracking
   frames on each, the same collectives (primitive and bytes) on every
   tracking frame of every run and none elsewhere, one wait per
   ``add_frame`` over 20 tracking frames, the largest pose distance to phase
   4's run and the fps beside it; (b) tests/test_dist_pipeline.py's
   512-keypoint configuration over its 18 frames, landmarks fixed and joint,
   the mesh route against the single-device route with that test's gates; (c)
   two processes on the one card over gloo (NCCL refuses two ranks on one
   device): ``python -m ...parallel.multihost`` at its defaults and with
   ``--deterministic``, with tests/test_multihost.py's gates, then the mesh
   route at full width over (b)'s frames in both modes (each rank's poses
   equal rank 0's bitwise, (b)'s gates against (a)'s one-rank engine); (d)
   ``scaling.make_problem``'s live shape (W 5, K 1,024, M 4,096, 20 LM
   iterations, joint) at D = 1 (NCCL) and D = 2 (gloo): ms per solve by CUDA
   events and by the host clock and device kernels per solve, beside the
   single-device ``ba_solve`` in turns, and one LM iteration's collectives
   equal to ``scaling.comm_model``'s terms at that D; and, in a process of its
   own started with (c), NCCL's collective timeout: a
   collective enqueued behind a kernel that holds the stream longer than the
   timeout is flagged by the watchdog when the timeout passes, and the
   process ends with a non-zero code (eager collectives: the watchdog does
   not track a collective replayed from a graph);
   4i. the general step (``run_sequences_general``: B streams in any stage in
   one vmapped step, one replay of the captured body per step, JAX's
   ``profile_throughput.py`` "general" protocol) over 4e's eight 60-frame
   sequences from fresh states keyed 0..B-1, so every stream goes through
   init, at B = 1 and 8, each beside the eager body over the same steps (as
   in 4e): aggregate fps beside 4e's tracking-only B=8 rate and the
   single-stream rate of the call; 3 matcher
   launches (init, tracking, keyframe update) and 1 ``ba_update_state``
   call per step whatever B; every stream tracking (<= 5 failures), its
   first step its single-stream step, the whole B=1 run the single-stream
   run (4e's run of the same stream from frame 0), the ATE rule of 4e;
   device kernels and busy share over 2 profiled steps, graph and eager (B=8
   at most 1.5x B=1); one mixed-stage B=5 step (blank, a failing and a succeeding init
   attempt, tracking, tracking on a blank frame) whose body runs under
   ``set_sync_debug_mode("error")``, equal to ``step`` per stream (decisions,
   next keys, poses within 1e-3) and to the same step on a CPU copy fed the
   same draws (4e's budgets); then the general step under the five-point
   solver at B = 8 over the 60 frames from fresh states, its captured body
   (3 matcher launches, 1 BA call and 1 replay per step, every stream
   tracking) against the eager body over its first 20 steps (the same
   decisions, poses within 1e-4), and 2 profiled steps (device kernels);
   4e and 4i print the card's memory (reserved, allocated) before and after
   each capture of a batched body;
   4j. the JAX package's evaluation configurations at their depth (150
   frames, seeds 0-4): (a) ``profile_fivepoint_ab.py``'s two-view A/B (12
   seeds at outlier fractions 0, 0.2, 0.4, 0.6, 5pt and 8pt, each seed's
   draws made on the host) on the card's route (Jacobi ``eigh`` and 3x3
   SVD), beside the CPU's (LAPACK) and the card's route forced on the CPU,
   both in processes of their own, and FIVEPOINT_AB_r04.json; the card's
   five-point medians within 1.25x + 0.05 deg (rotation) and 1.25x + 0.5
   deg (translation direction) of LAPACK's, failures within one, at every
   fraction; at fraction 0 the card's rotation per seed, read on the
   nearest rotation, within 0.01 deg of LAPACK's; (b) the four tracking
   profiles of ``profile_robustness_r5.py`` (reference_parity,
   predict_only, default, robust) over its four scene and trajectory
   combinations, the default also with the five-point
   solver and over the undistortion rows (the lens distorted, and
   undistorted), and the BA variants of ``profile_ba_ablation.py`` (BA on,
   off, the 3 px re-gate) over its five rows: each configuration's streams
   (sequences x seeds, from fresh ``init_state``s) through one captured
   general batched body (``run_sequences_general``, at most 25 streams a
   batch), 3 matcher launches, 1 ``ba_update_state`` call (0 with BA off)
   and 1 replay per step, its memory at capture, each configuration's
   program released after its rows (``vo.release_batched``); per row the
   port's mean, min and max Sim(3) ATE and final drift (% of the path),
   median init frame, failed seeds and where E won at init, beside the JAX
   rows of ROBUSTNESS_r05.json and BA_ABLATION_r05.json: the same failed
   seeds (0) and a mean ATE at most JAX's worst seed + 1.5 pp (JAX's own
   spread between two compiles of one program);
   4k. the JAX repo's stage-level profiling tools (``tests/stage_protocol.py``;
   ``profile_bisect.py``, ``profile_scan.py``, ``profile_iso.py``,
   ``profile_ba_floor.py``, ``profile_init.py``), each piece captured as one
   CUDA graph with fixed inputs and replayed: 20 replays timed between two
   CUDA events, twice in turns, and 5 profiled (device kernels, busy ms and
   matcher kernels per call, the top 5 kernels). (a) On
   ``profile_ba_floor.py``'s state (16 frames of ``make_trajectory(16, 0,
   0.05)``) and its next frame, with the tracking program's draws: the
   prefixes a (features), b (+ frustum scan, union gate, candidate
   compaction), c (+ the match), d (+ RANSAC-PnP), e (``step_track``), each
   stage's own share as the difference of consecutive prefixes;
   ``ba_update_state``, ``keyframe_update`` and the glue of the tracking
   program (its two selects and its tail), beside one replay of
   ``StagePrograms``' tracking program on the same state and frame: the
   pieces' kernels add up to the program's within 2%, their busy time within
   10%, no stage reads negative, the matcher runs once in c, d, e and the
   keyframe update and twice in the program; ``ba_update_state`` at 1, 2, 4,
   8 and 12 LM iterations with the per-iteration and fixed costs of a linear
   fit, at 12 the kernels of phase 4c's call, and ``gather_window`` +
   ``ba_solve`` + ``write_back`` within 10% of its busy time. (b) bench.py
   cfg1's ``init_pair`` (frames 0 and 3 of phase 4's sequence, written as
   PNGs and read back through the port's loader) as pieces A (features x2),
   B (+ match), C (+ ``estimate_relative_pose``), D (the two-view estimate
   alone on B's points) under the 8-point and five-point solvers: C must give
   the init stage program's R, t and inliers on the same pair and draws. (c)
   ``profile_drift_ab.py``'s BA window rows (last 5 frames, keyframe window
   of 5 and of 8) over ``make_trajectory(150, 0, 0.05)`` and
   ``profile_adversarial.py``'s family C (``planar_scene()`` x
   ``make_planar_trajectory(90)``) under both selection rules, one stream
   each through a captured general batched step: every row tracks with <= 5
   failures, the drift rows under 3% ATE and the first two within JAX's ATE
   + 1.5 pp, family C's init frame within 2 of JAX's 8 and its ATE at most
   1.49% + 1.5 pp; prints the phase's seconds;
5. prints one JSON line describing the kernels, then, as the last line, the
   device JSON.

Phase 3's shapes include the tracking call without the union gate
(1536x1024 r=50, the profiles reference_parity and predict_only), cfg6's
(1500x1500 r=100, 1536x1500 r=50) and the planar width's (512x512 r=100,
1536x512 r=50). It also holds batched
launches (B streams in one launch: B=8 at the tracking and keyframe shapes,
B=3 ragged with a stream without valid queries and one with a single valid
train point, B=3 with K2=1) against the plain version per stream and times
one batched launch against B single launches.
The sequences are rendered by a pool of processes at the start of phase 4.
Phase 4h starts this script again as its child processes (``--nccl-timeout``,
``--mesh-rank``, ``--live-rank``: see :func:`_child`); run with no arguments,
it runs every phase.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 150
H, W = 480, 640
PROFILE_FROM, PROFILE_FRAMES = 40, 10  # a steady tracking window
WARM_FRAMES = 10         # frames of a throw-away engine per config, to reach BA
BA_TOL = 1e-4            # ba_update_state, card against CPU (tests/test_torch_cuda.py)
EARLY_FRAMES = 60        # also read the ATE over these first frames: the 3% budget
                         # is one of the whole path, and a short run reads higher
# popcount throughput per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
POPC_PER_SM_CLK = 16
LOGIC_PER_SM_CLK = 64    # 32-bit bitwise AND/OR/XOR, same table
GRAPH_CALLS = 20         # calls captured in one CUDA graph for device timing
# phase 4e: streams, frames, warm-up; the ATE band of its B > 1 runs holds at
# 60 frames, not at 45
BATCH_SEQS, BATCH_FRAMES, BATCH_WARM = 8, 60, 15
BATCH_SIZES = (1, 2, 4, 8)
BATCH_PROFILED = (1, 8)  # the batch sizes 4e profiles (their kernel counts are compared)
BATCH_PROFILE_STEPS = 2  # profiled steps per batch size (the profiler's events are slow)
CLI_CHECKPOINT_EVERY, CLI_RESUME_FROM = 50, 100  # phase 4f: resume from state_00099.npz
CLI_CONFIG_FRAMES = 30   # phase 4f: frames of the --config run
POSE_TOL = 1e-4          # phase 4f: CLI and resumed poses against the in-process runs
ROUTE_TOL = 1e-4         # phase 4: the graph route against the eager step, pose distance
KERNELS_PER_STEP_RATIO = 1.5  # B=8 device kernels per batched step, at most x B=1's
# phase 4i: the general step (JAX's profile_throughput.py "general"), over 4e's
# eight sequences from fresh states keyed 0..B-1
GENERAL_SIZES = (1, 8)
GENERAL_PROFILE_STEPS = 2
GENERAL_5PT_EAGER_STEPS = 20  # 4i under 5pt: the eager body over the first steps (init at 6)
# phase 4j: the JAX package's evaluation configurations at their depth
# (profile_robustness_r5.py, profile_ba_ablation.py: 150 frames, seeds 0-4;
# profile_fivepoint_ab.py: 200 points, 0.5 px noise, 12 seeds, 256 hypotheses)
EVAL_FRAMES = 150
EVAL_SEEDS = (0, 1, 2, 3, 4)
EVAL_MAX_B = 25          # streams per general batched step; more go into batches of one B
EVAL_BAND_PP = 1.5       # a row's mean ATE may exceed JAX's worst seed by this (its
                         # compile_variance: a recompile alone moved a row's mean 1.5 pp)
EVAL_DIST = np.array([-0.30, 0.09])  # profile_robustness_r5.py's undistortion rows
# the five-point A/B's protocol and gate, and the configurations: tests/eval_protocol.py;
# at outlier fraction 0 the card's nearest rotation per seed within this of the CPU's (deg)
AB_ORTH_TOL = 0.01
# phase 4k: the JAX repo's stage-level profiling tools (tests/stage_protocol.py)
STAGE_TIMED = 20         # replays of a piece timed between two CUDA events, per turn
STAGE_PROFILED = 5       # replays of a piece under the profiler
PROFILE_MARKERS = 4096   # spin kernels before and after a profiled window (_markers)
SPLIT_KERNEL_TOL, SPLIT_BUSY_TOL = 0.02, 0.10  # e + ba + keyframe + glue against the program
BA_PARTS_TOL = 0.10      # gather_window + ba_solve + write_back against ba_update_state, busy
# matcher launches per call where the path runs the matcher (the rest: none)
MATCHER_PER_CALL = {"c": 1, "d": 1, "e": 1, "keyframe": 1, "program": 2, "B": 1, "C": 1}
# profile_drift_ab.py's rows (keyframe_window, window) over make_trajectory(150, 0, 0.05);
# JAX's ATE and final drift, % of the path (docs/PARITY.md, CPU)
DRIFT_ROWS = ((False, 5), (True, 5), (True, 8))
DRIFT_JAX = {(False, 5): (2.24, 8.75), (True, 5): (1.79, 3.20)}
# profile_adversarial.py's family C: planar_scene() x make_planar_trajectory(90);
# JAX: ROBUSTNESS_r04.json families.C_planar (both rules)
PLANAR_C_FRAMES = 90
PLANAR_C_JAX = dict(init=8, ate=1.49)
PLANAR_C_INIT_TOL = 2
# phase 4j's sequences: the four of profile_robustness_r5.py's families, the
# ablation's rows (benchmark_clean is family A's clean sequence), the
# undistortion rows
EVAL_FAMILY = ("adv_scene+bench_traj", "bench_scene+adv_traj", "adv_scene+adv_traj", "A_clean")
EVAL_ABLATION = {"benchmark_clean": "A_clean", "benchmark_noise10": "benchmark_noise10",
                 "benchmark_noise20": "benchmark_noise20", "adversarial": "adversarial",
                 "adversarial_noise10": "adversarial_noise10"}
EVAL_UNDISTORT = ("distorted_raw", "undistorted")
# (render kind, (scene seed, trajectory seed), translation step) of each
# rendered sequence; A_clean is phase 4g's robustness sequence
EVAL_RENDER = {"adv_scene+bench_traj": ("adv_bench", (100, 0), 0.05),
               "bench_scene+adv_traj": ("bench_adv", (0, 0), 0.05),
               "adv_scene+adv_traj": ("adv_adv", (100, 0), 0.05),
               "adversarial": ("adv_adv", (1, 1), 0.05)}
# the order 4j runs its configurations in
EVAL_ORDER = ("reference_parity", "predict_only", "robust", "default_5pt", "ba_off",
              "ba_on_regate3", "default")
RENDER_CHUNK = 30        # frames per rendering job
READBACK_FROM, READBACK_FRAMES = 40, 20  # phase 4: add_frame's readback, tracking frames
# phase 4g, the paths the scene generators and camera tools open; each at the
# depth its budgets were set at in the JAX package's tests
PLANAR_FRAMES = 40       # tests/test_planar_sequence.py
ROBUST_FRAMES = 150      # tests/test_robustness.py
CELL_WORKERS = 4         # 4g's cells but cfg6 run this many at once, a process each
CHAIN_FRAMES = 40        # tests/test_tools_chain.py, tests/test_undistort_loop.py
# (kind, severity, ATE budget, end-drift budget; % of the path): the MATRIX of
# tests/test_robustness.py, then its severe case (low contrast 0.1, then noise 6)
ROBUST_MATRIX = [("noise", 10.0, 4.5, 12.0), ("blur", 7.0, 4.0, 10.0),
                 ("exposure", 1.0, 4.0, 12.0), ("low_contrast", 0.5, 4.5, 13.0),
                 ("low_contrast", 0.25, 4.5, 13.0), ("jpeg", 2.0, 4.5, 12.0),
                 ("vignette", 2.0, 4.5, 12.0)]
SEVERE_ATE = 30.0        # % of the path: bounded, not accurate
K_TRUE = np.array([[615.0, 0, 320], [0, 615, 240], [0, 0, 1.0]])
CHAIN_DIST = np.array([-0.28, 0.09])     # the chain's true lens (test_tools_chain.py)
UNDISTORT_DIST = np.array([-0.30, 0.09])  # the undistort loop's lens (test_undistort_loop.py)
# phase 4h, the mesh route (BA sharded over the ranks of a process group)
DIST_FRAMES = 18         # tests/test_dist_pipeline.py's sequence: make_trajectory(18, 0, 0.05)
# (largest translation distance, |dATE|) per BA mode: tests/test_dist_pipeline.py
DIST_GATES = {"fixed": (0.02, 0.01), "joint": (0.05, 0.03)}
MESH_TIMEOUT_S = 120.0   # the 4h worlds' collective timeout
CHILD_TIMEOUT_S = 300    # a 4h child process must end within this
NCCL_SLEEP_S, NCCL_TIMEOUT_S = 10.0, 5.0  # the NCCL timeout check: stream busy, then a collective
LIVE = dict(W=5, K=1024, M=4096)  # scaling.make_problem's live shape, joint mode
LIVE_ITERS, LIVE_TURNS, LIVE_REPS = 20, 4, 3
FP32_PEAK = 67e12        # H100 SXM, non-tensor fp32 FLOP/s
FP64_PEAK = 34e12        # H100 SXM, non-tensor fp64 FLOP/s
# the BA LM kernel (csrc/ba_lm_pose.cu): FLOPs of one observation in one pass
# (projection, residual, Huber weight, 2x6 Jacobian, 21 + 6 products of H and
# g: ``accumulate``), and of one frame's step (6x6 LU, se3_exp and the 4x4
# product: ``frame_step``); a solve makes iterations + 1 passes
BA_FLOPS_PER_OBS, BA_FLOPS_PER_STEP = 220, 400
# phase 3's BA windows: (tag, W, K, M, batch, float64); the live shape, the
# parity width, profile_drift_ab.py's 8-frame window, and the batch cell's B
BA_SHAPES = (("live", 5, 1024, 4096, 1, False), ("live_f64", 5, 1024, 4096, 1, True),
             ("parity", 5, 1500, 4096, 1, False), ("window8", 8, 1024, 4096, 1, False),
             ("live_b25", 5, 1024, 4096, 25, False))
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
    """Frames lo..hi-1 of a synthetic sequence (runs in a pool process):
    ``kind`` "bench" is the benchmark's room and trajectory, "planar" the
    single-wall scene and its wall-facing trajectory; the JAX package's
    scene families (phase 4j) pair ``adversarial_scene`` (repeated texture)
    and the benchmark room with the benchmark trajectory and
    ``make_adversarial_trajectory`` (translation, then rotation sweeps, then
    low-parallax creep): "adv_bench", "bench_adv" and "adv_adv", ``seed``
    then (scene seed, trajectory seed)."""
    kind, seed, n, step, lo, hi = job
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    if kind == "bench":
        return syn.render_sequence_arrays(n, seed=seed, height=H, width=W,
                                          translation_step=step, span=(lo, hi))
    if kind == "planar":
        scene, poses = syn.planar_scene(), syn.make_planar_trajectory(n)
    else:
        scene_seed, traj_seed = seed
        scene = (syn.default_scene(scene_seed) if kind == "bench_adv"
                 else syn.adversarial_scene(scene_seed))
        poses = (syn.make_trajectory(n, traj_seed, translation_step=step) if kind == "adv_bench"
                 else syn.make_adversarial_trajectory(n, seed=traj_seed, translation_step=step))
    return np.stack([syn.render_frame(poses[i], scene, K_TRUE, H, W)
                     for i in range(lo, hi)]), poses


@contextlib.contextmanager
def _one_blas_thread():
    """Processes started inside the block use one BLAS thread each."""
    threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                               "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in threads})
    try:
        yield
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _drive_job(args):
    """:func:`_drive` in a pool process (phase 4g's cells)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return _drive(*args)


def _render_all(seqs):
    """[(frames, gt)] for (kind, seed, n_frames, translation_step) in ``seqs``,
    rendered in chunks by a pool of processes (closed before returning)."""
    jobs = [(kind, seed, n, step, lo, min(lo + RENDER_CHUNK, n))
            for kind, seed, n, step in seqs for lo in range(0, n, RENDER_CHUNK)]
    # one BLAS thread per worker: the workers are as many as the cores
    # (with a pool of threads each, rendering took 4x as long)
    with _one_blas_thread(), ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = iter(list(ex.map(_render, jobs)))
    out = []
    for _, _, n, _ in seqs:
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


class _EagerEngine:
    """The eager reference route: ``step`` (the host-branch step; ``mesh``:
    with the sharded BA) one frame at a time, its StepOutput read back as
    ``VOEngine`` reads it."""

    def __init__(self, cfg, seed=0, mesh=None):
        from monocular_visual_odometry_tpu_torch.models import state as S
        from monocular_visual_odometry_tpu_torch.models.vo import VOEngine

        self.cfg, self.cam, self.mesh = cfg, VOEngine(cfg, H, W, device="cuda").cam, mesh
        self.state = S.init_state(cfg, seed, "cuda")

    def add_frame(self, img):
        from monocular_visual_odometry_tpu_torch.models import vo as V

        img = torch.as_tensor(np.asarray(img), dtype=torch.float32).to("cuda")
        self.state, out = V.step(self.cfg, self.cam, self.state, img, height=H, width=W,
                                 mesh=self.mesh)
        return V.output_to_host(out)


def _drive(cfg, frames, gt, mesh=None, route="graph"):
    """Drive a fresh engine on the card over ``frames``, one ``add_frame`` per
    frame: ``route`` "graph" is ``VOEngine`` (the user's entry point: one
    graph replay per frame in a captured stage; ``mesh``: the mesh route, BA
    sharded, its collectives replayed with the tracking graph under NCCL),
    "eager" the host-branch ``step`` (:class:`_EagerEngine`, with the mesh's
    sharded BA where one is given); the kernel and BA counts are set to 0
    just before and read just after. Returns the run's record: trajectory,
    host ms per frame, fps, per-frame diagnostics, the counts and what they
    should be (``match_features`` calls: the graph route's tracking frames
    run the keyframe update's match every time; BA computed: every tracking
    frame on the graph route and on the eager mesh route, tracking frames
    whose tracking held on the eager single-device one; BA applied: tracking
    frames whose tracking held), the graph route's capture seconds per
    stage, the collectives each frame recorded on the mesh (primitive,
    bytes), Sim(3) ATE and end drift against ``gt`` (inf where a pose is not
    finite)."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.parallel import dist_ba as DB
    from monocular_visual_odometry_tpu_torch.utils import metrics

    eng = (_EagerEngine(cfg, mesh=mesh) if route == "eager" else
           VOEngine(cfg, H, W, seed=0, device="cuda", mesh=mesh))
    graph = route == "graph"
    torch.cuda.synchronize()
    HM.hamming_nn_top2.launches = 0
    BA.ba_update_state.calls = 0
    BL.ba_lm_pose.launches = 0
    DB.ba_update_state_dist.calls = 0
    outs, n_fail, n_match, n_ba, n_applied, stage, per_frame = [], 0, 0, 0, 0, S.STAGE_BLANK, []
    n_captured = 0  # frames in a stage whose program is a graph
    stamps = []  # host clock after each frame (add_frame reads its output back)
    records = []  # per frame, the collectives the mesh recorded
    t0 = time.perf_counter()
    for f in frames:
        before = HM.hamming_nn_top2.launches
        n_rec = len(mesh.record) if mesh is not None else 0
        out = eng.add_frame(f)
        if mesh is not None:
            records.append([tuple(c) for c in mesh.record[n_rec:]])
        stamps.append(time.perf_counter())
        per_frame.append(HM.hamming_nn_top2.launches - before)
        n_match += {S.STAGE_BLANK: 0, S.STAGE_INITIALIZING: 1}.get(
            stage, 2 if graph else 1 + int(bool(out.is_keyframe)))
        tracked = cfg.ba.enabled and stage == S.STAGE_TRACKING
        n_ba += int(tracked and (graph or mesh is not None or bool(out.tracking_ok)))
        n_applied += int(tracked and bool(out.tracking_ok))
        n_captured += int(graph and stage in eng.captured_stages)
        stage = int(out.stage)
        if stage == S.STAGE_TRACKING and not bool(out.tracking_ok):
            n_fail += 1
        outs.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(frames)
    est = np.stack([o.T_w_c.numpy() for o in outs])
    stages = np.array([int(o.stage) for o in outs])
    finite = bool(np.isfinite(est).all())
    tracking = stages == S.STAGE_TRACKING
    programs = eng.stages.programs if graph else {}
    return dict(
        frames=n, wall_s=wall, fps=n / wall, stage=stage, n_fail=n_fail, route=route,
        records=records,
        launches=HM.hamming_nn_top2.launches, match_calls=n_match, mesh=mesh is not None,
        ba_calls=DB.ba_update_state_dist.calls if mesh else BA.ba_update_state.calls,
        other_ba_calls=BA.ba_update_state.calls if mesh else DB.ba_update_state_dist.calls,
        ba_kernel=BL.ba_lm_pose.launches,
        ba_expected=n_ba, ba_applied=n_applied,
        captured=list(eng.captured_stages) if graph else [],
        replays=sum(p.replays for p in programs.values()), replays_expected=n_captured,
        capture_s={s: (p.warmup_s, p.capture_s) for s, p in programs.items()
                   if p.warmup_s is not None},
        is_kf=np.array([bool(o.is_keyframe) for o in outs]),
        ok=np.array([bool(o.tracking_ok) for o in outs]), stages=stages,
        ba_rejected=int(outs[-1].ba_rejected_total), per_frame_max=max(per_frame), est=est,
        frame_ms=1e3 * np.diff([t0] + stamps), finite=finite,
        ate=metrics.ate_rmse(est, gt) if finite else float("inf"),
        drift=float(metrics.drift_curve(est, gt)[-1]) if finite else float("inf"),
        length=metrics.trajectory_length(gt),
        init_frame=int(np.argmax(tracking)) if tracking.any() else None,
        used_homography=np.array([bool(o.used_homography) for o in outs]),
        tracking_ok=int(sum(bool(o.tracking_ok) for o in outs)),
        keyframes=int(sum(bool(o.is_keyframe) for o in outs)),
        median_keypoints=float(np.median([int(o.n_keypoints) for o in outs])))


STAGE_NAMES = {0: "first", 1: "init", 2: "tracking"}


def _fmt_secs(pair):
    """(warm-up s, capture s) of a captured program as text."""
    return "not captured" if pair[0] is None else f"{pair[0]:.2f} / {pair[1]:.2f}"


def _fmt_capture(capture_s):
    """{stage: (warm-up s, capture s)} as text."""
    return ", ".join(f"{STAGE_NAMES[k]} {_fmt_secs(v)}" for k, v in
                     sorted(capture_s.items())) or "none"


def _steady_ms(r):
    """Median host ms per tracking frame, from the second tracking frame on
    (the first frame of each stage holds its capture on the graph route)."""
    return float(np.median(r["frame_ms"][r["init_frame"] + 1:]))


def _compare_routes(prefix, configs):
    """Graph runs against the eager runs of the same config in the same call
    (``configs``: name -> {"graph": [runs], "eager": [runs]}): the same init
    frame, keyframe and tracking decisions, pose distance <= ROUTE_TOL on
    every frame (raises otherwise); fps and steady-state ms per tracking
    frame of each. Returns the record."""
    worst = 0.0
    for name, turns in configs.items():
        one = len(turns["graph"]) == 1 and len(turns["eager"]) == 1
        for i, g in enumerate(turns["graph"]):
            for j, e in enumerate(turns["eager"]):
                tag = f"{name} graph / eager" if one else f"{name} graph turn {i} / eager turn {j}"
                d = float(np.linalg.norm(g["est"][:, :3, 3] - e["est"][:, :3, 3], axis=-1).max())
                worst = max(worst, d)
                same_kf = bool(np.array_equal(g["is_kf"], e["is_kf"]))
                same_ok = bool(np.array_equal(g["ok"], e["ok"]))
                print(f"{prefix} routes, {tag}: init frame {g['init_frame']} / {e['init_frame']}, "
                      f"keyframe decisions equal {same_kf}, tracking decisions equal {same_ok}, "
                      f"largest pose distance {d:.3e} (limit {ROUTE_TOL})", flush=True)
                if (g["init_frame"] != e["init_frame"] or not same_kf or not same_ok
                        or not d <= ROUTE_TOL):
                    raise AssertionError(f"{prefix}: the graph route parts from the eager step "
                                         f"({tag})")
    fps = {c: {k: [r["fps"] for r in v] for k, v in t.items()} for c, t in configs.items()}
    steady = {c: {k: [_steady_ms(r) for r in v] for k, v in t.items()}
              for c, t in configs.items()}
    for c in configs:
        print(f"{prefix} routes, {c}, {configs[c]['graph'][0]['frames']} frames, in turns: fps "
              f"graph {[round(v, 2) for v in fps[c]['graph']]}, eager "
              f"{[round(v, 2) for v in fps[c]['eager']]}; host ms per tracking frame "
              f"(median, steady) graph {[round(v, 2) for v in steady[c]['graph']]}, eager "
              f"{[round(v, 2) for v in steady[c]['eager']]}", flush=True)
    g = next(iter(configs.values()))["graph"][0]
    return dict(fps=fps, steady_ms=steady, max_pose_distance=worst,
                capture_s={STAGE_NAMES[k]: v for k, v in g["capture_s"].items()},
                replays=g["replays"], frames=g["frames"])


def _eager_batched(kind, cfg, cam, sts, frames):
    """The eager reference of ``run_sequences_batched`` / ``run_sequences_general``:
    the vmapped body called step by step without capture, each step's draws
    from the streams' keys and one readback of ``[stage, is_keyframe]``
    picking the next keys. Returns (final states, StepOutput [N,B])."""
    from monocular_visual_odometry_tpu_torch.models import vo as V

    body, draw = ((V.tracking_batched_body, V.draw_batched) if kind == "tracking" else
                  (V.general_batched_body, V.draw_general))
    outs = []
    for i in range(frames.shape[1]):
        new, out = body(cfg, cam, sts, frames[:, i].float(), draw(cfg, sts.rng, "cuda"),
                        height=H, width=W)
        stage, is_kf = torch.stack([sts.stage, out.is_keyframe.to(sts.stage.dtype)]).cpu().tolist()
        sts = new._replace(rng=V._next_keys(sts.rng, stage, is_kf))
        outs.append(out)
    return sts, V._stack_outputs(outs)


def _against_eager(tag, kind, cfg, cam, sts, frames, outs):
    """Runs :func:`_eager_batched` from ``sts`` over ``frames`` and holds the
    graph route's ``outs`` to it: every stage, keyframe and tracking
    decision equal, poses within ROUTE_TOL. Returns (wall s, largest pose
    distance)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, want = _eager_batched(kind, cfg, cam, sts, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = float((outs.T_w_c[..., :3, 3] - want.T_w_c[..., :3, 3]).norm(dim=-1).max())
    same = all(torch.equal(getattr(outs, f), getattr(want, f))
               for f in ("stage", "is_keyframe", "tracking_ok"))
    print(f"{tag}: the eager body over the same steps: {wall:.2f} s; stages, keyframe and "
          f"tracking decisions equal {same}, largest pose distance {d:.3e} (limit {ROUTE_TOL})",
          flush=True)
    if not same or not d <= ROUTE_TOL:
        raise AssertionError(f"{tag}: the captured body parts from the eager body")
    return wall, d


def _device_kernels(prof):
    """(name, device ms, count) per kernel name, most time first: summed over
    the trace's device events directly (``key_averages()`` takes minutes over
    the ~10^5 events of a profiled window)."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in by_name.items() if ms > 0),
                  key=lambda r: -r[1])


def _check_ba_kernel(name, cfg, launches, ba_calls, mesh=False):
    """``ba_lm_pose`` launched once per ``ba_update_state`` call where the
    landmarks are fixed (its LM is the kernel), never on the mesh route or in
    the joint mode (their LMs are PyTorch's)."""
    want = ba_calls if cfg.ba.fix_map_points and not mesh else 0
    if launches != want:
        raise AssertionError(f"{name}: ba_lm_pose launched {launches} times, expected {want} "
                             f"({ba_calls} BA calls, fix_map_points {cfg.ba.fix_map_points}, "
                             f"mesh {mesh})")


def _check_counts(name, cfg, r):
    """The kernel launched once per ``match_features`` call (counted per
    replay on the graph route), BA computed once per tracking frame on the
    graph route (``ba_update_state``) and the mesh route
    (``ba_update_state_dist``; the single-device BA never), once per
    tracking frame whose tracking held on the eager route; the graph route
    advanced by one replay per frame where its stages are captured."""
    if r["launches"] <= 0 or r["launches"] != r["match_calls"]:
        raise AssertionError(f"{name}: hamming_nn_top2 launched {r['launches']} times, "
                             f"expected {r['match_calls']} (one per match_features call)")
    fn, per = (("ba_update_state_dist", "tracking frame") if r["mesh"] else
               ("ba_update_state", "tracking frame") if r["route"] == "graph" else
               ("ba_update_state", "tracking frame whose tracking held"))
    if r["replays"] != r["replays_expected"]:
        raise AssertionError(f"{name}: {r['replays']} graph replays, expected "
                             f"{r['replays_expected']} (one per frame in a captured stage)")
    if r["ba_calls"] != r["ba_expected"] or (cfg.ba.enabled and r["ba_expected"] == 0):
        raise AssertionError(f"{name}: {fn} ran {r['ba_calls']} times, expected "
                             f"{r['ba_expected']} (one per {per})")
    if r["other_ba_calls"]:
        raise AssertionError(f"{name}: the other BA route ran {r['other_ba_calls']} times")
    _check_ba_kernel(name, cfg, r["ba_kernel"], r["ba_calls"], r["mesh"])


def _sync_calls(fn):
    """(fn(), the synchronizing CUDA calls ``fn`` made), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the first use of the mode also warns that it is a prototype feature)
    return out, sum(str(w.message).startswith("called a synchronizing CUDA operation")
                    for w in caught)


def _chessboard_views(K, dist):
    """The ten chessboard views of ``tests/test_tools_chain.py`` seen through
    a camera (K, radial k1, k2): [M,2] board points and [M,2] pixels per
    view, the rotations by the port's Euler helper (equal to scipy's)."""
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.data import tools

    rng = np.random.default_rng(0)
    obj = tools.chessboard_object_points((8, 6), square=0.03)
    objs, imgs = [], []
    for _ in range(10):
        Rm = syn._from_euler("xyz", rng.uniform(-0.5, 0.5, 3))
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                      rng.uniform(0.4, 0.8)])
        pc = np.concatenate([obj, np.zeros((len(obj), 1))], axis=1) @ Rm.T + t
        xy = pc[:, :2] / pc[:, 2:3]
        r2 = (xy ** 2).sum(1, keepdims=True)
        uv = (xy * (1 + dist[0] * r2 + dist[1] * r2 ** 2)) @ K[:2, :2].T + K[:2, 2]
        objs.append(obj)
        imgs.append(uv)
    return objs, imgs


def _per_frame(fn, frames):
    """``fn`` over frame chunks on threads (numpy releases the GIL), stacked;
    only for maps that treat each frame on its own."""
    chunks = np.array_split(np.asarray(frames), min(len(frames), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=len(chunks)) as ex:
        return np.concatenate(list(ex.map(fn, chunks)))


def _phase_4_readback(cfg, frames):
    """``add_frame``'s readback (phase 4, see the module docstring): after
    ``step`` returns, the StepOutput comes back with one wait; the old
    readback (one ``.cpu()`` per field) beside it, in turns, on the same
    outputs. Then the graph route's whole ``add_frame`` (draws, copies in,
    replay, readback) over the same frames: exactly one wait per frame.
    Returns the graph route's waits per frame."""
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine

    readback = {"one wait": V.output_to_host,
                "per field": lambda o: S.StepOutput(*(t.cpu() for t in o))}
    rb_eng = _EagerEngine(cfg)
    for f in frames[:READBACK_FROM]:
        rb_eng.add_frame(f)
    rb_ms = {k: ([], []) for k in readback}  # ms first after the step, then second
    waits = {k: set() for k in readback}
    for i, f in enumerate(frames[READBACK_FROM:READBACK_FROM + READBACK_FRAMES]):
        img = torch.as_tensor(np.asarray(f), dtype=torch.float32).to("cuda")  # as add_frame
        rb_eng.state, out = V.step(cfg, rb_eng.cam, rb_eng.state, img, height=H, width=W)
        got = {}
        for pos, k in enumerate(list(readback)[::1 if i % 2 == 0 else -1]):
            t0 = time.perf_counter()
            got[k] = readback[k](out)
            rb_ms[k][pos].append(1e3 * (time.perf_counter() - t0))
        for k, fn in readback.items():
            waits[k].add(_sync_calls(lambda fn=fn: fn(out))[1])
        for name, a, b in zip(S.StepOutput._fields, got["one wait"], got["per field"]):
            if a.device.type != "cpu" or a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"add_frame's readback: {name} differs from the per-field "
                                     f"readback")
    n_cuda = sum(t.is_cuda for t in out)
    med = lambda v: float(np.median(v))
    print(f"readback: {READBACK_FRAMES} tracking frames ({READBACK_FROM}...); synchronizing "
          f"calls after step returns (set_sync_debug_mode('warn')): one wait "
          f"{sorted(waits['one wait'])}, per field {sorted(waits['per field'])} ({n_cuda} "
          f"fields on the card); every field "
          f"equal, dtypes too; host ms, median, first after the step (waits for its queued "
          f"work) one wait {med(rb_ms['one wait'][0]):.3f}, per field "
          f"{med(rb_ms['per field'][0]):.3f}; second (device idle) one wait "
          f"{med(rb_ms['one wait'][1]):.3f}, per field {med(rb_ms['per field'][1]):.3f} "
          f"(in turns, frame by frame)", flush=True)
    if waits["one wait"] != {1} or waits["per field"] != {n_cuda}:
        raise AssertionError(f"add_frame's readback waited {waits['one wait']} times per frame "
                             f"(expected 1; per field {waits['per field']})")
    g_eng = VOEngine(cfg, H, W, seed=0, device="cuda")
    for f in frames[:READBACK_FROM]:
        g_eng.add_frame(f)
    g_waits = [_sync_calls(lambda f=f: g_eng.add_frame(f))[1]
               for f in frames[READBACK_FROM:READBACK_FROM + READBACK_FRAMES]]
    print(f"readback, graph route: synchronizing calls per add_frame (frame upload, draws, "
          f"copies in, replay, readback) over frames {READBACK_FROM}...: {g_waits}", flush=True)
    if set(g_waits) != {1}:
        raise AssertionError(f"the graph route's add_frame waited {g_waits} times per frame "
                             f"(expected 1)")
    return g_waits


def _init_matches(cfg, cam, st, img):
    """The init attempt's correspondences on the state's device, as
    ``step_init`` makes them: normalized-plane x1, x2 [K,2], valid [K]."""
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops.features import features_from_config
    from monocular_visual_odometry_tpu_torch.ops.twoview import pixel2cam_norm_plane

    feats = features_from_config(img, cfg.orb)
    ref = st.ref_feats
    m = V._match(cfg, ref.desc, feats.desc, ref.valid, feats.valid, ref.kpts, feats.kpts,
                 cfg.match.max_pixel_dist_init)
    return (pixel2cam_norm_plane(ref.kpts[m.query_idx], cam),
            pixel2cam_norm_plane(feats.kpts[m.train_idx], cam), m.valid)


def _phase_4d_init(cfg5, frames, five):
    """Phase 4d's look into the five-point init stage on the card: which
    model won on each init frame of the graph run ``five``; the captured init
    program called once more under ``set_sync_debug_mode("error")`` and its
    kernels and device ms (profiled replay); the Jacobi ``eigh``'s device
    kernels per call at the solver's shapes; on every init frame, the
    card's E-RANSAC (Jacobi ``eigh``, captured) against the same call on a
    CPU copy (LAPACK) with the same draws: inlier counts and the largest
    difference in E up to sign. Returns the record."""
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.models.capture import CapturedStep
    from monocular_visual_odometry_tpu_torch.ops import epipolar as EP
    from monocular_visual_odometry_tpu_torch.ops import lie
    from monocular_visual_odometry_tpu_torch.ops.twoview import _focal

    stages_before = np.concatenate([[S.STAGE_BLANK], five["stages"][:-1]])
    init_frames = [int(i) for i in np.flatnonzero(stages_before == S.STAGE_INITIALIZING)]
    won = ["H" if five["used_homography"][i] else "E" for i in init_frames]
    print(f"4d: init frames {init_frames[0]}..{init_frames[-1]} ({len(init_frames)}); the model "
          f"that won on each: {''.join(won)} (E {won.count('E')}, H {won.count('H')}; the "
          f"attempt at frame {init_frames[-1]} initialized)", flush=True)

    # the states before each init frame, from a fresh engine
    eng = V.VOEngine(cfg5, H, W, seed=0, device="cuda")
    cam, before = eng.cam, []
    for i in range(init_frames[-1] + 1):
        if i in init_frames:
            before.append(eng.state)
        eng.add_frame(frames[i])

    # the init program: captured by its first call, then once more under
    # set_sync_debug_mode("error"), then one profiled replay
    progs = V.StagePrograms(cfg5, cam, H, W, "cuda")
    imgs = [torch.as_tensor(frames[i], dtype=torch.float32, device="cuda") for i in init_frames]
    call = lambda k: progs(before[k], imgs[k], S.STAGE_INITIALIZING, int(before[k].rng))
    call(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any wait on the stream raises
    try:
        call(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    prog = progs.programs[S.STAGE_INITIALIZING]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call(1)
        torch.cuda.synchronize()
    ks = _device_kernels(prof)
    init_kernels, init_ms = sum(c for _, _, c in ks), sum(ms for _, ms, _ in ks)
    replay_ms = _events_ms(lambda: call(1), 20)
    print(f"4d: the captured five-point init program (warm-up / capture "
          f"{_fmt_secs((prog.warmup_s, prog.capture_s))} s) ran a replay under "
          f"set_sync_debug_mode('error') without a sync; one replay: {init_kernels} device "
          f"kernels, device busy {init_ms:.3f} ms; {replay_ms:.3f} ms per call (CUDA events over "
          f"20 calls: draws, copies in, replay)", flush=True)
    for name, ms, count in ks[:6]:
        print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)

    # the Jacobi eigh at the solver's shapes and dtype (its Gram matrices are
    # float64): per call, kernels and device ms
    n_e = max(cfg5.ransac.n_hypotheses // 4, 8)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    eigh_rows = {}
    for tag, shape in (("9x9", (n_e, 9, 9)), ("10x10", (n_e, 8, 10, 10))):
        X = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
        M = X @ X.mT
        lie.eigh(M)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            lie.eigh(M)
            torch.cuda.synchronize()
        ek = _device_kernels(prof)
        graph_ms, eager_ms = _time_ms(lambda: lie.eigh(M), 5)
        eigh_rows[tag] = dict(shape=list(shape), kernels=sum(c for _, _, c in ek),
                              device_ms=sum(ms for _, ms, _ in ek), graph_ms=graph_ms,
                              eager_ms=eager_ms)
        print(f"4d: lie.eigh (Jacobi, {lie._EIGH_SWEEPS[torch.float64]} sweeps) on {shape} "
              f"float64: "
              f"{eigh_rows[tag]['kernels']} device kernels per call, device busy "
              f"{eigh_rows[tag]['device_ms']:.3f} ms (profiled); per call {graph_ms:.3f} ms "
              f"replayed in a graph, {eager_ms:.3f} ms eager (CUDA events)", flush=True)

    # the E-RANSAC on every init frame: the card's (captured) against the CPU's
    th = float(np.float32(cfg5.ransac.threshold_px) / _focal(cam))
    ransac = lambda x1, x2, valid, u, G: EP.estimate_essential(
        x1, x2, valid, None, threshold=th, n_hypotheses=cfg5.ransac.n_hypotheses, minimal="5pt",
        u=u, G=G)
    captured = CapturedStep(lambda st, x1, x2, valid, u, G: (st, *ransac(x1, x2, valid, u, G)))
    rows = []
    for k, i in enumerate(init_frames):
        x1, x2, valid = _init_matches(cfg5, cam, before[k], imgs[k])
        d = V._stage_draws(cfg5, S.STAGE_INITIALIZING, int(before[k].rng), "cuda")
        _, E_card, inl_card, n_card = captured(torch.zeros(1, device="cuda"), x1, x2, valid,
                                               d.init_e, d.init_G)
        E_card, n_card = E_card.cpu(), int(n_card)
        cpu = ransac(x1.cpu(), x2.cpu(), valid.cpu(), d.init_e.cpu(), d.init_G.cpu())
        Ec, Eg = cpu.model / cpu.model.norm(), E_card / E_card.norm()
        dE = float(torch.minimum((Ec - Eg).abs().max(), (Ec + Eg).abs().max()))
        rows.append(dict(frame=i, inliers_card=n_card, inliers_cpu=int(cpu.n_inliers),
                         e_diff=dE, matches=int(valid.sum())))
    print("4d: E-RANSAC on each init frame, card (Jacobi eigh, captured, "
          f"{captured.replays} replays) against the CPU (LAPACK), same draws: "
          + "; ".join(f"frame {r['frame']}: inliers {r['inliers_card']}/{r['inliers_cpu']} of "
                      f"{r['matches']} matches, E up to sign {r['e_diff']:.2e}" for r in rows)
          + f"; largest difference in E {max(r['e_diff'] for r in rows):.3e}, largest inlier "
          f"count difference {max(abs(r['inliers_card'] - r['inliers_cpu']) for r in rows)}",
          flush=True)
    return dict(init_frames=init_frames, won=won, init_program_kernels=init_kernels,
                init_program_device_ms=init_ms, init_program_ms=replay_ms, eigh=eigh_rows,
                ransac=rows)


def _phase_4g(frames, gt, robust_seq, chain_seq, planar_seq, main, cfg):
    """Phase 4g, the paths the scene generators and camera tools open (see the
    module docstring). Every run goes through ``VOEngine`` on the card; a gate
    that fails raises. Returns {cell: run record}."""
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.data import tools
    from monocular_visual_odometry_tpu_torch.models import state as S

    t_phase = time.perf_counter()
    cells = {}

    def report(tag, c, r, note=""):
        share = lambda v: f"{100 * v / r['length']:.2f}%"
        print(f"4g {tag}: {r['frames']} frames in {r['wall_s']:.2f} s = {r['fps']:.2f} fps; final "
              f"stage {r['stage']}, finite {r['finite']}, init frame {r['init_frame']}, tracking "
              f"failures {r['n_fail']}, tracking_ok on {r['tracking_ok']} frames, keyframes "
              f"{r['keyframes']}, median keypoints {r['median_keypoints']:.0f}; Sim3 ATE "
              f"{r['ate']:.4f} ({share(r['ate'])} of a {r['length']:.3f} path), end drift "
              f"{r['drift']:.4f} ({share(r['drift'])}); matcher launches {r['launches']} "
              f"(match_features calls {r['match_calls']}), ba_update_state calls "
              f"{r['ba_calls']} (expected {r['ba_expected']}){note}", flush=True)
        _check_counts(f"4g {tag}", c, r)
        cells[tag] = r
        return r

    def require(ok, what):
        if not ok:
            raise AssertionError(f"4g: {what}")

    tracks = lambda r: r["finite"] and r["stage"] == S.STAGE_TRACKING
    pct = lambda r, v: 100 * v / r["length"]

    # the cells of (a)-(c): their inputs first, then every engine in a pool of
    # CELL_WORKERS processes (the step is host-bound: they share the card,
    # not a core), then each cell's report and gates in order
    jobs = []                                  # (tag, config, frames, gt, note)
    # (a) planar init under both selection rules: the JAX test's 512-keypoint
    # configuration (gated), then the default width (recorded)
    planar_frames, planar_gt = planar_seq
    small = cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
        ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
        map=dataclasses.replace(cfg.map, max_map_points=2048))
    for width, base in (("512 keypoints", small), ("1024 keypoints", cfg)):
        for ref in (True, False):
            c = base.replace(init=dataclasses.replace(base.init, use_reference_selection=ref))
            rule = "reference rule" if ref else "tournament rule"
            jobs.append((f"planar {rule} {width}", c, planar_frames, planar_gt, ""))
    # (b) the robustness matrix, default config, each row's budgets
    clean, robust_gt = robust_seq
    per_frame_kinds = ("blur", "low_contrast", "jpeg", "vignette")
    for kind, sev, ate_budget, drift_budget in ROBUST_MATRIX:
        if kind in per_frame_kinds:
            fr = _per_frame(lambda f, k=kind, v=sev: syn.perturb_frames(f, k, v), clean)
        else:
            fr = syn.perturb_frames(clean, kind, sev)
        jobs.append((f"robustness {kind} {sev}", cfg, fr, robust_gt,
                     f"; budgets ATE {ate_budget}%, drift {drift_budget}%"))
    fr = syn.perturb_frames(syn.perturb_frames(clean, "low_contrast", 0.1), "noise", 6.0)
    jobs.append(("robustness severe (low_contrast 0.1, then noise 6.0)", cfg, fr, robust_gt,
                 f"; budget ATE {SEVERE_ATE}%"))
    # (c) calibrate -> distort -> undistort -> track, then the undistort loop
    ideal, chain_gt = chain_seq
    ideal = ideal.astype(np.float64)
    t0 = time.perf_counter()
    K_cal, dist_cal, rms = tools.calibrate_camera(*_chessboard_views(K_TRUE, CHAIN_DIST), (W, H))
    cal_s = time.perf_counter() - t0
    print(f"4g chain: calibrated from 10 chessboard views in {cal_s:.2f} s: fx {K_cal[0, 0]:.4f} "
          f"fy {K_cal[1, 1]:.4f} cx {K_cal[0, 2]:.4f} cy {K_cal[1, 2]:.4f} k1 {dist_cal[0]:.6f} "
          f"k2 {dist_cal[1]:.6f}, rms {rms:.3e} px (true: 615, 615, 320, 240, "
          f"{CHAIN_DIST[0]}, {CHAIN_DIST[1]})", flush=True)
    require(rms < 0.1 and abs(K_cal[0, 0] - K_TRUE[0, 0]) < 3.0,
            f"chain: calibration rms {rms}, fx {K_cal[0, 0]}")
    t0 = time.perf_counter()
    raw = _per_frame(lambda fs: np.stack([tools.distort_image(f, K_TRUE, CHAIN_DIST)
                                          for f in fs]), ideal)
    fr = _per_frame(lambda fs: np.stack([tools.undistort_image(f, K_cal, dist_cal)
                                         for f in fs]), raw).astype(np.float32)
    distorted = _per_frame(lambda fs: np.stack([tools.distort_image(f, K_TRUE, UNDISTORT_DIST)
                                                for f in fs]), ideal)
    undistorted = _per_frame(lambda fs: np.stack([
        tools.undistort_image(f, K_TRUE, UNDISTORT_DIST) for f in fs]), distorted)
    print(f"4g chain: {4 * CHAIN_FRAMES} distort/undistort calls in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    c = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, fx=float(K_cal[0, 0]), fy=float(K_cal[1, 1]), cx=float(K_cal[0, 2]),
        cy=float(K_cal[1, 2])))
    jobs.append(("chain (calibrated intrinsics, undistorted frames)", c, fr, chain_gt, ""))
    for name, f in (("clean", ideal), ("undistorted", undistorted),
                    ("raw distorted", distorted)):
        jobs.append((f"undistort loop, {name}", cfg, f, chain_gt, ""))

    t0 = time.perf_counter()
    with _one_blas_thread(), ProcessPoolExecutor(
            max_workers=CELL_WORKERS, mp_context=multiprocessing.get_context("spawn")) as ex:
        runs = list(ex.map(_drive_job, [(c, fr, g) for _, c, fr, g, _ in jobs]))
    print(f"4g: {len(jobs)} cells (planar, robustness, chain and undistort loop), "
          f"{CELL_WORKERS} at once, in {time.perf_counter() - t0:.1f} s (each cell's fps is "
          f"with the others running)", flush=True)
    runs = {tag: report(tag, c, r, note) for (tag, c, _, _, note), r in zip(jobs, runs)}

    for width in ("512 keypoints", "1024 keypoints"):
        for ref in (True, False):
            rule = "reference rule" if ref else "tournament rule"
            tag = f"planar {rule} {width}"
            r = runs[tag]
            init = r["init_frame"]
            print(f"4g {tag}: H chosen at init "
                  f"{None if init is None else bool(r['used_homography'][init])}", flush=True)
            if width == "1024 keypoints":
                continue  # recorded, not gated
            require(tracks(r), f"{tag}: final stage {r['stage']}, finite {r['finite']}")
            require(init is not None and 0 < init <= 15, f"{tag}: init frame {init}")
            require(not ref or r["used_homography"][init],
                    f"{tag}: the reference selection rule picked E on a dominant plane")
            require(r["ate"] < 0.08 * r["length"], f"{tag}: ATE {pct(r, r['ate']):.2f}% >= 8%")
            require(r["tracking_ok"] >= PLANAR_FRAMES - init - 2,
                    f"{tag}: tracking_ok on {r['tracking_ok']} frames")
    for kind, sev, ate_budget, drift_budget in ROBUST_MATRIX:
        tag = f"robustness {kind} {sev}"
        r = runs[tag]
        require(tracks(r), f"{tag}: final stage {r['stage']}, finite {r['finite']}")
        require(pct(r, r["ate"]) < ate_budget, f"{tag}: ATE {pct(r, r['ate']):.2f}%")
        require(pct(r, r["drift"]) < drift_budget, f"{tag}: drift {pct(r, r['drift']):.2f}%")
    r = runs["robustness severe (low_contrast 0.1, then noise 6.0)"]
    require(r["finite"] and pct(r, r["ate"]) < SEVERE_ATE,
            f"severe case: finite {r['finite']}, ATE {pct(r, r['ate']):.2f}%")
    r = runs["chain (calibrated intrinsics, undistorted frames)"]
    require(tracks(r) and pct(r, r["ate"]) < 6.0,
            f"chain: final stage {r['stage']}, finite {r['finite']}, ATE {pct(r, r['ate']):.2f}%")
    loop = {k: runs[f"undistort loop, {k}"] for k in ("clean", "undistorted", "raw distorted")}
    a_clean, a_und, a_dist = (pct(loop[k], loop[k]["ate"])
                              for k in ("clean", "undistorted", "raw distorted"))
    require(tracks(loop["clean"]) and a_clean < 5.0, f"undistort loop: clean ATE {a_clean:.2f}%")
    require(tracks(loop["undistorted"]), "undistort loop: the undistorted run does not track")
    require(a_und < max(1.8 * a_clean, 5.0),
            f"undistort loop: undistorted ATE {a_und:.2f}% against clean {a_clean:.2f}%")
    require(a_dist > 1.5 * a_und,
            f"undistort loop: raw distorted ATE {a_dist:.2f}% not above 1.5x {a_und:.2f}%")

    # (d) bench cfg6, the reference-parity configuration, on phase 4's frames
    c6 = cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=1500),
        init=dataclasses.replace(cfg.init, use_reference_selection=True),
        ransac=dataclasses.replace(cfg.ransac, keyframe_use_ransac_filter=True),
        ba=dataclasses.replace(cfg.ba, keyframe_window=False))
    _drive(c6, frames[:WARM_FRAMES], gt[:WARM_FRAMES])  # set-up off the clock
    r = report("cfg6", c6, _drive(c6, frames, gt),
               f" (1500 keypoints, reference selection rule, keyframe E-RANSAC filter, "
               f"last-W-frames BA window); phase 4's cfg4 in this call {main['fps']:.2f} fps")
    require(tracks(r) and r["n_fail"] <= 5 and pct(r, r["ate"]) < 3.0,
            f"cfg6: final stage {r['stage']}, {r['n_fail']} failures, ATE "
            f"{pct(r, r['ate']):.2f}%")
    print(f"4g: {len(cells)} runs, phase 4g took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return cells


def _dist_cfg(cfg, mode, small=False):
    """``cfg`` (or, ``small``, tests/test_dist_pipeline.py's 512-keypoint
    configuration: 2,048 map slots, 256/128 hypotheses, 10 LM iterations) with
    the landmarks fixed or joint."""
    if small:
        cfg = cfg.replace(
            orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
            ransac=dataclasses.replace(cfg.ransac, n_hypotheses=256, pnp_n_hypotheses=128),
            map=dataclasses.replace(cfg.map, max_map_points=2048),
            ba=dataclasses.replace(cfg.ba, iterations=10))
    return cfg.replace(ba=dataclasses.replace(cfg.ba, fix_map_points=mode == "fixed"))


def _live_shape(mesh):
    """``scaling.measure`` and ``scaling.measure_comm`` at the live shape
    (joint, LIVE_ITERS iterations) on ``mesh``, on the card: ms per solve of
    the sharded LM and of ``ba_solve`` in turns, device kernels per solve,
    and one LM iteration's collectives, which must equal
    ``scaling.comm_model``'s terms (raises otherwise)."""
    from monocular_visual_odometry_tpu_torch.parallel import scaling as SC

    rec = SC.measure(mesh, **LIVE, iterations=LIVE_ITERS, turns=LIVE_TURNS, reps=LIVE_REPS,
                     device="cuda")
    comm = SC.measure_comm(mesh, **LIVE, iterations=LIVE_ITERS, device="cuda")
    it, model, sizes = (comm["measured_per_iteration"], comm["model_by_op"],
                        comm["model_result_bytes"])
    rec.update(iteration_collectives=it["collectives"], iteration_bytes_by_op=it["by_op"],
               model_bytes_by_op=model, iteration_result_bytes=it["result_by_op"],
               model_result_bytes=sizes,
               matmul_flops_per_iteration=comm["matmul_flops_per_rank_per_iteration"])
    bad = [op for op in model if abs(it["by_op"].get(op, 0.0) - model[op]) > 0.2
           or it["result_by_op"].get(op, 0) != sizes[op]]
    if it["collectives"] != 5 or bad:
        raise AssertionError(f"4h live shape, D={mesh.size}: one LM iteration's collectives "
                             f"({it}) are not comm_model's ({model}, sizes {sizes}): {bad}")
    return rec


def _child(argv) -> int:
    """The processes phase 4h starts (``python3 chip_smoke.py --<role> ...``).

    - ``--nccl-timeout STORE CYCLES``: a one-rank NCCL world with a
      NCCL_TIMEOUT_S timeout; the stream is kept busy CYCLES clock cycles, then
      a collective is enqueued: NCCL's watchdog must end the process;
    - ``--mesh-rank RANK WORLD STORE FRAMES OUT``: one rank of a gloo world on
      the card driving ``VOEngine(mesh=...)`` over the frames, BA fixed then
      joint, at full width; poses, stages and counts to OUT;
    - ``--live-rank RANK WORLD STORE OUT``: one rank of a gloo world on the card
      running :func:`_live_shape`; its record to OUT (JSON)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM

    role = argv[0]
    if role == "--nccl-timeout":
        store, cycles = argv[1], int(argv[2])
        PM.init_distributed(f"file://{store}", 1, 0, backend="nccl", timeout_s=NCCL_TIMEOUT_S)
        mesh = PM.points_mesh()
        x = torch.ones(4, device="cuda")
        mesh.psum(x)
        torch.cuda.synchronize()
        print(f"enqueued at {time.time():.3f}", flush=True)
        torch.cuda._sleep(cycles)
        mesh.psum(x)
        torch.cuda.synchronize()
        print("the collective returned", flush=True)
        return 0
    rank, world, store = int(argv[1]), int(argv[2]), argv[3]
    PM.init_distributed(f"file://{store}", world, rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
    mesh = PM.points_mesh()
    if role == "--live-rank":
        rec = _live_shape(mesh)
        Path(argv[4]).write_text(json.dumps(rec))
    elif role == "--mesh-rank":
        from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

        with np.load(argv[4]) as z:
            frames, gt = z["frames"], z["gt"]
        out = {}
        for mode in DIST_GATES:
            c = _dist_cfg(VOConfig(), mode)
            r = _drive(c, frames, gt, mesh=mesh)
            _check_counts(f"4h rank {rank} {mode}", c, r)
            out.update({f"{mode}_est": r["est"], f"{mode}_launches": r["launches"],
                        f"{mode}_ba_calls": r["ba_calls"], f"{mode}_stage": r["stage"],
                        f"{mode}_n_fail": r["n_fail"]})
        np.savez(argv[5], **out)
    else:
        raise ValueError(f"chip_smoke: unknown role {role}")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def _popen(cmd, log):
    """``cmd`` in the repo's root, its output to the file ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([str(c) for c in cmd], cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)


def _spawn(args, log):
    """A child of this script (:func:`_child`) on the card, output to ``log``."""
    return _popen([sys.executable, os.path.abspath(__file__), *args], log)


def _wait(procs, logs, what):
    """Wait for ``procs`` (killing them all at CHILD_TIMEOUT_S); raise with
    the end of their logs if one exited non-zero."""
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, Path(log).read_text()[-3000:]) for p, log in zip(procs, logs)
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"4h {what}: a process exited {bad[0][0]}:\n{bad[0][1]}")


def _phase_4h_a(cfg, frames, gt, main, mesh):
    """Phase 4h (a): the mesh route on ``mesh`` (a one-rank NCCL world) over
    phase 4's frames, the stage programs against the eager ``step(mesh=...)``
    in turns (see the module docstring). Returns (the first graph run's
    record, the kernels line's additions)."""
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine

    _drive(cfg, frames[:WARM_FRAMES], gt[:WARM_FRAMES], mesh=mesh)   # set-up off the clock
    # the stage programs (the tracking graph replays the sharded BA's
    # collectives) and the eager step(mesh=...), in turns
    turns = {}
    for route in ("graph", "eager", "graph"):
        r = _drive(cfg, frames, gt, mesh=mesh, route=route)
        _check_counts(f"4h (a) {route}", cfg, r)
        turns.setdefault(route, []).append(r)
    a = turns["graph"][0]
    if a["captured"] != [0, 1, 2] or a["replays"] != a["frames"]:
        raise AssertionError(f"4h (a): captured stages {a['captured']}, {a['replays']} replays "
                             f"in {a['frames']} frames (every stage a graph under NCCL)")
    routes_a = _compare_routes("4h (a)", {"mesh": turns})
    entered = np.concatenate([[False], a["stages"][:-1] == S.STAGE_TRACKING])
    per_frame = {tuple(r) for r, t in zip(a["records"], entered) if t}
    for route, runs in turns.items():
        for i, r in enumerate(runs):
            if r["records"] != a["records"]:
                raise AssertionError(f"4h (a): the {route} run {i} recorded other collectives "
                                     f"than the first graph run")
    if len(per_frame) != 1 or any(r for r, t in zip(a["records"], entered) if not t):
        raise AssertionError(f"4h (a): the collectives differ between tracking frames, or a "
                             f"frame outside tracking called one ({len(per_frame)} kinds)")
    by_op = {}
    for op, nbytes in next(iter(per_frame)):
        by_op.setdefault(op, []).append(nbytes)
    # waits per add_frame on the captured mesh route, over tracking frames
    eng = VOEngine(cfg, H, W, seed=0, device="cuda", mesh=mesh)
    for f in frames[:READBACK_FROM]:
        eng.add_frame(f)
    waits = [_sync_calls(lambda f=f: eng.add_frame(f))[1]
             for f in frames[READBACK_FROM:READBACK_FROM + READBACK_FRAMES]]
    dist_main, _ = _first_parting(a["est"], main["est"], 1e-4)
    print(f"4h (a) mesh route, one-rank NCCL world, default config, graph route: {a['frames']} "
          f"frames in {a['wall_s']:.2f} s = {a['fps']:.2f} fps (phase 4 in this call: "
          f"{main['fps']:.2f} fps); captured stages {a['captured']}, {a['replays']} graph "
          f"replays, warm-up / capture seconds per stage {_fmt_capture(a['capture_s'])}; final "
          f"stage {a['stage']}, tracking failures {a['n_fail']}, Sim3 ATE {a['ate']:.4f} "
          f"({100 * a['ate'] / a['length']:.2f}% of the path); matcher launches {a['launches']} "
          f"(match_features calls {a['match_calls']}), ba_update_state_dist calls "
          f"{a['ba_calls']} (tracking frames {a['ba_expected']}); collectives per tracking frame "
          f"{sum(len(v) for v in by_op.values())} (result bytes by primitive "
          f"{by_op}), equal on every frame of every run, graph and eager; synchronizing calls "
          f"per add_frame over frames {READBACK_FROM}...: {waits}; largest pose distance to "
          f"phase 4's run {dist_main:.3e}", flush=True)
    if waits != [1] * READBACK_FRAMES:
        raise AssertionError(f"4h (a): add_frame waited {waits} times per frame on the mesh "
                             f"route (one readback each)")
    if not (a["finite"] and a["stage"] == S.STAGE_TRACKING and a["n_fail"] <= 5
            and a["ate"] < 0.03 * a["length"]):
        raise AssertionError(f"4h (a): stage {a['stage']}, {a['n_fail']} failures, ATE "
                             f"{100 * a['ate'] / a['length']:.2f}%")
    return a, {"mesh_routes": routes_a, "mesh_waits_per_frame": waits,
               "mesh_collectives_per_tracking_frame": by_op}


def _phase_4h(frames, gt, seq18, main, cfg, clock_mhz):
    """Phase 4h, the mesh route on the card (see the module docstring).
    Returns the kernels line's additions."""
    import torch.distributed as dist

    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.parallel import mesh as PM
    from monocular_visual_odometry_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    work = Path(ROOT) / "build" / "4h"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    frames18, gt18 = seq18

    # (a) a one-rank NCCL world: the default config over phase 4's frames
    torch.cuda.set_device(0)
    PM.init_distributed(f"file://{work / 'store_a'}", 1, 0, backend="nccl",
                        timeout_s=MESH_TIMEOUT_S)
    mesh = PM.points_mesh()
    print(f"4h: {mesh} ({dist.get_backend()}, collective timeout {MESH_TIMEOUT_S:.0f} s)",
          flush=True)
    a, mesh_a = _phase_4h_a(cfg, frames, gt, main, mesh)

    def gate(tag, mode, got, ref):
        d_max, _ = _first_parting(got["est"], ref["est"], 0.0)
        d_gate, ate_gate = DIST_GATES[mode]
        print(f"4h {tag}: largest translation distance {d_max:.3e} (gate {d_gate}), ATE "
              f"{got['ate']:.4f} against {ref['ate']:.4f} (|d| gate {ate_gate})", flush=True)
        if not (got["finite"] and got["stage"] == S.STAGE_TRACKING and d_max < d_gate
                and abs(got["ate"] - ref["ate"]) < ate_gate):
            raise AssertionError(f"4h {tag}: distance {d_max}, ATE {got['ate']} against "
                                 f"{ref['ate']}")

    # (b) tests/test_dist_pipeline.py's configuration and frames, both modes:
    # the mesh route against the single-device route
    for mode in DIST_GATES:
        c = _dist_cfg(cfg, mode, small=True)
        runs = {}
        for route, m in (("mesh", mesh), ("single", None)):
            runs[route] = _drive(c, frames18, gt18, mesh=m)
            _check_counts(f"4h (b) {mode} {route}", c, runs[route])
        gate(f"(b) {mode}, 512 keypoints, {DIST_FRAMES} frames, mesh against single",
             mode, runs["mesh"], runs["single"])

    # NCCL's timeout, in a process of its own, beside (c), which is not timed
    # (its kernel holds the card's time slices while it runs)
    cycles = int(NCCL_SLEEP_S * clock_mhz * 1e6)
    t_nccl = time.time()
    nccl_child = _spawn(["--nccl-timeout", work / "store_timeout", cycles], work / "timeout.log")
    nccl_end = {}
    waiter = threading.Thread(target=lambda: nccl_end.update(
        rc=nccl_child.wait(timeout=CHILD_TIMEOUT_S), t=time.time()))
    waiter.start()

    # (c) two ranks on the one card over gloo: parallel.multihost, then the
    # mesh route at full width (the ranks start now; the reference runs here)
    for extra, gates in (([], (1e-3, 1e-4, 1e-3)), (["--deterministic"], (1e-9, 1e-9, 1e-8))):
        tag = "deterministic" if extra else "default"
        report = work / f"multihost_{tag}.json"
        logs = [work / f"multihost_{tag}_{r}.log" for r in range(2)]
        procs = [_popen(
            [sys.executable, "-m", "monocular_visual_odometry_tpu_torch.parallel.multihost",
             "--process-id", r, "--num-processes", 2, "--backend", "gloo", "--device", "cuda",
             "--coordinator", f"file://{work / f'store_mh_{tag}'}", "--report", report,
             "--timeout", MESH_TIMEOUT_S, *extra], log) for r, log in enumerate(logs)]
        _wait(procs, logs, f"(c) multihost {tag}")
        rep = json.loads(report.read_text())
        print(f"4h (c) parallel.multihost {tag}, 2 processes on cuda:0 over gloo: "
              f"{json.dumps(rep)}", flush=True)
        ok = (rep["global_devices"] == 2 and rep["final_cost_rel_err"] < gates[0]
              and rep["pose_err_vs_single_device"] < gates[1]
              and rep["point_err_vs_single_device"] < gates[2]
              and (extra or rep["cost_of_distributed_solution"]
                   <= 1.001 * rep["cost_of_single_solution"]))
        if not ok:
            raise AssertionError(f"4h (c) multihost {tag}: outside tests/test_multihost.py's "
                                 f"gates {gates}")
    np.savez(work / "frames18.npz", frames=frames18, gt=gt18)
    logs = [work / f"mesh_rank{r}.log" for r in range(2)]
    procs = [_spawn(["--mesh-rank", r, 2, work / "store_c", work / "frames18.npz",
                     work / f"mesh_rank{r}.npz"], log) for r, log in enumerate(logs)]
    try:
        ref = {mode: _drive(_dist_cfg(cfg, mode), frames18, gt18, mesh=mesh)
               for mode in DIST_GATES}
    finally:
        _wait(procs, logs, "(c) mesh route, two ranks")
    ranks = [dict(np.load(work / f"mesh_rank{r}.npz")) for r in range(2)]
    for mode in DIST_GATES:
        equal = np.array_equal(ranks[0][f"{mode}_est"], ranks[1][f"{mode}_est"])
        print(f"4h (c) mesh route, two gloo ranks on cuda:0, default config, BA {mode}, "
              f"{DIST_FRAMES} frames: poses bitwise equal across ranks on every frame: {equal}; "
              f"matcher launches {[int(r[f'{mode}_launches']) for r in ranks]}, "
              f"ba_update_state_dist calls {[int(r[f'{mode}_ba_calls']) for r in ranks]}",
              flush=True)
        if not equal:
            raise AssertionError(f"4h (c) {mode}: the ranks' poses differ")
        got = dict(est=ranks[0][f"{mode}_est"], stage=int(ranks[0][f"{mode}_stage"]),
                   finite=bool(np.isfinite(ranks[0][f"{mode}_est"]).all()))
        got["ate"] = metrics.ate_rmse(got["est"], gt18) if got["finite"] else float("inf")
        gate(f"(c) {mode}, two ranks against (a)'s one-rank engine", mode, got, ref[mode])

    # (d) the live shape at D = 1 (NCCL, here) and D = 2 (gloo, two processes),
    # once the timeout check's process has ended
    waiter.join(timeout=CHILD_TIMEOUT_S)
    if nccl_child.poll() is None:
        nccl_child.kill()
        nccl_child.wait()
    live = {1: _live_shape(mesh)}
    logs = [work / f"live_rank{r}.log" for r in range(2)]
    procs = [_spawn(["--live-rank", r, 2, work / "store_d", work / f"live_rank{r}.json"], log)
             for r, log in enumerate(logs)]
    _wait(procs, logs, "(d) live shape, two ranks")
    live[2] = json.loads((work / "live_rank0.json").read_text())
    for D, rec in live.items():
        ev, host = rec["ms_per_solve_cuda_events"], rec["ms_per_solve_host"]
        print(f"4h (d) live shape W={LIVE['W']} K={LIVE['K']} M={LIVE['M']}, {LIVE_ITERS} "
              f"iterations, joint, D={D} ({rec['backend']}): ms per solve, CUDA events: dist "
              f"{ev['dist']:.3f}, single ba_solve {ev['single']:.3f}; host clock: dist "
              f"{host['dist']:.3f}, single {host['single']:.3f} (median of {LIVE_TURNS} turns "
              f"of {LIVE_REPS}); matmul FLOPs per rank per solve {rec['matmul_flops_per_rank']}; "
              f"device kernels per solve: dist {rec['kernels_per_solve']['dist']}, single "
              f"{rec['kernels_per_solve']['single']}; device busy ms per solve: dist "
              f"{rec['device_busy_ms_per_solve']['dist']:.3f}, single "
              f"{rec['device_busy_ms_per_solve']['single']:.3f}; one LM iteration: "
              f"{rec['iteration_collectives']} collectives, bytes per rank by primitive "
              f"{rec['iteration_bytes_by_op']} = comm_model {rec['model_bytes_by_op']}, result "
              f"bytes {rec['iteration_result_bytes']}; dist against single: pose "
              f"{rec['pose_err']:.3e}, points {rec['point_err']:.3e}, final cost rel "
              f"{rec['final_cost_rel']:.3e}", flush=True)

    # NCCL's timeout: the watchdog flags the collective when the timeout
    # passes and the process ends. The stream is held by a kernel the
    # watchdog cannot abort, so the process may only end once it is free.
    log = (work / "timeout.log").read_text()
    enq = re.search(r"enqueued at ([0-9.]+)", log)
    caught = re.search(r"Watchdog caught collective operation timeout.*?Timeout\(ms\)=(\d+)\) "
                       r"ran for (\d+) milliseconds", log)
    after = nccl_end.get("t", float("nan")) - (float(enq.group(1)) if enq else t_nccl)
    flagged = (f"after {caught.group(2)} ms (timeout {caught.group(1)} ms)" if caught
               else "never")
    print(f"4h NCCL timeout ({NCCL_TIMEOUT_S:.0f} s; the stream held ~{NCCL_SLEEP_S:.0f} s by a "
          f"kernel before the collective): the watchdog flagged the collective {flagged}; "
          f"the process ended with code {nccl_end.get('rc')} {after:.1f} s after the collective "
          f"was enqueued ('the collective returned' printed first: "
          f"{'the collective returned' in log})", flush=True)
    if (nccl_end.get("rc") in (None, 0) or enq is None or caught is None
            or int(caught.group(1)) != int(1e3 * NCCL_TIMEOUT_S)
            or not 1e3 * NCCL_TIMEOUT_S <= int(caught.group(2)) < 1e3 * (NCCL_TIMEOUT_S + 5)):
        raise AssertionError(f"4h: NCCL's collective timeout did not flag the collective and "
                             f"end the process:\n{log[-3000:]}")

    dist.destroy_process_group()
    print(f"4h: phase 4h took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"mesh_launches": a["launches"], "mesh_ba_dist_calls": a["ba_calls"],
            "mesh_fps": a["fps"], **mesh_a, "live_shape": {str(D): rec for D, rec in live.items()}}


_BANNER = re.compile(r"^frame +(\d+) \[(\w+) *\] .* (KF|  ) (ok|TRACK-FAIL)$", re.M)


def _first_parting(a, b, tol):
    """(largest position distance, first frame whose distance exceeds ``tol``
    or None) between two [N,4,4] trajectories."""
    d = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1)
    above = np.flatnonzero(d > tol)
    return float(d.max()), (int(above[0]) if above.size else None)


def _phase_4f(frames, gt, main, run_path, cfg) -> int:
    """Phase 4f, the command-line entry point (see the module docstring).
    Returns the matcher launches of the CLI's --synthetic run."""
    from monocular_visual_odometry_tpu_torch import cli
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.runtime import FrameLoader, decode_png, write_png
    from monocular_visual_odometry_tpu_torch.utils import io as vio
    from monocular_visual_odometry_tpu_torch.utils.checkpoint import load_state

    t_phase = time.perf_counter()
    mods = ("yaml", "PIL", "jax", "matplotlib")
    absent = [m for m in mods if importlib.util.find_spec(m) is None]
    print(f"4f: of {', '.join(mods)}, not installed on this machine: {absent}", flush=True)
    cli_dir = Path(ROOT) / "build" / "cli"
    cfg_dir = Path(ROOT) / "build" / "cli_cfg"
    for d in (cli_dir, cfg_dir):  # a stale run's files never count for this one
        shutil.rmtree(d, ignore_errors=True)
    seq_dir = cli_dir / "synthetic_seq"
    paths = [str(seq_dir / f"rgb_{i:05d}.png") for i in range(N_FRAMES)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(write_png, paths, frames))
    vio.write_trajectory(seq_dir / "cam_traj_truth.txt", gt)
    write_s = time.perf_counter() - t0

    # the decoder: one call after another, then the prefetching loader
    t0 = time.perf_counter()
    for path, f in zip(paths, frames):
        if not np.array_equal(decode_png(path, H, W), f):
            raise AssertionError(f"4f: {path} does not decode to the frame written")
    decode_ms = 1e3 * (time.perf_counter() - t0) / N_FRAMES
    t0 = time.perf_counter()
    with FrameLoader(paths, H, W) as loader:
        n_loaded = sum(1 for _ in loader)
    loader_ms = 1e3 * (time.perf_counter() - t0) / N_FRAMES
    if n_loaded != N_FRAMES:
        raise AssertionError(f"4f: the loader gave {n_loaded} frames of {N_FRAMES}")
    print(f"4f: wrote {N_FRAMES} PNG frames in {write_s:.2f} s; decode {decode_ms:.3f} ms per "
          f"frame one call after another, {loader_ms:.3f} ms per frame through the prefetching "
          f"loader (depth 4, 2 threads); every frame decodes to the frame written", flush=True)

    # the --synthetic run, in-process, so the counts can be read
    argv = ["--synthetic", "--frames", str(N_FRAMES), "--output", str(cli_dir),
            "--checkpoint-every", str(CLI_CHECKPOINT_EVERY), "--viewer", "--save-frames"]
    torch.cuda.synchronize()
    HM.hamming_nn_top2.launches = 0
    BA.ba_update_state.calls = 0
    BL.ba_lm_pose.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches, ba_calls = HM.hamming_nn_top2.launches, BA.ba_update_state.calls
    ba_launches = BL.ba_lm_pose.launches
    log = buf.getvalue()
    (Path(ROOT) / "build" / "cli_stdout.txt").write_text(log)
    print(f"4f: cli.main({argv}) -> {rc} in {cli_s:.2f} s; its [cli] lines:", flush=True)
    for line in log.splitlines():
        if line.startswith("[cli]") and "report:" not in line:
            print(f"  {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"4f: the CLI exited {rc}")
    if "[cli] frame loader: native C++" not in log:
        raise AssertionError("4f: the CLI did not report the native frame loader")
    banners = _BANNER.findall(log)
    names = {"BLANK": S.STAGE_BLANK, "INIT": S.STAGE_INITIALIZING, "TRACK": S.STAGE_TRACKING}
    # the CLI's engine is the graph route: a tracking frame runs two matches
    # (tracking, the keyframe update) and BA, both applied by selects
    prev, n_match, n_ba, n_applied = S.STAGE_BLANK, 0, 0, 0
    for _, stage, kf, ok in banners:
        n_match += {S.STAGE_BLANK: 0, S.STAGE_INITIALIZING: 1}.get(prev, 2)
        n_ba += int(cfg.ba.enabled and prev == S.STAGE_TRACKING)
        n_applied += int(cfg.ba.enabled and prev == S.STAGE_TRACKING and ok == "ok")
        prev = names[stage]
    n_fail = sum(ok != "ok" for *_, ok in banners)
    est = vio.read_trajectory(cli_dir / "cam_traj.txt")
    report = json.loads((cli_dir / "report.json").read_text())
    share = report["ate_sim3"] / report["gt_traj_length"]
    print(f"4f: {len(banners)} frame banners, {n_fail} TRACK-FAIL, final stage {prev}; "
          f"cam_traj.txt {len(est)} rows; report: {report['fps']} fps, Sim3 ATE "
          f"{report['ate_sim3']:.4f} on a {report['gt_traj_length']:.3f} path "
          f"({100 * share:.2f}%), drift_final {report['drift_final']:.4f}, "
          f"{report['map_points']} map points, {report['keyframes']} keyframes; matcher "
          f"launches {launches} (match_features calls from the banners {n_match}), "
          f"ba_update_state calls {ba_calls} (tracking frames {n_ba}; BA applied on the "
          f"{n_applied} with tracking_ok)", flush=True)
    if len(banners) != N_FRAMES or est.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"4f: {len(banners)} banners and {len(est)} rows, expected "
                             f"{N_FRAMES}")
    if prev != S.STAGE_TRACKING or n_fail > 5:
        raise AssertionError(f"4f: final stage {prev}, {n_fail} TRACK-FAIL banners (budget 5)")
    if not share < 0.03:
        raise AssertionError(f"4f: the CLI's ATE is {100 * share:.2f}% of the path (budget 3%)")
    if launches <= 0 or launches != n_match:
        raise AssertionError(f"4f: {launches} matcher launches, expected {n_match}")
    if ba_calls != n_ba or n_ba == 0:
        raise AssertionError(f"4f: {ba_calls} ba_update_state calls, expected {n_ba}")
    _check_ba_kernel("4f", cfg, ba_launches, ba_calls)
    written = ["viewer.html"] + [f"frame_{i:05d}.png" for i in range(N_FRAMES)] + \
        [f"state_{i:05d}.npz" for i in range(CLI_CHECKPOINT_EVERY - 1, N_FRAMES,
                                              CLI_CHECKPOINT_EVERY)]
    missing = [n for n in written if not (cli_dir / n).is_file()]
    if missing:
        raise AssertionError(f"4f: the CLI did not write {missing[:5]}")

    # the same frames in-process (phase 4's main path) and, resumed, from frame
    # 100: the frames from memory (uint8), then through the loader (the PNGs)
    d_cli, part_cli = _first_parting(est, main["est"], POSE_TOL)
    step_ms = {k: float(v) for k, v in re.findall(r"^(vo_step|draw) +\d+ +[\d.]+ +([\d.]+)$",
                                                  log, re.M)}
    resumed, resume_ms = {}, {}
    for source in ("memory", "loader"):
        eng = VOEngine(cfg, H, W, seed=0, device="cuda")
        eng.state = load_state(str(cli_dir / f"state_{CLI_RESUME_FROM - 1:05d}.npz"), eng.state)
        if int(eng.state.frame_idx) != CLI_RESUME_FROM:
            raise AssertionError(f"4f: the checkpoint is at frame {int(eng.state.frame_idx)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            feed = frames[CLI_RESUME_FROM:] if source == "memory" else \
                stack.enter_context(FrameLoader(paths[CLI_RESUME_FROM:], H, W))
            resumed[source] = np.stack([eng.add_frame(f).T_w_c.numpy() for f in feed])
        torch.cuda.synchronize()
        resume_ms[source] = 1e3 * (time.perf_counter() - t0) / (N_FRAMES - CLI_RESUME_FROM)
    dists = {k: _first_parting(v, est[CLI_RESUME_FROM:], POSE_TOL) for k, v in resumed.items()}
    d_res = max(d for d, _ in dists.values())
    print(f"4f: largest pose distance, CLI rows against phase 4's in-process run of the same "
          f"frames {d_cli:.3e} (first frame above {POSE_TOL}: {part_cli}); engine resumed from "
          f"state_{CLI_RESUME_FROM - 1:05d}.npz over frames {CLI_RESUME_FROM}-{N_FRAMES - 1} "
          f"against the CLI's rows: frames from memory {dists['memory'][0]:.3e}, through the "
          f"loader {dists['loader'][0]:.3e} (first frame above {POSE_TOL}: "
          f"{dists['memory'][1]}, {dists['loader'][1]})", flush=True)
    print(f"4f: host ms per frame: phase 4's run {np.mean(main['frame_ms']):.1f} (frames "
          f"{CLI_RESUME_FROM}-{N_FRAMES - 1}: {np.mean(main['frame_ms'][CLI_RESUME_FROM:]):.1f}); "
          f"the CLI's vo_step {step_ms.get('vo_step')} and draw {step_ms.get('draw')} (its "
          f"StageTimer); resumed over frames {CLI_RESUME_FROM}-{N_FRAMES - 1} from memory "
          f"{resume_ms['memory']:.1f}, through the loader {resume_ms['loader']:.1f}", flush=True)
    if d_cli > POSE_TOL or d_res > POSE_TOL:
        # do two in-process runs of the same engine on the card part?
        again = run_path("4f phase 4's engine, a second run", cfg, N_FRAMES)
        d_again, part_again = _first_parting(again["est"], main["est"], POSE_TOL)
        diff = np.flatnonzero(np.abs(again["est"] - main["est"]).max(axis=(1, 2)) > 0)
        print(f"4f: two in-process runs of phase 4's engine: largest pose distance "
              f"{d_again:.3e}, first frame that differs at all "
              f"{int(diff[0]) if diff.size else None}, first above {POSE_TOL}: {part_again}",
              flush=True)
        if part_again is None:
            raise AssertionError("4f: the CLI's (or the resumed) trajectory parts from the "
                                 "in-process run, which two in-process runs do not")
        print("4f: two runs on the card part, so the CLI is held to the budgets above",
              flush=True)

    # the --config run: a reference-layout YAML, a process of its own
    d = cfg.dataset
    (cli_dir / "config.yaml").write_text(f"""%YAML:1.0
---
# reference layout: dataset_name selects the section
dataset_name: "synthetic"
synthetic:
  dataset_dir: "{seq_dir}"
  num_images: {CLI_CONFIG_FRAMES}
  camera_info.fx: {d.fx}
  camera_info.fy: {d.fy}
  camera_info.cx: {d.cx}
  camera_info.cy: {d.cy}
  is_draw_true_traj: "true"
  true_traj_filename: '{seq_dir / "cam_traj_truth.txt"}'
max_num_imgs_to_proc: 300
is_enable_ba: "true"
""")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "monocular_visual_odometry_tpu_torch.cli",
                           "--config", str(cli_dir / "config.yaml"), "--output", str(cfg_dir)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    (Path(ROOT) / "build" / "cli_cfg_stdout.txt").write_text(proc.stdout + proc.stderr)
    print(f"4f: python3 -m monocular_visual_odometry_tpu_torch.cli --config {cli_dir}/config.yaml "
          f"-> {proc.returncode} in {sub_s:.2f} s (process start, imports, card set-up "
          f"included); its last lines:\n" + "\n".join(
              "  " + ln for ln in (proc.stdout + proc.stderr).strip().splitlines()[-6:]),
          flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"4f: the --config run exited {proc.returncode}")
    rows = vio.read_trajectory(cfg_dir / "cam_traj.txt")
    cfg_report = json.loads((cfg_dir / "report.json").read_text())
    if len(rows) != CLI_CONFIG_FRAMES or "ate_sim3" not in cfg_report:
        raise AssertionError(f"4f: the --config run wrote {len(rows)} rows, report keys "
                             f"{sorted(cfg_report)}")
    print(f"4f: --config run: {len(rows)} rows, Sim3 ATE {cfg_report['ate_sim3']:.4f} on a "
          f"{cfg_report['gt_traj_length']:.3f} path, {cfg_report['fps']} fps over "
          f"{CLI_CONFIG_FRAMES} frames (first frames included)", flush=True)
    print(f"4f: in this call, the CLI {report['fps']} fps (report.json: frames / wall, annotated "
          f"frames, checkpoints and viewer included) against phase 4's in-process "
          f"{main['fps']:.2f} fps; PNG decode {decode_ms:.3f} ms per frame "
          f"({loader_ms:.3f} through the loader); phase 4f took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches



def _batch_invariance(cfg, cam, st_init, img_init, st_track, img_track):
    """Each stage of the batched bodies vmapped over B = 2, 4, 8 copies of
    the same inputs against B=1 (largest difference over the copies:
    floats absolute, integers and flags the count of differing entries):
    the frontend must not move at all (its pyramid is taps, not a GEMM)."""
    from torch.utils._pytree import tree_leaves, tree_map

    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops.features import features_from_config

    def diff(a, b):
        out = 0.0
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            if x is None:
                continue
            if x.dtype.is_floating_point:
                out = max(out, float((x - y).abs().nan_to_num(0).max()))
            else:
                out = max(out, float((x != y).sum()))
        return out

    each = lambda fn, t: tree_map(lambda x: None if x is None else fn(x), t)
    one = lambda t: each(lambda x: x[None], t)
    feats_t = features_from_config(img_track, cfg.orb)
    feats_i = features_from_config(img_init, cfg.orb)
    d_t = V.draw_batched(cfg, st_track.rng[None], "cuda")
    d_i = V.draw_general(cfg, st_init.rng[None], "cuda")
    nr = lambda s_: s_._replace(rng=None)
    track = lambda s_, im, u, f: tuple(tree_leaves(V.step_track(
        cfg, cam, s_, im, height=H, width=W, u=u, feats=f)[1]))
    init = lambda s_, im, ue, uh, f: tuple(tree_leaves(V.step_init(
        cfg, cam, s_, im, u_e=ue, u_h=uh, feats=f)[1]))
    stages = {
        "features": (lambda im: tuple(features_from_config(im, cfg.orb)), (img_track[None],)),
        "tracking": (track, (one(nr(st_track)), img_track[None], d_t.pnp, one(feats_t))),
        "BA": (lambda s_: tuple(tree_leaves(BA.ba_update_state(cfg, cam, s_).T_w_c)),
               (one(nr(st_track)),)),
        "init": (init, (one(nr(st_init)), img_init[None], d_i.init_e, d_i.init_h, one(feats_i))),
    }
    found = {}
    for name, (fn, args) in stages.items():
        dims = tuple(V._vmap_dims(a) for a in args)
        base = torch.func.vmap(fn, in_dims=dims)(*args)
        found[name] = []
        for nb in (2, 4, 8):
            many = torch.func.vmap(fn, in_dims=dims)(*each(
                lambda x: x.expand((nb,) + x.shape[1:]).contiguous(), args))
            found[name].append(max(diff(each(lambda x: x[b:b + 1], many), base)
                                   for b in range(nb)))
    print("4i batch invariance, largest difference of a copy at B = 2, 4, 8 from B=1: "
          + "; ".join(f"{k} {v}" for k, v in found.items()), flush=True)
    if any(found["features"]):
        raise AssertionError("4i: the frontend's output depends on the batch size")


def _phase_4i_5pt(cfg, cam, frames, fresh):
    """Phase 4i's general step under the five-point solver at the largest B:
    the captured body against the eager body over the same steps (see the
    module docstring). Returns the run's record."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM

    n = frames.shape[1]
    # the general step under the five-point solver: the captured body (its
    # init's eigh the Jacobi) against the eager body over the same steps
    cfg5 = cfg.replace(ransac=dataclasses.replace(cfg.ransac, essential_minimal="5pt"))
    nb = GENERAL_SIZES[-1]
    _, capture_gib = _with_memory(
        f"4i: capture of the five-point general body at B={nb}",
        lambda: V.run_sequences_general(cfg5, cam, fresh(nb), frames[:nb, :1], height=H, width=W))
    prog = V._batched_program("general", cfg5, cam, nb, H, W, frames.device)
    sts = fresh(nb)
    torch.cuda.synchronize()
    HM.hamming_nn_top2.launches = 0
    BA.ba_update_state.calls = 0
    BL.ba_lm_pose.launches = 0
    replays = prog.replays
    t0 = time.perf_counter()
    final, outs = V.run_sequences_general(cfg5, cam, sts, frames[:nb], height=H, width=W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays = prog.replays - replays
    launches, ba_calls = HM.hamming_nn_top2.launches, BA.ba_update_state.calls
    stage, ok = outs.stage.cpu().numpy(), outs.tracking_ok.cpu().numpy()
    init = [int(np.argmax(stage[:, b] == S.STAGE_TRACKING)) for b in range(nb)]
    r5 = dict(wall_s=wall, fps=nb * n / wall, ms_per_step=1e3 * wall / n, launches=launches,
              ba_calls=ba_calls, replays=replays, capture_s=(prog.warmup_s, prog.capture_s),
              capture_gib=capture_gib, init=init, n_fail=(~ok).sum(0).tolist(), stage=final.stage.cpu().tolist(),
              used_homography_at_init=[bool(outs.used_homography[i, b])
                                       for b, i in enumerate(init)])
    print(f"4i five-point general B={nb}: {n} steps in {wall:.2f} s = {r5['fps']:.2f} fps "
          f"aggregate ({r5['ms_per_step']:.1f} ms per step); warm-up / capture "
          f"{_fmt_secs(r5['capture_s'])} s; matcher launches {launches}, ba_update_state calls "
          f"{ba_calls}, graph replays {replays}; init frame {init}, H won at init "
          f"{r5['used_homography_at_init']}; tracking failures {r5['n_fail']}, final stages "
          f"{r5['stage']}", flush=True)
    if replays != n or launches != 3 * n or ba_calls != n:
        raise AssertionError(f"4i five-point B={nb}: {replays} replays, {launches} matcher "
                             f"launches, {ba_calls} BA calls in {n} steps")
    _check_ba_kernel(f"4i five-point B={nb}", cfg5, BL.ba_lm_pose.launches, ba_calls)
    if any(s_ != S.STAGE_TRACKING for s_ in r5["stage"]):
        raise AssertionError(f"4i five-point B={nb}: final stages {r5['stage']}")
    k = GENERAL_5PT_EAGER_STEPS
    wall_e, d5 = _against_eager(f"4i five-point B={nb}, the first {k} steps", "general", cfg5,
                                cam, sts, frames[:nb, :k], type(outs)(*(t[:k] for t in outs)))
    r5.update(eager_fps=nb * k / wall_e, eager_ms_per_step=1e3 * wall_e / k,
              max_pose_distance=d5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        V.run_sequences_general(cfg5, cam, fresh(nb), frames[:nb, :GENERAL_PROFILE_STEPS],
                                height=H, width=W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ks = _device_kernels(prof)
    busy = sum(ms for _, ms, _ in ks)
    r5.update(kernels_per_step=sum(c for _, _, c in ks) / GENERAL_PROFILE_STEPS,
              busy_ms_per_step=busy / GENERAL_PROFILE_STEPS, busy_share=busy / wall_ms)
    print(f"4i five-point B={nb}: graph {r5['fps']:.2f} fps ({r5['ms_per_step']:.1f} ms per "
          f"step) against the eager body {r5['eager_fps']:.2f} fps "
          f"({r5['eager_ms_per_step']:.1f} ms per step); profile, graph: "
          f"{GENERAL_PROFILE_STEPS} steps, {r5['kernels_per_step']:.0f} device kernels and "
          f"{r5['busy_ms_per_step']:.1f} ms device busy per step ({100 * r5['busy_share']:.1f}% "
          f"of the wall under the profiler)", flush=True)
    return r5


def _phase_4i(cfg, batch_seqs, single, rates):
    """Phase 4i, JAX's ``profile_throughput.py`` "general" protocol: B streams
    in any stage in one vmapped step (``run_sequences_general``) over 4e's
    sequences from fresh states keyed 0..B-1, so every stream goes through
    init; ``single`` holds 4e's single-stream runs of the same streams (its
    warm-up frames and its reference, 60 frames from the same fresh states).
    Returns per B the run's record."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops import lie
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    n = BATCH_FRAMES
    cam = V.VOEngine(cfg, H, W, device="cuda").cam
    frames = torch.from_numpy(np.stack([seq for seq, _ in batch_seqs])).cuda()
    fresh = lambda nb: S.stack_states([S.init_state(cfg, b, "cuda") for b in range(nb)])
    ref = []
    for r, (_, gt) in zip(single, batch_seqs):
        est = np.stack([o.T_w_c.numpy() for o in r["outs"]])
        ref.append(dict(est=est, is_kf=np.array([bool(o.is_keyframe) for o in r["outs"]]),
                        ok=np.array([bool(o.tracking_ok) for o in r["outs"]]),
                        stage=np.array([int(o.stage) for o in r["outs"]]),
                        ate=metrics.ate_rmse(est, gt)))
    worst_single_ate = max(r["ate"] for r in ref)
    # one throw-away step per B: one-time set-up (batched solvers) and each
    # B's capture off the clock
    capture_b, capture_gib = {}, {}
    for nb in GENERAL_SIZES:
        _, capture_gib[nb] = _with_memory(
            f"4i: capture of the general body at B={nb}",
            lambda: V.run_sequences_general(cfg, cam, fresh(nb), frames[:nb, :1], height=H,
                                            width=W))
        prog = V._batched_program("general", cfg, cam, nb, H, W, torch.device("cuda"))
        capture_b[nb] = (prog.warmup_s, prog.capture_s)
    print(f"4i: warm-up / capture seconds of the general body per B: "
          + ", ".join(f"B={nb} {_fmt_secs(v)}" for nb, v in capture_b.items()), flush=True)
    runs = {}
    for nb in GENERAL_SIZES:
        sts = fresh(nb)
        torch.cuda.synchronize()
        HM.hamming_nn_top2.launches = 0
        BA.ba_update_state.calls = 0
        BL.ba_lm_pose.launches = 0
        t0 = time.perf_counter()
        prog = V._batched_program("general", cfg, cam, nb, H, W, frames.device)
        replays = prog.replays
        final, outs = V.run_sequences_general(cfg, cam, sts, frames[:nb], height=H, width=W)
        replays = prog.replays - replays
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, ba_calls = HM.hamming_nn_top2.launches, BA.ba_update_state.calls
        poses = outs.T_w_c.cpu().numpy()
        ok, is_kf = outs.tracking_ok.cpu().numpy(), outs.is_keyframe.cpu().numpy()
        stage = outs.stage.cpu().numpy()
        dist = [np.linalg.norm(poses[:, b, :3, 3] - ref[b]["est"][:, :3, 3], axis=-1)
                for b in range(nb)]
        kf_split = [int(np.argmax(is_kf[:, b] != ref[b]["is_kf"]))
                    if (is_kf[:, b] != ref[b]["is_kf"]).any() else None for b in range(nb)]
        init = [int(np.argmax(stage[:, b] == S.STAGE_TRACKING)) for b in range(nb)]
        r = dict(wall_s=wall, fps=nb * n / wall, ms_per_step=1e3 * wall / n, launches=launches,
                 capture_s=capture_b[nb], capture_gib=capture_gib[nb],
                 ba_calls=ba_calls, n_fail=(~ok).sum(0).tolist(),
                 stage=final.stage.cpu().tolist(), init=init,
                 ate=[metrics.ate_rmse(poses[:, b], batch_seqs[b][1]) for b in range(nb)])
        runs[nb] = r
        print(f"4i general B={nb}: {n} steps in {wall:.2f} s = {r['fps']:.2f} fps aggregate "
              f"({r['ms_per_step']:.1f} ms per step; in this call 4e's tracking-only B="
              f"{BATCH_SIZES[-1]} {rates['tracking']:.2f} fps, single-stream one after "
              f"another {rates['single']:.2f} fps); matcher launches {launches}, "
              f"ba_update_state calls {ba_calls}, graph replays {replays}; init frame {init} (single-stream "
              f"{[int(np.argmax(q['stage'] == S.STAGE_TRACKING)) for q in ref[:nb]]}); "
              f"tracking failures {r['n_fail']}, final stages {r['stage']}, ATE "
              f"{[round(a, 4) for a in r['ate']]} (single-stream "
              f"{[round(q['ate'], 4) for q in ref[:nb]]}); first step whose keyframe decision "
              f"differs {kf_split}, largest pose distance "
              f"{[float(f'{d.max():.3g}') for d in dist]}", flush=True)
        if replays != n:
            raise AssertionError(f"4i B={nb}: {replays} graph replays in {n} steps")
        if launches != 3 * n:
            raise AssertionError(f"4i B={nb}: {launches} matcher launches, expected {3 * n} "
                                 f"(init, tracking and keyframe update, per step)")
        if ba_calls != n:
            raise AssertionError(f"4i B={nb}: {ba_calls} ba_update_state calls, expected {n}")
        _check_ba_kernel(f"4i B={nb}", cfg, BL.ba_lm_pose.launches, ba_calls)
        for b in range(nb):
            if r["stage"][b] != S.STAGE_TRACKING or r["n_fail"][b] > 5:
                raise AssertionError(f"4i B={nb}: stream {b} stage {r['stage'][b]}, "
                                     f"{r['n_fail'][b]} tracking failures (budget 5)")
            if not (dist[b][0] < 1e-3 and is_kf[0, b] == ref[b]["is_kf"][0]
                    and ok[0, b] == ref[b]["ok"][0]):
                raise AssertionError(f"4i B={nb}: stream {b}'s first step is not its "
                                     f"single-stream step (pose distance {dist[b][0]:.3g})")
            if nb == 1 and (kf_split[b] is not None or not dist[b].max() < 1e-3):
                raise AssertionError(f"4i B=1: the run parts from the single-stream run "
                                     f"(keyframe decisions from step {kf_split[b]}, pose "
                                     f"distance up to {dist[b].max():.3g})")
            # at B > 1 rounding can flip a gate and the keys part (see 4e)
            q = ref[b]["ate"]
            if not (abs(r["ate"][b] - q) <= max(0.02, 0.5 * q) or r["ate"][b] <= worst_single_ate):
                raise AssertionError(f"4i B={nb}: stream {b} ATE {r['ate'][b]:.4f} is neither "
                                     f"within max(0.02, half) of its single-stream ATE {q:.4f} "
                                     f"nor below the worst single-stream ATE "
                                     f"{worst_single_ate:.4f}")
        wall_e, _ = _against_eager(f"4i B={nb}", "general", cfg, cam, sts, frames[:nb], outs)
        r.update(eager_fps=nb * n / wall_e, eager_ms_per_step=1e3 * wall_e / n)
        print(f"4i B={nb}: graph {r['fps']:.2f} fps ({r['ms_per_step']:.1f} ms per step) against "
              f"the eager body {r['eager_fps']:.2f} fps ({r['eager_ms_per_step']:.1f} ms per step)",
              flush=True)

    # device kernels per general step and the busy share (profiler, device
    # activity only: the host ops' events of ~18,000 kernels a step take
    # minutes to list; from fresh states: every branch runs for every
    # stream whatever its stage)
    print(f"4i: runs done at {time.perf_counter() - t_phase:.1f} s", flush=True)
    for nb in GENERAL_SIZES:
        for route in ("graph", "eager"):
            run = (V.run_sequences_general if route == "graph" else
                   lambda c, cm, s_, f, height, width: _eager_batched("general", c, cm, s_, f))
            sts = fresh(nb)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(cfg, cam, sts, frames[:nb, :GENERAL_PROFILE_STEPS], height=H, width=W)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            ks = _device_kernels(prof)
            busy = sum(ms for _, ms, _ in ks)
            n_k = sum(c for _, _, c in ks)
            key = "" if route == "graph" else "eager_"
            runs[nb].update({f"{key}kernels_per_step": n_k / GENERAL_PROFILE_STEPS,
                             f"{key}busy_ms_per_step": busy / GENERAL_PROFILE_STEPS,
                             f"{key}busy_share": busy / wall_ms})
            print(f"4i profile B={nb}, {route}: {GENERAL_PROFILE_STEPS} general steps, wall "
                  f"{wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms "
                  f"({100 * busy / wall_ms:.1f}%), {n_k / GENERAL_PROFILE_STEPS:.0f} device "
                  f"kernels per step", flush=True)
            for name, ms, count in ks[:4]:
                print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)
    ratio = runs[GENERAL_SIZES[-1]]["kernels_per_step"] / runs[1]["kernels_per_step"]
    print(f"4i: device kernels per general step, B={GENERAL_SIZES[-1]} against B=1: "
          f"{ratio:.3f}x (limit {KERNELS_PER_STEP_RATIO}x)", flush=True)
    if ratio > KERNELS_PER_STEP_RATIO:
        raise AssertionError(f"4i: B={GENERAL_SIZES[-1]} issues {ratio:.2f}x the kernels of "
                             f"B=1 per general step: a per-stream loop in the step?")
    print(f"4i: profiles done at {time.perf_counter() - t_phase:.1f} s", flush=True)

    # one mixed-stage step: blank, an init attempt that fails and one that
    # succeeds, tracking, and tracking on a blank frame (fails)
    seq = frames[1].float()
    init = int(np.argmax(ref[1]["stage"] == S.STAGE_TRACKING))
    if init < 2:
        raise AssertionError(f"4i: stream 1 initialized at frame {init}: no failing attempt")
    st, states = S.init_state(cfg, 1, "cuda"), []
    for i in range(init + 2):
        states.append(st)
        st, _ = V.step(cfg, cam, st, seq[i], height=H, width=W)
    _batch_invariance(cfg, cam, states[1], seq[init], st, seq[init + 2])
    print(f"4i: batch invariance done at {time.perf_counter() - t_phase:.1f} s", flush=True)
    picked = [S.init_state(cfg, 0, "cuda"), states[1], states[init], st, st]
    imgs = torch.stack([frames[0, 0].float(), seq[1], seq[init], seq[init + 2],
                        torch.zeros_like(seq[0])])
    sts = S.stack_states(picked)
    draws = V.draw_general(cfg, sts.rng, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any wait on the stream raises
    try:
        V.general_batched_body(cfg, cam, sts, imgs, draws, height=H, width=W)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    new, got = V.step_general_batched(cfg, cam, sts, imgs, height=H, width=W, draws=draws)
    t_cpu = time.perf_counter()
    _, want = V.step_general_batched(
        cfg, cam, S.state_to(sts, "cpu"), imgs.cpu(), height=H, width=W,
        draws=V.BatchedDraws(*(None if d is None else d.cpu() for d in draws)))
    t_cpu = time.perf_counter() - t_cpu
    got = S.StepOutput(*(t.cpu() for t in got))
    per_stream = [V.step(cfg, cam, s_, img, height=H, width=W) for s_, img in zip(picked, imgs)]
    exact = ("stage", "n_keypoints", "n_candidates", "is_keyframe", "tracking_ok",
             "ba_rejected_total")
    close = ("n_matches", "n_inliers", "n_map_points")
    d_cpu = [float(lie.pose_distance(got.T_w_c[b], want.T_w_c[b])) for b in range(5)]
    d_step = [float(lie.pose_distance(got.T_w_c[b], o.T_w_c.cpu()))
              for b, (_, o) in enumerate(per_stream)]
    print(f"4i: one mixed-stage B=5 step (blank, init failing at frame 1, init at frame {init}, "
          f"tracking, tracking on a blank frame): its body ran under set_sync_debug_mode('error') "
          f"without a sync; card/CPU "
          + ", ".join(f"{f} {getattr(got, f).tolist()}/{getattr(want, f).tolist()}"
                      for f in exact + close)
          + f"; pose distance to the CPU {[float(f'{d:.3g}') for d in d_cpu]}, to step per "
          f"stream {[float(f'{d:.3g}') for d in d_step]}; the CPU copy's step took "
          f"{t_cpu:.1f} s", flush=True)
    for f in exact:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"4i: card and CPU differ in {f}")
    for f in close:
        g, w_ = getattr(got, f), getattr(want, f)
        if not ((g - w_).abs() <= 0.05 * w_).all():
            raise AssertionError(f"4i: card and CPU {f} differ by more than 5%")
    if got.tracking_ok.tolist() != [True] * 4 + [False] or got.stage.tolist() != [1, 1, 2, 2, 2]:
        raise AssertionError("4i: the mixed step's streams are not in the intended stages")
    for b, (s_, o) in enumerate(per_stream):
        for f in ("stage", "is_keyframe", "tracking_ok"):
            if int(getattr(got, f)[b]) != int(getattr(o, f)):
                raise AssertionError(f"4i: stream {b}'s {f} is not its step's")
        if int(new.rng[b]) != int(s_.rng):
            raise AssertionError(f"4i: stream {b}'s next key is not its step's")
    if not max(d_cpu + d_step) < 1e-3:
        raise AssertionError(f"4i: poses differ by {max(d_cpu + d_step)}")

    runs["5pt"] = _phase_4i_5pt(cfg, cam, frames, fresh)
    print(f"4i: phase 4i took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


def _mem():
    """(reserved, allocated) card memory, GiB."""
    return torch.cuda.memory_reserved() / 2**30, torch.cuda.memory_allocated() / 2**30


def _with_memory(tag, fn):
    """``fn()`` (a call that captures a program), the card's memory before
    and after it printed. Returns (fn's result, reserved GiB it added)."""
    torch.cuda.synchronize()
    before = _mem()
    out = fn()
    torch.cuda.synchronize()
    after = _mem()
    print(f"{tag}: card memory reserved {before[0]:.3f} -> {after[0]:.3f} GiB "
          f"({after[0] - before[0]:+.3f}), allocated {before[1]:.3f} -> {after[1]:.3f} GiB "
          f"({after[1] - before[1]:+.3f})", flush=True)
    return out, after[0] - before[0]


def _from_tests(name):
    """A protocol module of ``tests/`` (it imports torch, numpy and the port
    only), shared with the CPU tests."""
    tests = str(Path(ROOT) / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def _protocol():
    """``tests/eval_protocol.py``: the A/B protocol and gate, the evaluation
    configurations (``tests/test_torch_profiles.py``)."""
    return _from_tests("eval_protocol")


def _ab_job(chart):
    """``eval_protocol.fivepoint_ab`` on the CPU in a pool process, one torch thread:
    ``chart`` "lapack" (the CPU's route) or "jacobi" (the card's route forced
    on CPU tensors: ``lie.eigh_jacobi`` and ``lie.svd3_jacobi``)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from monocular_visual_odometry_tpu_torch.ops import lie
    if chart == "jacobi":
        lie.card_route = lambda t: True
    return _protocol().fivepoint_ab("cpu")


def _fmt_ab(r):
    return (f"rot med {r['rot_err_deg_med']:.4f} p90 {r['rot_err_deg_p90']:.4f}, t-dir med "
            f"{r['t_dir_err_deg_med']:.4f} p90 {r['t_dir_err_deg_p90']:.4f}, fails "
            f"{r['fail_count']}/{r['seeds']}")


def _phase_4j_ab(card, card_s, cpu):
    """Phase 4j (a): the five-point A/B on the card (``card``, eager, in
    ``card_s`` seconds) beside the CPU's two routes (``cpu``: chart ->
    :func:`_ab_job`'s result) and FIVEPOINT_AB_r04.json; the gate against
    CPU LAPACK, and the CPU's forced Jacobi against LAPACK (raises if the
    card misses). Returns the record."""
    P = _protocol()
    with open(Path(ROOT) / "FIVEPOINT_AB_r04.json") as fh:
        jax_ab = json.load(fh)
    print(f"4j (a) five-point A/B (profile_fivepoint_ab.py: {P.AB_SEEDS} seeds, {P.AB_HYP} "
          f"hypotheses, 200 points, 0.5 px): the card's route (Jacobi eigh and 3x3 SVD) in "
          f"{card_s:.1f} s, beside the CPU (LAPACK), the CPU with the card's route forced, "
          f"and JAX (FIVEPOINT_AB_r04.json):", flush=True)
    for k in card:
        print(f"  {k}:", flush=True)
        for name, r in (("card", card[k]), ("CPU LAPACK", cpu["lapack"][k]),
                        ("CPU Jacobi", cpu["jacobi"][k]), ("JAX", jax_ab[k])):
            print(f"    {name:10s} {_fmt_ab(r)}", flush=True)
        if k.endswith("5pt"):
            print(f"    rotation error per seed, card {[round(v, 3) for v in card[k]['rot_each']]}"
                  f", CPU LAPACK {[round(v, 3) for v in cpu['lapack'][k]['rot_each']]}",
                  flush=True)
        # the same errors read on the nearest rotation: a float32 R's ~1e-6
        # departure from the group moves the trace's reading near 0 deg
        orth = {name: r[k]["rot_orth_each"] for name, r in
                (("card", card), ("CPU LAPACK", cpu["lapack"]), ("CPU Jacobi", cpu["jacobi"]))}
        print("    nearest rotation: median " + ", ".join(
            f"{name} {np.median(v):.4f}" for name, v in orth.items())
              + f"; per seed, card against CPU LAPACK up to "
              f"{max(abs(a - b) for a, b in zip(orth['card'], orth['CPU LAPACK'])):.4f} deg",
              flush=True)
    # at outlier fraction 0 every route picks the same model: the card's
    # nearest rotation is the CPU's, seed by seed (ROADMAP §3 item 36)
    apart = {k: max(abs(a - b) for a, b in zip(card[k]["rot_orth_each"],
                                               cpu["lapack"][k]["rot_orth_each"]))
             for k in card if k.startswith("outliers=0.0:")}
    misses = P.ab_gate(card, cpu["lapack"])
    cpu_misses = P.ab_gate(cpu["jacobi"], cpu["lapack"])
    g = P.AB_GATE
    print(f"4j (a) gate (5pt, every fraction; median rotation <= {g['ratio']} x LAPACK's "
          f"+ {g['rot_deg']} deg, median t-dir <= {g['ratio']} x LAPACK's + "
          f"{g['t_deg']} deg, failures <= LAPACK's + {g['fails']}): card against "
          f"CPU LAPACK misses {misses or 'none'}; CPU Jacobi against CPU LAPACK misses "
          f"{cpu_misses or 'none'}; at fraction 0 the card's nearest rotation per seed within "
          f"{AB_ORTH_TOL} deg of CPU LAPACK's: largest gap "
          f"{', '.join(f'{k} {v:.4f}' for k, v in apart.items())}", flush=True)
    if misses:
        raise AssertionError(f"4j (a): the card's five-point chart misses the A/B gate at {misses}")
    if not max(apart.values()) <= AB_ORTH_TOL:
        raise AssertionError(f"4j (a): at outlier fraction 0 the card's rotation parts from the "
                             f"CPU's by {apart} deg on the nearest rotation")
    return dict(card=card, cpu_lapack=cpu["lapack"], cpu_jacobi=cpu["jacobi"], card_s=card_s,
                cpu_jacobi_misses=cpu_misses, orth_apart_at_0=apart)


def _eval_refs():
    """The JAX rows of phase 4j: {(config, sequence): [(label, row)]}, each
    row's mean, min and max ATE and mean final drift (% of the path), median
    init frame (None where not recorded) and failed seeds, from
    ROBUSTNESS_r05.json and BA_ABLATION_r05.json. Its keys are the rows 4j
    runs, in the order each configuration runs its sequences."""
    with open(Path(ROOT) / "ROBUSTNESS_r05.json") as fh:
        rob = json.load(fh)
    with open(Path(ROOT) / "BA_ABLATION_r05.json") as fh:
        abl = json.load(fh)
    norm = lambda r: dict(mean=r["ate_pct_mean"], min=r["ate_pct_min"], max=r["ate_pct_max"],
                          drift=r["drift_final_pct_mean"], init=r["init_frame_median"],
                          failed=r["failed_seeds"])
    abl_row = lambda r: dict(mean=r["ate_pct_mean"], min=min(r["ate_pct_each"]),
                             max=max(r["ate_pct_each"]), drift=r["drift_final_pct_mean"],
                             init=None, failed=r["failed_seeds"])
    fam = lambda p, s: norm(rob["families"]["A_benchmark_clean"][p] if s == "A_clean" else
                            rob["families"]["B_adversarial"][s][p])
    refs = {}
    for p in ("reference_parity", "predict_only", "default", "robust"):
        for s in EVAL_FAMILY:
            refs[(p, s)] = [(f"ROBUSTNESS_r05 {p}", fam(p, s))]
    refs[("default", "A_clean")].append(
        ("BA_ABLATION_r05 ba_on", abl_row(abl["rows"]["benchmark_clean"]["ba_on"])))
    for s in EVAL_FAMILY:
        refs[("default_5pt", s)] = (
            [("ROBUSTNESS_r05 fivepoint_e2e 5pt", norm(rob["fivepoint_e2e"]["5pt"]))]
            if s == "adv_scene+adv_traj" else
            [("ROBUSTNESS_r05 default (8pt; JAX has no 5pt row here)", fam("default", s))])
    for row, seq in EVAL_ABLATION.items():
        for v, p in (("ba_on", "default"), ("ba_off", "ba_off"),
                     ("ba_on_regate3", "ba_on_regate3")):
            if (p, seq) not in refs:
                refs[(p, seq)] = [(f"BA_ABLATION_r05 {v}", abl_row(abl["rows"][row][v]))]
    for s in EVAL_UNDISTORT:
        refs[("default", s)] = [("ROBUSTNESS_r05 undistortion", norm(rob["undistortion"][s]))]
    return refs


def _eval_sequences(clean_seq, rendered):
    """Phase 4j's frames and ground truth by name: the rendered family
    sequences, family A's clean sequence, the ablation's noise rows
    (``perturb_frames`` over the whole stack, as the JAX script draws them)
    and the undistortion rows (profile_robustness_r5.py's lens, distorted
    then undistorted with the true one)."""
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.data import tools

    t0 = time.perf_counter()
    seqs = dict(rendered)
    clean, gt_a = clean_seq
    seqs["A_clean"] = (clean, gt_a)
    adv, gt_b = seqs["adversarial"]
    seqs["benchmark_noise10"] = (syn.perturb_frames(clean, "noise", 10.0), gt_a)
    seqs["benchmark_noise20"] = (syn.perturb_frames(clean, "noise", 20.0), gt_a)
    seqs["adversarial_noise10"] = (syn.perturb_frames(adv, "noise", 10.0), gt_b)
    distorted = _per_frame(lambda fs: np.stack([
        tools.distort_image(f.astype(np.float32), K_TRUE, EVAL_DIST) for f in fs]),
        clean).astype(np.float32)
    undistorted = _per_frame(lambda fs: np.stack([
        tools.undistort_image(f, K_TRUE, EVAL_DIST) for f in fs]), distorted).astype(np.float32)
    seqs["distorted_raw"], seqs["undistorted"] = (distorted, gt_a), (undistorted, gt_a)
    print(f"4j: perturbed, distorted and undistorted {5 * EVAL_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return seqs


def _eval_program(name, c, cam, streams, seqs, tag="4j", n=EVAL_FRAMES):
    """One configuration's streams through ``run_sequences_general`` on the
    card, in batches of one B (at most EVAL_MAX_B), each batch from fresh
    ``init_state(c, seed)`` states over its sequences' first ``n`` frames;
    the first batch's program captured by a throw-away step (its memory
    printed); 3 matcher launches, 1 ``ba_update_state`` call (0 with BA off)
    and 1 replay per step. Returns (per-stream records, the program's
    record)."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as HM
    from monocular_visual_odometry_tpu_torch.utils import metrics

    n_batches = -(-len(streams) // EVAL_MAX_B)
    nb = len(streams) // n_batches
    if nb * n_batches != len(streams):
        raise AssertionError(f"{tag} {name}: {len(streams)} streams do not split into batches of "
                             f"one B")
    fresh = lambda batch: S.stack_states([S.init_state(c, seed, "cuda") for _, seed in batch])
    records, walls, capture_gib = [], [], 0.0
    for i in range(n_batches):
        batch = streams[i * nb:(i + 1) * nb]
        frames = torch.from_numpy(np.stack([seqs[s][0][:n].astype(np.float32)
                                            for s, _ in batch])).cuda()
        if i == 0:
            _, capture_gib = _with_memory(
                f"{tag} {name}: capture of the general body at B={nb}",
                lambda: V.run_sequences_general(c, cam, fresh(batch), frames[:, :1], height=H,
                                                width=W))
        prog = V._batched_program("general", c, cam, nb, H, W, frames.device)
        sts = fresh(batch)
        torch.cuda.synchronize()
        HM.hamming_nn_top2.launches = 0
        BA.ba_update_state.calls = 0
        BL.ba_lm_pose.launches = 0
        replays = prog.replays
        t0 = time.perf_counter()
        final, outs = V.run_sequences_general(c, cam, sts, frames, height=H, width=W)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        replays = prog.replays - replays
        launches, ba_calls = HM.hamming_nn_top2.launches, BA.ba_update_state.calls
        want_ba = n if c.ba.enabled else 0
        if replays != n or launches != 3 * n or ba_calls != want_ba:
            raise AssertionError(f"{tag} {name} batch {i}: {replays} replays, {launches} matcher "
                                 f"launches, {ba_calls} ba_update_state calls in {n} steps "
                                 f"(expected {n}, {3 * n}, {want_ba})")
        _check_ba_kernel(f"{tag} {name} batch {i}", c, BL.ba_lm_pose.launches, ba_calls)
        poses = outs.T_w_c.cpu().numpy()
        stage, ok = outs.stage.cpu().numpy(), outs.tracking_ok.cpu().numpy()
        used_h = outs.used_homography.cpu().numpy()
        final_stage = final.stage.cpu().tolist()
        del frames, final, outs
        for b, (s, seed) in enumerate(batch):
            gt = seqs[s][1][:n]
            est = poses[:, b]
            length = metrics.trajectory_length(gt)
            tracking = stage[:, b] == S.STAGE_TRACKING
            init = int(np.argmax(tracking)) if tracking.any() else None
            good = bool(np.isfinite(est).all()) and final_stage[b] == S.STAGE_TRACKING
            drift = metrics.drift_curve(est, gt) if good else None
            records.append(dict(
                seq=s, seed=seed, failed=not good, init=init,
                used_h=None if init is None else bool(used_h[init, b]),
                n_fail=int((tracking & ~ok[:, b]).sum()),
                ate=100 * metrics.ate_rmse(est, gt) / length if good else None,
                drift=100 * float(drift[-1]) / length if good else None,
                drift_p95=100 * float(np.percentile(drift, 95)) / length if good else None))
    prog = V._batched_program("general", c, cam, nb, H, W, torch.device("cuda"))
    wall = sum(walls)
    rec = dict(streams=len(streams), batch=nb, batches=n_batches, wall_s=wall,
               ms_per_step=1e3 * wall / (n * n_batches), fps=len(streams) * n / wall,
               capture_s=(prog.warmup_s, prog.capture_s), capture_gib=capture_gib)
    print(f"{tag} {name}: {len(streams)} streams x {n} frames in {n_batches} batch(es) of B={nb}: "
          f"{wall:.2f} s = {rec['fps']:.2f} fps aggregate, {rec['ms_per_step']:.1f} ms per "
          f"step; warm-up / capture {_fmt_secs(rec['capture_s'])} s; {3 * n} matcher launches, "
          f"{n if c.ba.enabled else 0} ba_update_state calls and {n} replays per batch",
          flush=True)
    return records, rec


def _eval_row(name, seq, rows, refs):
    """A row's summary (JAX's ``evaluate`` fields), printed beside its JAX
    rows; returns (summary, the gates it misses)."""
    ates = [r["ate"] for r in rows if not r["failed"]]
    drifts = [r["drift"] for r in rows if not r["failed"]]
    inits = [r["init"] for r in rows if r["init"] is not None]
    failed = [r["seed"] for r in rows if r["failed"]]
    row = dict(ate_mean=float(np.mean(ates)) if ates else None,
               ate_min=float(np.min(ates)) if ates else None,
               ate_max=float(np.max(ates)) if ates else None,
               ate_each=ates, drift_mean=float(np.mean(drifts)) if drifts else None,
               init_median=int(np.median(inits)) if inits else None, failed=failed,
               n_fail=[r["n_fail"] for r in rows],
               e_at_init=sum(r["used_h"] is False for r in rows))
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"
    print(f"4j {name} | {seq}: port ATE mean {fmt(row['ate_mean'])}% (min {fmt(row['ate_min'])}, "
          f"max {fmt(row['ate_max'])}; each {[round(a, 2) for a in ates]}), final drift mean "
          f"{fmt(row['drift_mean'])}%, init frame median {row['init_median']} (each "
          f"{[r['init'] for r in rows]}), failed seeds {failed}, tracking failures per seed "
          f"{row['n_fail']}, E won at init on {row['e_at_init']} of {len(rows)} streams",
          flush=True)
    misses = []
    for label, j in refs:
        print(f"    JAX {label}: ATE mean {fmt(j['mean'])}% (min {fmt(j['min'])}, max "
              f"{fmt(j['max'])}), final drift mean {fmt(j['drift'])}%, init frame median "
              f"{j['init']}, failed seeds {j['failed']}", flush=True)
        if len(failed) != j["failed"]:
            misses.append(f"{len(failed)} failed seeds against JAX's {j['failed']} ({label})")
        if row["ate_mean"] is not None and not row["ate_mean"] <= j["max"] + EVAL_BAND_PP:
            misses.append(f"mean ATE {row['ate_mean']:.2f}% above JAX's max {j['max']}% + "
                          f"{EVAL_BAND_PP} pp ({label})")
    return row, misses


def _phase_4j(cfg, clean_seq, rendered):
    """Phase 4j, the JAX package's evaluation configurations on the card
    (see the module docstring). Returns the record."""
    from monocular_visual_odometry_tpu_torch.models import vo as V

    t_phase = time.perf_counter()
    # the CPU's two A/B routes in processes of their own, beside the card's
    # work; the card's A/B first
    ex = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        with _one_blas_thread():
            pool_ab = {chart: ex.submit(_ab_job, chart) for chart in ("lapack", "jacobi")}
        card_ab = _protocol().fivepoint_ab("cuda")
        card_s = time.perf_counter() - t_phase
        print(f"4j: the card's A/B done at {card_s:.1f} s", flush=True)
        seqs = _eval_sequences(clean_seq, rendered)
        rows, programs, misses, e_at_init = _phase_4j_sweep(cfg, seqs, t_phase)
        ab = _phase_4j_ab(card_ab, card_s, {chart: f.result() for chart, f in pool_ab.items()})
    finally:
        ex.shutdown(cancel_futures=True)
    print(f"4j: phase 4j took {time.perf_counter() - t_phase:.1f} s; rows missing their gate: "
          f"{misses or 'none'}", flush=True)
    if misses:
        raise AssertionError(f"4j: {len(misses)} row gate(s) missed: {misses}")
    return dict(ab=ab, rows={f"{p} | {s}": r for (p, s), r in rows.items()}, programs=programs,
                e_at_init=e_at_init)


def _phase_4j_sweep(cfg, seqs, t_phase):
    """Phase 4j (b): every configuration's rows through the general batched
    step, each row printed beside its JAX rows. Returns (rows, programs,
    the gates missed)."""
    from monocular_visual_odometry_tpu_torch.models import vo as V

    # the programs earlier phases captured are released first (each keeps its
    # graph's pool), then each configuration's after its rows
    torch.cuda.synchronize()
    held = _mem()
    n_released = V.release_batched()
    torch.cuda.empty_cache()
    print(f"4j: {n_released} batched programs of phases 4e and 4i held: card memory reserved "
          f"{held[0]:.3f} GiB, allocated {held[1]:.3f} GiB; released: reserved "
          f"{_mem()[0]:.3f} GiB, allocated {_mem()[1]:.3f} GiB", flush=True)
    configs = _protocol().eval_configs(cfg)
    refs = _eval_refs()
    cam = V.VOEngine(cfg, H, W, device="cuda").cam
    rows, programs, misses = {}, {}, []
    for name in EVAL_ORDER:
        c = configs[name]
        streams = [(s, seed) for p, s in refs if p == name for seed in EVAL_SEEDS]
        records, programs[name] = _eval_program(name, c, cam, streams, seqs)
        for seq in dict.fromkeys(s for s, _ in streams):
            row, miss = _eval_row(name, seq, [r for r in records if r["seq"] == seq],
                                  refs[(name, seq)])
            rows[(name, seq)] = row
            misses += [f"{name} | {seq}: {m}" for m in miss]
        before = _mem()
        V.release_batched()
        torch.cuda.empty_cache()
        print(f"4j {name}: program released: card memory reserved {before[0]:.3f} -> "
              f"{_mem()[0]:.3f} GiB; at {time.perf_counter() - t_phase:.1f} s", flush=True)
    # where E won at init: the five-point program against the 8-point default
    # over the same sequences and seeds
    e5 = sum(rows[("default_5pt", s)]["e_at_init"] for s in EVAL_FAMILY)
    e8 = sum(rows[("default", s)]["e_at_init"] for s in EVAL_FAMILY)
    n_fam = len(EVAL_FAMILY) * len(EVAL_SEEDS)
    e_at_init = dict(five_point=e5, eight_point=e8, streams=n_fam)
    e_all = sum(r["e_at_init"] for (p, _), r in rows.items() if p != "default_5pt")
    n_all = sum(len(r["n_fail"]) for (p, _), r in rows.items() if p != "default_5pt")
    print(f"4j: the init went through E on {e5} of {n_fam} five-point streams and on {e8} of "
          f"{n_fam} eight-point streams of the same sequences and seeds (default config); on "
          f"{e_all} of {n_all} eight-point streams of every program", flush=True)
    total = sum(p["capture_gib"] for p in programs.values())
    print(f"4j: the sweep's {len(programs)} configurations' programs added {total:.3f} GiB of "
          f"reserved card memory at capture together (each released after its rows); after the "
          f"sweep: reserved {_mem()[0]:.3f} GiB, allocated {_mem()[1]:.3f} GiB, peak reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}", flush=True)
    return rows, programs, misses, e_at_init


# ---------------------------------------------------------------------------
# phase 4k: the JAX repo's stage-level profiling tools on the card
# (tests/stage_protocol.py), the BA window-policy A/B and planar family C
# ---------------------------------------------------------------------------


def _stage_protocol():
    """``tests/stage_protocol.py``: the pieces of phase 4k
    (``tests/test_torch_stage_protocol.py``)."""
    return _from_tests("stage_protocol")


def _raw_device_events(prof):
    """[(name, ms)] of the trace's device events in the order they ran, read
    from the profiler's raw events: ``prof.events()`` builds a Python record
    per event, which takes seconds over phase 4k's ~10^5 events."""
    events = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e6)
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    return [(n, ms) for _, n, ms in events]


def _markers():
    """PROFILE_MARKERS spin kernels (``torch.cuda._sleep``) on the stream.
    A profile loses device records at its start (seen on an H100: from 1 to
    over 500 of them, more in long windows and late in a long process, so
    counts read short); marker kernels queued first and last take the loss,
    and the counts leave them out (:func:`_without_markers`)."""
    for _ in range(PROFILE_MARKERS):
        torch.cuda._sleep(100)


def _kind(name):
    """A device event's name with the memory kind of a copy or a fill left
    out: the profile can name it "Unknown" for some records of one graph
    node ("Memset (Device)" and "Memset (Unknown)" are both "Memset")."""
    return name.split(" (")[0] if name.startswith(("Memset", "Memcpy")) else name


def _without_markers(kernels):
    """(the kernels by name, names merged by :func:`_kind`, without the
    markers; the markers seen)."""
    merged = {}
    for n, ms, c in kernels:
        if "spin_kernel" not in n:
            t, k = merged.get(_kind(n), (0.0, 0))
            merged[_kind(n)] = (t + ms, k + c)
    return (sorted(((n, t, k) for n, (t, k) in merged.items()), key=lambda r: -r[1]),
            sum(c for n, _, c in kernels if "spin_kernel" in n))


def _profile_replays(name, prog):
    """STAGE_PROFILED replays of ``prog`` under the profiler, device activity
    only, between two runs of markers. Returns (the kernels by name, their
    sequence [(name, ms)] in the order they ran, the marker records lost). A
    replay runs the same graph every time: unless every kernel's count is a
    multiple of STAGE_PROFILED the profile lost records inside the replays
    (raises)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _markers()
        for _ in range(STAGE_PROFILED):
            prog.replay()
        _markers()
        torch.cuda.synchronize()
    events = _raw_device_events(prof)
    seq = [(_kind(n), ms) for n, ms in events if "spin_kernel" not in n]
    by_name = {}
    for n, ms in seq:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + ms, c + 1)
    ks = sorted(((n, t, c) for n, (t, c) in by_name.items()), key=lambda r: -r[1])
    seen = len(events) - len(seq)
    uneven = [(n[:60], c) for n, _, c in ks if c % STAGE_PROFILED]
    if uneven or seen == 0:
        raise AssertionError(f"4k: the profile of {name} lost kernel records inside its "
                             f"replays ({seen} markers of {2 * PROFILE_MARKERS} seen; counts "
                             f"not a multiple of {STAGE_PROFILED}: {uneven[:5]})")
    return ks, seq, 2 * PROFILE_MARKERS - seen


def _measure_pieces(tag, progs, reset=None):
    """Each captured piece of ``progs`` (name -> ``CapturedStep``): the ms of
    STAGE_TIMED replays between two CUDA events, twice in turns (in order,
    then in reverse), and STAGE_PROFILED replays under the profiler: device
    kernels, busy ms and matcher kernels per call, the 5 kernels that take
    the most time. ``reset``: name -> a call that reloads that program's
    inputs (before each turn and before its profile). Returns name -> the
    record."""
    reset = reset or {}
    ms = {k: [] for k in progs}
    for order in (list(progs), list(progs)[::-1]):
        for k in order:
            reset.get(k, lambda: None)()
            ms[k].append(_events_ms(progs[k].replay, STAGE_TIMED))
    out = {}
    for k, prog in progs.items():
        reset.get(k, lambda: None)()
        ks, seq, lost = _profile_replays(k, prog)
        out[k] = dict(
            ms=float(np.mean(ms[k])), turns=ms[k], markers_lost=lost, seq=seq,
            kernels=sum(c for _, _, c in ks) // STAGE_PROFILED,
            busy_ms=sum(t for _, t, _ in ks) / STAGE_PROFILED,
            matcher=sum(c for n, _, c in ks if "hamming_nn_top2" in n) // STAGE_PROFILED,
            ba_kernel=sum(c for n, _, c in ks if "ba_lm_pose" in n) // STAGE_PROFILED,
            counters=dict(prog.per_call),
            top=[(n[:70], t / STAGE_PROFILED, c / STAGE_PROFILED) for n, t, c in ks[:5]])
    return out


def _print_piece(tag, name, r):
    print(f"{tag} {name}: {r['ms']:.3f} ms per call (CUDA events, {STAGE_TIMED} replays, turns "
          f"{' / '.join(f'{v:.3f}' for v in r['turns'])}), {r['kernels']:.0f} device kernels and "
          f"{r['busy_ms']:.3f} ms busy per call ({STAGE_PROFILED} profiled replays; "
          f"{r['markers_lost']} marker records lost), matcher kernels {r['matcher']} per "
          f"call (counted {r['counters']['hamming_nn_top2']})", flush=True)
    for n, t, c in r["top"]:
        print(f"      {t:8.4f} ms  {c:6.1f}x  {n}", flush=True)


def _check_matcher(tag, rec):
    """Each piece launched the matcher MATCHER_PER_CALL times per call, by
    its counter (per replay) and in its profile."""
    want = {k: MATCHER_PER_CALL.get(k, 0) for k in rec}
    got = {k: (r["counters"]["hamming_nn_top2"], r["matcher"]) for k, r in rec.items()}
    print(f"{tag}: matcher launches per call (counted, profiled) "
          + ", ".join(f"{k} {c} / {p}" for k, (c, p) in got.items()), flush=True)
    if any(g != (want[k], want[k]) for k, g in got.items()):
        raise AssertionError(f"{tag}: matcher launches per call (counted, profiled) {got}, "
                             f"expected {want}")


def _check_ba_pieces(tag, rec):
    """Each piece launched ``ba_lm_pose`` once per ``ba_update_state`` call
    (the ``ba_solve`` piece: once), by its counter (per replay) and in its
    profile."""
    want = {k: 1 if k == "ba_solve" else r["counters"]["ba_update_state"]
            for k, r in rec.items()}
    got = {k: (r["counters"]["ba_lm_pose"], r["ba_kernel"]) for k, r in rec.items()}
    print(f"{tag}: ba_lm_pose launches per call (counted, profiled) "
          + ", ".join(f"{k} {c} / {p}" for k, (c, p) in got.items() if c or p or want[k]),
          flush=True)
    if any(g != (want[k], want[k]) for k, g in got.items()):
        raise AssertionError(f"{tag}: ba_lm_pose launches per call (counted, profiled) {got}, "
                             f"expected {want}")


def _stage_shares(tag, rec, prefixes):
    """Each stage's own (kernels, busy ms, ms a call) from the pieces of
    ``rec`` that are cumulative prefixes, in order, of the last one:
    {first prefix: its own, "p->q": q minus p}. Each prefix's kernels are the
    first of the last piece's, in the order they ran (raises otherwise: a
    kernel is compared without its template arguments), so
    the busy ms of a stage is read inside the last piece's profile (its
    kernels [previous prefix, this prefix) in each replay): the busy ms of
    separate profiles differ by up to ~0.5 ms, more than a small stage
    takes. ms a call: the difference of the prefixes' CUDA-event times."""
    # the same node can differ in form between two captures (a fill as a
    # memset in one graph where another copies; a kernel's vector width):
    # positions are matched on the kernel without its template arguments,
    # copies and fills as one kind
    coarse = lambda x: "copy or fill" if x.startswith(("Memset", "Memcpy")) else x.split("<")[0]
    n_all = rec[prefixes[-1]]["kernels"]
    replays = [rec[prefixes[-1]]["seq"][r * n_all:(r + 1) * n_all]
               for r in range(STAGE_PROFILED)]
    within = {}
    for k in prefixes:
        n = rec[k]["kernels"]
        names = [coarse(x) for x, _ in rec[k]["seq"][:n]]
        for rp in replays:
            got = [coarse(x) for x, _ in rp[:n]]
            if got != names:
                i = next(j for j, (x, y) in enumerate(zip(got, names)) if x != y)
                raise AssertionError(
                    f"{tag}: piece {k}'s {n} kernels are not the first of {prefixes[-1]}'s, "
                    f"in order: at {i} {[x[:80] for x in names[max(i - 2, 0):i + 3]]} against "
                    f"{[x[:80] for x in got[max(i - 2, 0):i + 3]]}")
        within[k] = sum(ms for rp in replays for _, ms in rp[:n]) / STAGE_PROFILED
    stages, prev = {}, None
    for k in prefixes:
        base = (0, 0.0, 0.0) if prev is None else (rec[prev]["kernels"], within[prev],
                                                     rec[prev]["ms"])
        stages[k if prev is None else f"{prev}->{k}"] = (
            rec[k]["kernels"] - base[0], within[k] - base[1], rec[k]["ms"] - base[2])
        prev = k
    return stages


def _phase_4k_track(SP, cfg, cam, state_seq, ba_kernels):
    """Phase 4k (a): the tracking frame split by stage and BA's floor on
    ``profile_ba_floor.py``'s state (16 frames of ``state_seq``) and its next
    frame, beside one replay of the tracking program on the same state and
    frame; the gates of the module docstring. Returns the record."""
    from monocular_visual_odometry_tpu_torch.models import state as S
    from monocular_visual_odometry_tpu_torch.models import vo as V

    t0 = time.perf_counter()
    frames = state_seq[0].astype(np.float32)
    st, _ = V.run_sequence(cfg, cam, S.init_state(cfg, 0, "cuda"), frames[:SP.STATE_FRAMES],
                           height=H, width=W)
    if int(st.stage) != S.STAGE_TRACKING:
        raise AssertionError(f"4k: not tracking after {SP.STATE_FRAMES} frames")
    img = torch.from_numpy(frames[SP.STATE_FRAMES]).cuda()
    ch = SP.tracking_chain(cfg, cam, st, img, height=H, width=W)
    fns = SP.track_pieces(cfg, cam, ch, height=H, width=W)
    fns.update(SP.ba_pieces(cfg, cam, ch.new))
    progs = {k: SP.capture(fn, "cuda") for k, fn in fns.items()}
    programs = V.StagePrograms(cfg, cam, H, W, "cuda")
    programs(st, img, S.STAGE_TRACKING, int(st.rng))
    prog = progs["program"] = programs.programs[S.STAGE_TRACKING]
    print(f"4k (a): state after {SP.STATE_FRAMES} frames of make_trajectory"
          f"({SP.STATE_FRAMES + 1}, 0, {SP.STATE_STEP}) (map points {int(st.map.n_valid)}), frame "
          f"{SP.STATE_FRAMES}: tracking_ok {bool(ch.out.tracking_ok)}, keyframe "
          f"{bool(ch.out.is_keyframe)}, {int(ch.out.n_candidates)} candidates, "
          f"{int(ch.out.n_matches)} matches, {int(ch.out.n_inliers)} inliers; {len(progs)} "
          f"pieces captured in {time.perf_counter() - t0:.1f} s", flush=True)
    # the program's replay writes its new state into its buffers: reload them
    reload = lambda: prog.load(ch.st, img, ch.draws)
    rec = _measure_pieces("4k (a)", progs, reset={"program": reload})
    for k in SP.TRACK_ORDER:
        _print_piece("4k (a)", k, rec[k])
    _print_piece("4k (a)", "the tracking program (StagePrograms, one replay)", rec["program"])

    # the split closes: e + ba + keyframe + glue is the tracking program
    parts = [k for k in ("e", "ba", "keyframe", "glue") if k in rec]
    k_sum = sum(rec[k]["kernels"] for k in parts)
    b_sum = sum(rec[k]["busy_ms"] for k in parts)
    k_prog, b_prog = rec["program"]["kernels"], rec["program"]["busy_ms"]
    stages = _stage_shares("4k (a)", rec, SP.PREFIXES)
    stages.update({k: (rec[k]["kernels"], rec[k]["busy_ms"], rec[k]["ms"]) for k in parts[1:]})
    print(f"4k (a) split: {' + '.join(parts)} = {k_sum:.0f} kernels, {b_sum:.3f} ms busy; the "
          f"tracking program {k_prog:.0f} kernels, {b_prog:.3f} ms busy ({k_sum / k_prog - 1:+.2%} "
          f"kernels, limit {SPLIT_KERNEL_TOL:.0%}; {b_sum / b_prog - 1:+.2%} busy, limit "
          f"{SPLIT_BUSY_TOL:.0%}); each stage's own kernels, ms busy (the prefixes' inside e's "
          f"profile) and ms a call (the difference of the prefixes' CUDA-event times): "
          + ", ".join(f"{k} ({v[0]:.0f}, {v[1]:.3f}, {v[2]:+.3f})" for k, v in stages.items()),
          flush=True)
    if not abs(k_sum - k_prog) <= SPLIT_KERNEL_TOL * k_prog:
        raise AssertionError(f"4k: the pieces' kernels ({k_sum}) do not add up to the tracking "
                             f"program's ({k_prog})")
    if not abs(b_sum - b_prog) <= SPLIT_BUSY_TOL * b_prog:
        raise AssertionError(f"4k: the pieces' busy ms ({b_sum:.3f}) do not add up to the "
                             f"tracking program's ({b_prog:.3f})")
    negative = {k: v for k, v in stages.items() if v[0] < 0 or v[1] < 0}
    if negative:
        raise AssertionError(f"4k: stages read negative: {negative}")

    # the matcher ran where the path runs it: one launch in c, d, e and the
    # keyframe update, two in the tracking program (PERF.md section 2)
    _check_matcher("4k (a)", rec)
    _check_ba_pieces("4k (a)", rec)

    # BA: the 12-iteration piece is phase 4c's call, and its parts add up
    n_it = cfg.ba.iterations
    fit = {q: SP.linear_fit(SP.BA_ITERS, [rec[f"ba@{n}"][q] for n in SP.BA_ITERS])
           for q in ("ms", "kernels", "busy_ms")}
    parts_busy = sum(rec[k]["busy_ms"] for k in ("gather_window", "ba_solve", "write_back"))
    print(f"4k (a) BA floor (profile_ba_floor.py): ba_update_state at {list(SP.BA_ITERS)} LM "
          f"iterations: ms {[round(rec[f'ba@{n}']['ms'], 3) for n in SP.BA_ITERS]}, kernels "
          f"{[round(rec[f'ba@{n}']['kernels']) for n in SP.BA_ITERS]}, busy ms "
          f"{[round(rec[f'ba@{n}']['busy_ms'], 3) for n in SP.BA_ITERS]}; per iteration / fixed: "
          + ", ".join(f"{q} {a:.4g} / {b:.4g}" for q, (a, b) in fit.items())
          + f"; gather_window + ba_solve + write_back {parts_busy:.3f} ms busy against "
          f"ba_update_state's {rec['ba']['busy_ms']:.3f} (limit {BA_PARTS_TOL:.0%}); "
          f"{n_it} iterations: {rec[f'ba@{n_it}']['kernels']:.0f} kernels, phase 4c "
          f"{ba_kernels}", flush=True)
    for k in ("gather_window", "ba_solve", "write_back"):
        _print_piece("4k (a)", k, rec[k])
    if rec[f"ba@{n_it}"]["kernels"] != ba_kernels or rec["ba"]["kernels"] != ba_kernels:
        raise AssertionError(f"4k: ba_update_state at {n_it} iterations is "
                             f"{rec[f'ba@{n_it}']['kernels']} kernels, phase 4c's call "
                             f"{ba_kernels}")
    if not abs(parts_busy - rec["ba"]["busy_ms"]) <= BA_PARTS_TOL * rec["ba"]["busy_ms"]:
        raise AssertionError(f"4k: BA's parts take {parts_busy:.3f} ms busy, the whole "
                             f"{rec['ba']['busy_ms']:.3f}")
    del progs, programs, prog, ch
    return dict(pieces={k: {q: r[q] for q in ("ms", "kernels", "busy_ms", "matcher")}
                        for k, r in rec.items()},
                split=dict(kernels=k_sum, busy_ms=b_sum, program_kernels=k_prog,
                           program_busy_ms=b_prog),
                stages={k: dict(kernels=v[0], busy_ms=v[1], ms=v[2]) for k, v in stages.items()},
                ba_fit={q: dict(per_iteration=a, fixed=b) for q, (a, b) in fit.items()})


def _phase_4k_init(SP, cfg, cam, frames):
    """Phase 4k (b): ``profile_init.py``'s pieces of ``bench.py`` cfg1's
    ``init_pair`` (frames 0 and 3 of phase 4's sequence, written as PNGs and
    read back through the port's loader) under the 8-point and five-point
    solvers; piece C must be the init stage program's R, t and inliers.
    Returns the record."""
    from monocular_visual_odometry_tpu_torch.runtime import FrameLoader, write_png

    out_dir = Path(ROOT) / "build" / "4k"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [str(out_dir / f"rgb_{i:05d}.png") for i in SP.INIT_PAIR]
    for path, i in zip(paths, SP.INIT_PAIR):
        write_png(path, frames[i])
    with FrameLoader(paths, H, W) as loader:
        pair = [torch.from_numpy(f.astype(np.float32)).cuda() for f in loader]
    out = {}
    for minimal in ("8pt", "5pt"):
        c = cfg.replace(ransac=dataclasses.replace(cfg.ransac, essential_minimal=minimal))
        R, t, inliers, key, programs = SP.init_program_pose(c, cam, *pair, height=H, width=W)
        R, t, inliers = R.clone(), t.clone(), inliers.clone()
        progs = {k: SP.capture(fn, "cuda") for k, fn in SP.init_pieces(c, cam, *pair, key).items()}
        _, (Rc, tc, ic) = progs["C"].replay()
        same = torch.equal(Rc, R) and torch.equal(tc, t) and torch.equal(ic, inliers)
        rec = _measure_pieces(f"4k (b) {minimal}", progs)
        for k in ("A", "B", "C", "D"):
            _print_piece(f"4k (b) init_pair {minimal}", k, rec[k])
        shares = _stage_shares(f"4k (b) {minimal}", rec, ("A", "B", "C"))
        print(f"4k (b) init_pair {minimal}: each stage's own kernels, ms busy (inside C's "
              f"profile) and ms a call: " + ", ".join(
                  f"{k} ({v[0]:.0f}, {v[1]:.3f}, {v[2]:+.3f})" for k, v in shares.items()),
              flush=True)
        print(f"4k (b) init_pair {minimal}: piece C against the init stage program on the same "
              f"pair and draws: R, t and inliers equal {same} ({int(inliers.sum())} inliers); "
              f"cfg1's init_pair {rec['C']['ms']:.3f} ms per call on the card", flush=True)
        if not same:
            raise AssertionError(f"4k: init piece C parts from the init program ({minimal})")
        _check_matcher(f"4k (b) {minimal}", rec)
        out[minimal] = {k: {q: r[q] for q in ("ms", "kernels", "busy_ms")}
                        for k, r in rec.items()}
        del progs, programs
    return out


def _phase_4k_protocols(cfg, cam, drift_seq, planar_seq):
    """Phase 4k (c): ``profile_drift_ab.py``'s three BA window rows over
    ``make_trajectory(150, 0, 0.05)`` and ``profile_adversarial.py``'s family
    C (``planar_scene()`` x ``make_planar_trajectory(90)``) under both
    selection rules, each configuration's stream through one captured
    general batched step (released after its row). Returns (rows, the
    gates missed)."""
    from monocular_visual_odometry_tpu_torch.models import vo as V

    seqs = {"drift": drift_seq, "planar": planar_seq}
    rows, misses = {}, []
    for kfw, win in DRIFT_ROWS:
        c = cfg.replace(ba=dataclasses.replace(cfg.ba, keyframe_window=kfw, window=win))
        name = f"drift A/B keyframe_window={kfw} window={win}"
        (r,), _ = _eval_program(name, c, cam, [("drift", 0)], seqs, tag="4k (c)")
        V.release_batched()
        rows[name] = r
        jax_ate, jax_drift = DRIFT_JAX.get((kfw, win), (None, None))
        fmt = lambda v: "n/a" if v is None else f"{v:.2f}%"
        print(f"4k (c) {name}: ATE {fmt(r['ate'])}, final drift {fmt(r['drift'])}, p95 drift "
              f"{fmt(r['drift_p95'])} of the path; init frame {r['init']}, tracking failures "
              f"{r['n_fail']}; JAX (docs/PARITY.md, CPU): ATE {fmt(jax_ate)}, final drift "
              f"{fmt(jax_drift)}", flush=True)
        if r["failed"] or r["n_fail"] > 5 or not r["ate"] < 3.0:
            misses.append(f"{name}: failed {r['failed']}, {r['n_fail']} tracking failures, "
                          f"ATE {r['ate']} (budget 3%)")
        elif jax_ate is not None and not r["ate"] <= jax_ate + EVAL_BAND_PP:
            misses.append(f"{name}: ATE {r['ate']:.2f}% above JAX's {jax_ate}% + {EVAL_BAND_PP} pp")
    a, b = (rows[f"drift A/B keyframe_window={k} window=5"]["ate"] for k in (False, True))
    if a is not None and b is not None:
        print(f"4k (c) drift A/B direction: last W frames {a:.2f}% -> keyframe window "
              f"{b:.2f}% ({'better' if b < a else 'not better'}); JAX "
              f"{DRIFT_JAX[(False, 5)][0]}% -> {DRIFT_JAX[(True, 5)][0]}% (better)", flush=True)
    for rule, ref in (("tournament_rule", False), ("reference_rule", True)):
        c = cfg.replace(init=dataclasses.replace(cfg.init, use_reference_selection=ref))
        name = f"family C planar {rule}"
        (r,), _ = _eval_program(name, c, cam, [("planar", 0)], seqs, tag="4k (c)",
                                n=PLANAR_C_FRAMES)
        V.release_batched()
        rows[name] = r
        tracked = None if r["init"] is None else PLANAR_C_FRAMES - r["init"] - r["n_fail"]
        n_track = None if r["init"] is None else PLANAR_C_FRAMES - r["init"]
        print(f"4k (c) {name}: ATE {r['ate'] if r['ate'] is None else round(r['ate'], 2)}% of "
              f"the path, final drift {r['drift'] if r['drift'] is None else round(r['drift'], 2)}"
              f"%, init frame {r['init']} (H at init: {r['used_h']}), tracking_ok on {tracked}/"
              f"{n_track}; JAX (ROBUSTNESS_r04.json C_planar): ATE {PLANAR_C_JAX['ate']}%, init "
              f"frame {PLANAR_C_JAX['init']}, 82/82", flush=True)
        if (r["failed"] or r["init"] is None
                or abs(r["init"] - PLANAR_C_JAX["init"]) > PLANAR_C_INIT_TOL
                or not r["ate"] <= PLANAR_C_JAX["ate"] + EVAL_BAND_PP):
            misses.append(f"{name}: failed {r['failed']}, init frame {r['init']} (JAX "
                          f"{PLANAR_C_JAX['init']} +/- {PLANAR_C_INIT_TOL}), ATE {r['ate']} "
                          f"(limit {PLANAR_C_JAX['ate']} + {EVAL_BAND_PP})")
    return rows, misses


def _phase_4k(cfg, frames, state_seq, drift_seq, planar_seq, ba_kernels):
    """Phase 4k (see the module docstring). Returns the record."""
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine

    t_phase = time.perf_counter()
    SP = _stage_protocol()
    cam = VOEngine(cfg, H, W, device="cuda").cam
    track = _phase_4k_track(SP, cfg, cam, state_seq, ba_kernels)
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase
    init = _phase_4k_init(SP, cfg, cam, frames)
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t_phase
    rows, misses = _phase_4k_protocols(cfg, cam, drift_seq, planar_seq)
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"4k: phase 4k took {took:.1f} s ((a) {t_a:.1f}, (b) {t_b - t_a:.1f}, (c) "
          f"{took - t_b:.1f}); rows missing their gate: {misses or 'none'}", flush=True)
    if misses:
        raise AssertionError(f"4k: {len(misses)} row gate(s) missed: {misses}")
    return dict(track=track, init=init, rows=rows, seconds=took)


def _ba_window(W, K, M, seed):
    """A BA window as ``models/ba.py::gather_window`` gives one (float32, on
    the card): W cameras 0.1 apart looking at M points 4-9 units ahead, K
    observations each at 0.5 px noise (the points behind z = 0.5 invalid),
    the first W - 2 poses perturbed by ~0.02."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 9, M)], 1)
    rot = lie.so3_exp(torch.from_numpy(rng.uniform(-0.05, 0.05, (W, 3)))).numpy()
    T_c_w = np.tile(np.eye(4), (W, 1, 1))
    T_c_w[:, :3, :3] = rot
    T_c_w[:, :3, 3] = -np.einsum("wij,wj->wi", rot, np.outer(np.arange(W), [0.1, 0.02, 0.05]))
    pid = np.stack([rng.choice(M, K, replace=False) for _ in range(W)]).astype(np.int32)
    p_c = np.einsum("wij,wkj->wki", T_c_w[:, :3, :3], pts[pid]) + T_c_w[:, None, :3, 3]
    uv = p_c[..., :2] / p_c[..., 2:] * 615.0 + [320.0, 240.0] + rng.normal(0, 0.5, (W, K, 2))
    xi = np.concatenate([rng.normal(0, 0.02, (W, 3)), rng.normal(0, 0.01, (W, 3))], 1)
    xi[W - 2:] = 0.0
    T0 = lie.se3_exp(torch.from_numpy(xi)) @ torch.from_numpy(T_c_w)
    used = np.zeros(M, bool)
    used[pid] = True
    on = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    return BA.BAProblem(T_c_w=on(T0.numpy(), torch.float32), obs_uv=on(uv, torch.float32),
                        obs_pid=on(pid, torch.int32), obs_valid=on(p_c[..., 2] > 0.5, torch.bool),
                        pts=on(pts, torch.float32), pt_used=on(used, torch.bool),
                        frame_valid=on(np.ones(W, bool), torch.bool))


def _ba_bound(prob, iterations, float64):
    """(bound ms, what bounds it, FLOPs, bytes) of one LM solve on ``prob``:
    each input read once (the landmarks each window links), each output
    written once, and the FLOPs of iterations + 1 passes and W steps an
    iteration."""
    W, K = prob.obs_valid.shape
    used = int(torch.unique(prob.obs_pid).numel())
    flops = W * K * BA_FLOPS_PER_OBS * (iterations + 1) + W * iterations * BA_FLOPS_PER_STEP
    nbytes = 2 * W * 64 + W * K * (8 + 4 + 1) + used * 12 + W + 4 * iterations
    ops_ms = flops / (FP64_PEAK if float64 else FP32_PEAK) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes


def _phase_3_ba():
    """Phase 3, the BA LM kernel (``ba_lm_pose``) at BA_SHAPES: the kernel
    (``ba_solve``, landmarks fixed, vmapped at B > 1) against its plain
    version (``lm_loop``, vmapped at B > 1) on the card, poses within BA_TOL
    (float64: rtol 1e-6), every stream of a batched launch equal to its own
    launch (``torch.equal``) and one launch per call; device and eager ms of
    both, and the kernel's bound. Returns the rows."""
    from monocular_visual_odometry_tpu_torch.models import ba as BA
    from monocular_visual_odometry_tpu_torch.ops.camera import Camera
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    cam = Camera.create(615.0, 615.0, 320.0, 240.0)
    rows = []
    for i, (tag, W_, K_, M_, nb, f64) in enumerate(BA_SHAPES):
        cfg = VOConfig()
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, window=W_, deterministic=f64))
        probs = [_ba_window(W_, K_, M_, 300 + 10 * i + b) for b in range(nb)]
        if nb == 1:
            prob = probs[0]
            kernel = lambda: BA.ba_solve(cfg, cam, prob)
            plain = lambda: BA.lm_loop(cfg.ba, cam, prob)
        else:
            stacked = BA.BAProblem(*(torch.stack(f) for f in zip(*probs)))
            kernel = lambda: torch.func.vmap(
                lambda *f: BA.ba_solve(cfg, cam, BA.BAProblem(*f)))(*stacked)
            plain = lambda: torch.func.vmap(
                lambda *f: BA.lm_loop(cfg.ba, cam, BA.BAProblem(*f)))(*stacked)
        before = BL.ba_lm_pose.launches
        got = kernel()
        launches = BL.ba_lm_pose.launches - before
        want = plain()
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"ba_lm_pose {tag}: {launches} launches for one call")
        err = float((got[0] - want[0]).abs().max())
        cost_err = float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())
        if f64:
            torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-7)
        elif not err <= BA_TOL:
            raise AssertionError(f"ba_lm_pose {tag}: poses differ from the plain version by "
                                 f"{err:.3e} (tolerance {BA_TOL})")
        if nb > 1:
            for b, p in enumerate(probs):
                one = BA.ba_solve(cfg, cam, p)
                if not (torch.equal(one[0], got[0][b]) and torch.equal(one[2], got[2][b])):
                    raise AssertionError(f"ba_lm_pose {tag}: stream {b} of the batched launch "
                                         f"differs from its own launch")
        ms, eager_ms = _time_ms(kernel, 100)
        plain_ms, plain_eager_ms = _time_ms(plain, 2)
        bounds = [_ba_bound(p, cfg.ba.iterations, f64) for p in probs]
        row = dict(shape=tag, W=W_, K=K_, M=M_, batch=nb, float64=f64,
                   iterations=cfg.ba.iterations, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   plain_eager_ms=plain_eager_ms, bound_ms=sum(b[0] for b in bounds),
                   bound_by=bounds[0][1], flops=sum(b[2] for b in bounds),
                   bytes=sum(b[3] for b in bounds), max_abs_err=err, cost_rel_err=cost_err,
                   final_cost=float(got[2][..., -1].max()))
        rows.append(row)
        print(f"kernel ba_lm_pose {tag} B={nb} W={W_} K={K_} M={M_} "
              f"{'float64' if f64 else 'float32'}, {cfg.ba.iterations} iterations: against the "
              f"plain version poses within {err:.3e}, costs within {cost_err:.3e} (relative); "
              f"one launch per call{'; every stream equal to its own launch' if nb > 1 else ''}; "
              f"device: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; eager: kernel "
              f"{eager_ms:.4f} ms, plain {plain_eager_ms:.4f} ms; bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}: {row['flops']} FLOP, {row['bytes']} bytes)", flush=True)
    return rows


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
    from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm as BL
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
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as ex:
        host = ex.submit(build.build_host, "png_gray")  # the CLI's PNG decoder (host C++)
        built = dict(zip((j[0] for j in jobs), ex.map(lambda j: build.build(*j), jobs)))
        host_path, host_secs, _ = host.result()
    print(f"build: {len(jobs)} kernel librar(ies) from {len(sources)} source(s) in the "
          f"package in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (path, secs, log) in built.items():
        print(f"  {name}: {path.name} ({secs:.2f} s)\n{log.strip()}", flush=True)
    print(f"  host PNG decoder: {host_path.name} ({host_secs:.2f} s)", flush=True)

    elapsed("phase 3")
    # ---- 3. kernel against plain version ---------------------------------
    # the three main-path shapes: init 1024x1024 r=100, tracking 1536x1024
    # r=50 with the union gate, keyframe update 1024x1024 r=100
    main_shapes = [("init", 1024, 1024, 100.0, False),
                   ("track", 1536, 1024, 50.0, True),
                   ("keyframe", 1024, 1024, 100.0, False),
                   # the tracking call without the union gate (the profiles
                   # reference_parity and predict_only, phase 4j)
                   ("track_no_union", 1536, 1024, 50.0, False),
                   # phase 4g's cfg6 (1500 keypoints: the two-buffer ring, a
                   # 476-point last stage) and planar width (512 keypoints)
                   ("cfg6_init_keyframe", 1500, 1500, 100.0, False),
                   ("cfg6_track", 1536, 1500, 50.0, True),
                   ("planar_init_keyframe", 512, 512, 100.0, False),
                   ("planar_track", 1536, 512, 50.0, True)]
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

    elapsed("phase 3, BA LM kernel")
    ba_rows = _phase_3_ba()

    elapsed("phase 4")
    # ---- 4. main path: the default config (BA on), then BA off, then 5pt ---
    t0 = time.perf_counter()
    SP = _stage_protocol()
    rendered = _render_all(
        [("bench", 0, N_FRAMES, 0.04)]
        + [("bench", seed, BATCH_FRAMES, 0.05) for seed in range(BATCH_SEQS)]
        + [("bench", 0, ROBUST_FRAMES, 0.05), ("bench", 0, CHAIN_FRAMES, 0.05),
           ("planar", 0, PLANAR_FRAMES, 0.0), ("bench", 0, DIST_FRAMES, 0.05)]
        + [(kind, seed, EVAL_FRAMES, step) for kind, seed, step in EVAL_RENDER.values()]
        # phase 4k: profile_ba_floor.py's 16 frames and the next; family C
        + [("bench", 0, SP.STATE_FRAMES + 1, SP.STATE_STEP), ("planar", 0, PLANAR_C_FRAMES, 0.0)])
    (frames, gt), batch_seqs = rendered[0], rendered[1:1 + BATCH_SEQS]
    robust_seq, chain_seq, planar_seq, seq18 = rendered[1 + BATCH_SEQS:5 + BATCH_SEQS]
    # phase 4j's scene families; its clean family A is 4g's robustness sequence
    eval_rendered = dict(zip(EVAL_RENDER, rendered[5 + BATCH_SEQS:-2]))
    state_seq, planar_c_seq = rendered[-2:]
    assert ROBUST_FRAMES == EVAL_FRAMES
    print(f"rendered {N_FRAMES} + {BATCH_SEQS} x {BATCH_FRAMES} + {ROBUST_FRAMES} + "
          f"{CHAIN_FRAMES} + {PLANAR_FRAMES} (planar) + {DIST_FRAMES} + {len(EVAL_RENDER)} x "
          f"{EVAL_FRAMES} (4j's scene families) + {SP.STATE_FRAMES + 1} + {PLANAR_C_FRAMES} "
          f"(4k) frames in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = VOConfig()
    cfg_no_ba = cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=False))
    cfg_5pt = cfg.replace(ransac=dataclasses.replace(cfg.ransac, essential_minimal="5pt"))
    for c in (cfg, cfg_5pt):  # library init (cuSOLVER, cuBLAS) off the clock
        warm = VOEngine(c, H, W, seed=0, device="cuda")
        for f in frames[:WARM_FRAMES]:
            warm.add_frame(f)
    torch.cuda.synchronize()

    def run_path(name, c, n, route="graph"):
        """:func:`_drive` over the first n frames of phase 4's sequence, held
        to the main path's budgets."""
        r = _drive(c, frames[:n], gt[:n], route=route)
        if not np.isfinite(r["est"]).all():
            raise AssertionError(f"{name}: non-finite pose in the trajectory")
        est = r["est"]
        early_ate = metrics.ate_rmse(est[:EARLY_FRAMES], gt[:EARLY_FRAMES])
        early_len = metrics.trajectory_length(gt[:EARLY_FRAMES])
        print(f"{name}: {n} frames in {r['wall_s']:.2f} s = {r['fps']:.2f} fps; final stage "
              f"{r['stage']}, tracking failures {r['n_fail']}, Sim3 ATE {r['ate']:.4f} on a "
              f"{r['length']:.3f} path ({100 * r['ate'] / r['length']:.2f}%; over the first "
              f"{EARLY_FRAMES} frames {early_ate:.4f} on {early_len:.3f}, "
              f"{100 * early_ate / early_len:.2f}%), kernel launches {r['launches']}, "
              f"match_features calls {r['match_calls']} (max {r['per_frame_max']} per frame), "
              f"ba_update_state calls {r['ba_calls']} (expected {r['ba_expected']}: BA computed "
              f"on every tracking frame on the graph route, on those with tracking_ok on the "
              f"eager one), BA applied on {r['ba_applied']} (tracking frames with tracking_ok), "
              f"ba_rejected_total {r['ba_rejected']}; route {route}: captured stages "
              f"{r['captured']}, {r['replays']} graph replays, warm-up / capture seconds per "
              f"stage {_fmt_capture(r['capture_s'])}", flush=True)
        if r["stage"] != S.STAGE_TRACKING:
            raise AssertionError(f"{name}: the VO never reached tracking")
        if r["n_fail"] > 5:
            raise AssertionError(f"{name}: {r['n_fail']} tracking failures (budget 5)")
        if not r["ate"] < 0.03 * r["length"]:
            raise AssertionError(f"{name}: ATE {r['ate']:.4f} is not below 3% of the path "
                                 f"length {r['length']:.3f}")
        _check_counts(name, c, r)
        return r

    elapsed("phase 4, main path")
    # the graph route (VOEngine: one replay and one readback per frame) and
    # the eager host-branch step, in turns: cfg4 graph, eager, eager, graph;
    # cfg3 graph, eager
    turns = {}
    for route in ("graph", "eager", "eager", "graph"):
        turns.setdefault(route, []).append(run_path(
            f"main path (default config, BA on), {route} route", cfg, N_FRAMES, route))
    main, eager = turns["graph"][0], turns["eager"][0]
    no_ba = run_path("4a BA off (cfg3), graph route", cfg_no_ba, N_FRAMES)
    no_ba_eager = run_path("4a BA off (cfg3), eager route", cfg_no_ba, N_FRAMES, "eager")
    routes = _compare_routes("4", {"cfg4": turns,
                                   "cfg3": {"graph": [no_ba], "eager": [no_ba_eager]}})
    per_ba = 1e3 * (main["wall_s"] - no_ba["wall_s"]) / max(main["ba_calls"], 1)
    print(f"4a: in this call, BA on {main['fps']:.2f} fps against BA off {no_ba['fps']:.2f} "
          f"fps (graph route): {per_ba:.2f} ms more per BA call", flush=True)

    elapsed("phase 4, readback")
    graph_waits = _phase_4_readback(cfg, frames)

    elapsed("phase 4b")
    # ---- 4b. where a tracking frame's time goes (profiler window) ----------
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    device_kernels = _device_kernels

    # the graph route (replays) and the eager step over the same frames, each
    # engine warmed up to frame PROFILE_FROM; device activity only (the host
    # ops' events of the eager frames take minutes to list)
    profile = {}
    for route in ("graph", "eager"):
        eng = VOEngine(cfg, H, W, seed=0, device="cuda") if route == "graph" else _EagerEngine(cfg)
        for f in frames[:PROFILE_FROM]:
            eng.add_frame(f)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in frames[PROFILE_FROM:PROFILE_FROM + PROFILE_FRAMES]:
                eng.add_frame(f)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        kernels_by_time = device_kernels(prof)
        busy_ms = sum(ms for _, ms, _ in kernels_by_time)
        n_kernels = sum(c for _, _, c in kernels_by_time)
        ham_ms = sum(ms for n, ms, _ in kernels_by_time if "hamming_nn_top2" in n)
        ham_n = sum(c for n, _, c in kernels_by_time if "hamming_nn_top2" in n)
        profile[route] = dict(wall_ms=prof_wall_ms, busy_ms=busy_ms, kernels=n_kernels,
                              kernels_per_frame=n_kernels / PROFILE_FRAMES,
                              busy_share=busy_ms / prof_wall_ms, hamming_ms=ham_ms,
                              hamming_launches=ham_n)
        print(f"profile, {route} route: {PROFILE_FRAMES} tracking frames ({PROFILE_FROM}..."
              f"{PROFILE_FROM + PROFILE_FRAMES - 1}, BA on), wall {prof_wall_ms:.1f} ms under the "
              f"profiler, device busy {busy_ms:.1f} ms ({100 * busy_ms / prof_wall_ms:.1f}%), "
              f"{n_kernels} device kernels ({n_kernels / PROFILE_FRAMES:.0f} per frame)",
              flush=True)
        for name, ms, count in kernels_by_time[:8]:
            print(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}", flush=True)
        print(f"profile, {route} route: hamming_nn_top2 {ham_ms:.3f} ms over {ham_n} launches "
              f"({ham_ms / max(ham_n, 1):.4f} ms each, {100 * ham_ms / max(busy_ms, 1e-9):.2f}% "
              f"of device busy time)", flush=True)
        if route == "graph":
            prof_eng = eng
            if ham_n != 2 * PROFILE_FRAMES:
                raise AssertionError(f"4b: the replayed frames' profile shows {ham_n} "
                                     f"hamming_nn_top2 kernels, expected {2 * PROFILE_FRAMES}")
    ham_ms, ham_n = profile["graph"]["hamming_ms"], profile["graph"]["hamming_launches"]

    elapsed("phase 4c")
    # ---- 4c. one ba_update_state on the state after frame PROFILE_FROM+PROFILE_FRAMES
    st = prof_eng.state
    torch.cuda.synchronize()
    calls0, launches0 = BA.ba_update_state.calls, BL.ba_lm_pose.launches
    torch.cuda.set_sync_debug_mode("error")  # any wait on the stream raises
    try:
        got = BA.ba_update_state(cfg, prof_eng.cam, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check_ba_kernel("4c", cfg, BL.ba_lm_pose.launches - launches0,
                     BA.ba_update_state.calls - calls0)
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
        _markers()
        BA.ba_update_state(cfg, prof_eng.cam, st)
        _markers()
        torch.cuda.synchronize()
    ba_kernels, _ = _without_markers(device_kernels(prof))
    with _OpCount() as ops:  # the host's side: aten ops dispatched, views included
        BA.ba_update_state(cfg, prof_eng.cam, st)
    ba_busy = sum(ms for _, ms, _ in ba_kernels)
    ba_n = sum(c for _, _, c in ba_kernels)
    # an eager call's time (host issue included) against the eager route's
    # wall time; its device time against the graph route's, which replays it
    share = ba_ms * eager["ba_calls"] / (1e3 * eager["wall_s"])
    share_graph = ba_busy * main["ba_calls"] / (1e3 * main["wall_s"])
    print(f"4c: ba_update_state after frame {PROFILE_FROM + PROFILE_FRAMES}: ran under "
          f"set_sync_debug_mode('error') without a sync; card against CPU max abs diff "
          f"{ba_err:.3e} (tolerance {BA_TOL}); {ba_ms:.3f} ms per call (CUDA events over 20 "
          f"calls, host included; host clock {ba_wall_ms:.3f} ms), {ops.n} aten ops "
          f"dispatched and {ba_n} device kernels per call, device busy {ba_busy:.3f} "
          f"ms per call; x {eager['ba_calls']} calls = {100 * share:.1f}% of the eager route's "
          f"wall time; device busy x {main['ba_calls']} calls = {100 * share_graph:.1f}% of the "
          f"graph route's", flush=True)
    if not ba_err <= BA_TOL:
        raise AssertionError(f"ba_update_state on the card differs from the CPU by {ba_err}")

    elapsed("phase 4d")
    # ---- 4d. the five-point configuration: graph and eager in turns --------
    turns_5pt = {}
    for route in ("graph", "eager", "eager", "graph"):
        turns_5pt.setdefault(route, []).append(run_path(
            f"4d five-point (essential_minimal='5pt', BA on), {route} route", cfg_5pt, N_FRAMES,
            route))
    five = turns_5pt["graph"][0]
    if five["captured"] != [0, 1, 2] or five["replays"] != five["frames"]:
        raise AssertionError(f"4d: captured stages {five['captured']}, {five['replays']} "
                             f"replays in {five['frames']} frames (every stage a graph)")
    routes_5pt = _compare_routes("4d", {"5pt": turns_5pt})
    print(f"4d: largest pose difference from the main path's trajectory "
          f"{float(np.abs(five['est'] - main['est']).max()):.3e}", flush=True)
    init_5pt = _phase_4d_init(cfg_5pt, frames, five)

    elapsed("phase 4e")
    # ---- 4e. the batched steady state: B streams, one vmapped step ---------
    n_steps = BATCH_FRAMES - BATCH_WARM
    engines, warm_outs = [], []
    t0 = time.perf_counter()
    for seed, (seq, _) in enumerate(batch_seqs):
        eng = VOEngine(cfg, H, W, seed=seed, device="cuda")
        warm_outs.append([eng.add_frame(f) for f in seq[:BATCH_WARM]])
        if int(warm_outs[-1][-1].stage) != S.STAGE_TRACKING:
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
        single.append(dict(wall_s=wall, fps=n_steps / wall, est=est, outs=warm_outs[seed] + outs,
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
    # one throw-away batched step per B: one-time set-up (batched solvers) and
    # each B's capture off the clock
    capture_b, capture_gib = {}, {}
    for nb in BATCH_SIZES:
        _, capture_gib[nb] = _with_memory(
            f"4e: capture of the batched body at B={nb}",
            lambda: V.run_sequences_batched(cfg, cam, S.stack_states(warm[:nb]),
                                            frames_b[:nb, :1], height=H, width=W))
        prog = V._batched_program("tracking", cfg, cam, nb, H, W, torch.device("cuda"))
        capture_b[nb] = (prog.warmup_s, prog.capture_s)
    print(f"4e: warm-up / capture seconds of the batched body per B: "
          + ", ".join(f"B={nb} {_fmt_secs(v)}" for nb, v in capture_b.items()), flush=True)
    batched = {}
    for nb in BATCH_SIZES:
        sts = S.stack_states(warm[:nb])
        torch.cuda.synchronize()
        HM.hamming_nn_top2.launches = 0
        BA.ba_update_state.calls = 0
        BL.ba_lm_pose.launches = 0
        t0 = time.perf_counter()
        prog = V._batched_program("tracking", cfg, cam, nb, H, W, frames_b.device)
        replays = prog.replays
        final, outs = V.run_sequences_batched(cfg, cam, sts, frames_b[:nb], height=H, width=W)
        replays = prog.replays - replays
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
                 capture_s=capture_b[nb], capture_gib=capture_gib[nb],
                 launches=launches, ba_calls=ba_calls, n_fail=(~ok).sum(0).tolist(),
                 stage=stages, ate=[metrics.ate_rmse(poses[:, b], batch_seqs[b][1][BATCH_WARM:])
                                    for b in range(nb)],
                 first_step_dist=[float(d[0]) for d in dist], max_dist=[float(d.max()) for d in dist],
                 first_kf_split=kf_split)
        batched[nb] = r
        print(f"4e batched B={nb}: {n_steps} steps in {wall:.2f} s = {r['fps']:.2f} fps aggregate "
              f"({r['ms_per_step']:.1f} ms per batched step; single-stream in this call: sum "
              f"{single_fps_sum:.2f} fps, one after another {single_fps_seq:.2f} fps); matcher "
              f"launches {launches}, ba_update_state calls {ba_calls}, graph replays {replays}; "
              f"tracking failures "
              f"{r['n_fail']}, final stages {stages}, ATE {[round(a, 4) for a in r['ate']]} "
              f"(single-stream {[round(s_['ate'], 4) for s_ in single[:nb]]}); against the "
              f"single-stream run: first-step pose distance "
              f"{[float(f'{d:.3g}') for d in r['first_step_dist']]}, first step whose keyframe "
              f"decision differs {kf_split}, largest pose distance "
              f"{[float(f'{d:.3g}') for d in r['max_dist']]}", flush=True)
        if replays != n_steps:
            raise AssertionError(f"4e B={nb}: {replays} graph replays in {n_steps} steps")
        if launches != 2 * n_steps:
            raise AssertionError(f"4e B={nb}: {launches} matcher launches, expected "
                                 f"{2 * n_steps} (tracking and keyframe update, per step)")
        if ba_calls != n_steps:
            raise AssertionError(f"4e B={nb}: {ba_calls} ba_update_state calls, expected {n_steps}")
        _check_ba_kernel(f"4e B={nb}", cfg, BL.ba_lm_pose.launches, ba_calls)
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
        if nb in BATCH_PROFILED:  # the eager body beside the graph, in turns
            wall_e, _ = _against_eager(f"4e B={nb}", "tracking", cfg, cam, sts, frames_b[:nb], outs)
            r.update(eager_fps=nb * n_steps / wall_e, eager_ms_per_step=1e3 * wall_e / n_steps)
            print(f"4e B={nb}: graph {r['fps']:.2f} fps ({r['ms_per_step']:.1f} ms per step) "
                  f"against the eager body {r['eager_fps']:.2f} fps "
                  f"({r['eager_ms_per_step']:.1f} ms per step)", flush=True)

    elapsed("phase 4e, profile")
    # device kernels per batched step and the busy share (profiler)
    for nb in BATCH_PROFILED:
        for route in ("graph", "eager"):
            sts = S.stack_states(warm[:nb])
            run = (V.run_sequences_batched if route == "graph" else
                   lambda c, cm, s_, f, height, width: _eager_batched("tracking", c, cm, s_, f))
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(cfg, cam, sts, frames_b[:nb, :BATCH_PROFILE_STEPS], height=H, width=W)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            ks = device_kernels(prof)
            busy = sum(ms for _, ms, _ in ks)
            n_k = sum(c for _, _, c in ks)
            key = "" if route == "graph" else "eager_"
            batched[nb].update({f"{key}kernels_per_step": n_k / BATCH_PROFILE_STEPS,
                                f"{key}busy_ms_per_step": busy / BATCH_PROFILE_STEPS,
                                f"{key}busy_share": busy / wall_ms})
            print(f"4e profile B={nb}, {route}: {BATCH_PROFILE_STEPS} batched steps, wall "
                  f"{wall_ms:.1f} ms under the profiler (device activity only), device busy "
                  f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), {n_k / BATCH_PROFILE_STEPS:.0f} "
                  f"device kernels per batched step", flush=True)
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
    _, step_waits = _sync_calls(lambda: V.step_tracking_batched(cfg, cam, sts, imgs, height=H,
                                                                width=W, draws=draws))
    print(f"4e: one graph-route B={BATCH_SIZES[-1]} step (copies in, replay, the readback of "
          f"[stage, is_keyframe], the returned copies): {step_waits} synchronizing call(s)",
          flush=True)
    if step_waits != 1:
        raise AssertionError(f"4e: a graph-route batched step waited {step_waits} times")

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

    elapsed("phase 4f")
    cli_launches = _phase_4f(frames, gt, main, run_path, cfg)

    elapsed("phase 4g")
    paths = _phase_4g(frames, gt, robust_seq, chain_seq, planar_seq, main, cfg)

    elapsed("phase 4h")
    mesh_info = _phase_4h(frames, gt, seq18, main, cfg, clock_mhz)

    elapsed("phase 4i")
    general = _phase_4i(cfg, batch_seqs, single, dict(
        single=single_fps_seq, tracking=batched[BATCH_SIZES[-1]]["fps"]))

    elapsed("phase 4j")
    evaluation = _phase_4j(cfg, robust_seq, eval_rendered)

    elapsed("phase 4k")
    # profile_drift_ab.py's sequence is 4g's robustness sequence, make_trajectory(150, 0, 0.05)
    stage_profile = _phase_4k(cfg, frames, state_seq, robust_seq, planar_c_seq, ba_n)

    elapsed("phase 5")
    # ---- 5. kernels line and device line ---------------------------------
    track = shape_rows[1]
    kernels = [{
        "name": "hamming_nn_top2",
        "route": "cuda",
        "source": "monocular_visual_odometry_tpu_torch/csrc/hamming_nn_top2.cu",
        "replaces": "monocular_visual_odometry_tpu/ops/pallas/hamming.py:125",
        "launches": main["launches"],
        "cli_launches": cli_launches,
        "cfg6_launches": paths["cfg6"]["launches"],
        "five_point_launches": five["launches"],
        "general_5pt_launches": general["5pt"]["launches"],
        "phase_4g_launches": {tag: r["launches"] for tag, r in paths.items()},
        **mesh_info,
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
        "general_launches": {str(nb): r["launches"] for nb, r in general.items()},
        "general_steps": BATCH_FRAMES,
        "general_fps": {str(nb): r["fps"] for nb, r in general.items()},
        "eval_programs": {name: {k: p[k] for k in ("streams", "batch", "ms_per_step", "fps",
                                                    "capture_s", "capture_gib")}
                          for name, p in evaluation["programs"].items()},
        "eval_e_at_init": evaluation["e_at_init"],
        "stage_profile": {"matcher_per_call": {k: r["matcher"] for k, r in
                                               stage_profile["track"]["pieces"].items()},
                          "split": stage_profile["track"]["split"],
                          "init_pair_ms": {m: r["C"]["ms"] for m, r in stage_profile["init"].items()},
                          "seconds": stage_profile["seconds"]},
        "single_stream_fps_sum": single_fps_sum,
        "graph_route": dict(
            routes, waits_per_frame=graph_waits, five_point=dict(routes_5pt, **init_5pt),
            profile={k: {f: v for f, v in r.items() if f != "hamming_ms"}
                     for k, r in profile.items()},
            batched={str(nb): {k: r.get(k) for k in (
                "fps", "eager_fps", "ms_per_step", "eager_ms_per_step", "kernels_per_step",
                "eager_kernels_per_step", "busy_share", "eager_busy_share", "capture_s",
                "capture_gib")}
                for nb, r in batched.items()},
            general={str(nb): {k: r.get(k) for k in (
                "fps", "eager_fps", "ms_per_step", "eager_ms_per_step", "kernels_per_step",
                "eager_kernels_per_step", "busy_share", "eager_busy_share", "capture_s",
                "capture_gib")}
                for nb, r in general.items()}),
        "card": card,
    }, {
        "name": "ba_lm_pose",
        "route": "cuda",
        "source": "monocular_visual_odometry_tpu_torch/csrc/ba_lm_pose.cu",
        "replaces": None,
        "launches": main["ba_kernel"],
        "ba_update_state_calls": main["ba_calls"],
        "plain": "monocular_visual_odometry_tpu_torch/models/ba.py::lm_loop",
        "ms": ba_rows[0]["ms"],
        "plain_ms": ba_rows[0]["plain_ms"],
        "bound_ms": ba_rows[0]["bound_ms"],
        "bound_by": ba_rows[0]["bound_by"],
        "eager_ms": ba_rows[0]["eager_ms"],
        "shapes": ba_rows,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]) if len(sys.argv) > 1 else main())
