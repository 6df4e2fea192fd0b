"""Windowed BA's pose-only Levenberg-Marquardt (landmarks fixed) as one
CUDA kernel.

Replaces no Pallas kernel: the JAX package's LM is a ``lax.scan`` that XLA
fuses; ``csrc/ba_lm_pose.cu`` is the card's counterpart of that fusion, every
LM iteration of a window in one launch. :func:`ba_lm_pose` takes
``models/ba.py::ba_solve``'s arguments under ``cfg.ba.fix_map_points`` and
returns its outputs. On CUDA tensors it launches the kernel or raises; on
CPU tensors it runs the kernel's plain version, ``models/ba.py::lm_loop``.
There is no fallback from one to the other.

The call goes through the operator ``mvo::ba_lm_pose``, whose vmap rule
makes ``torch.func.vmap`` (one level) of it a call of
:func:`ba_lm_pose_batched`: on CUDA one launch with one thread block per
stream, on the CPU the plain version per stream. That is how the batched
bodies (``models/vo.py::tracking_batched_body``, ``general_batched_body``)
solve B windows at once. The library is built and loaded at the first
launch.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from monocular_visual_odometry_tpu_torch.ops.cuda import build
from monocular_visual_odometry_tpu_torch.utils.config import BAConfig

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ba_lm_pose")
        fn = lib.ba_lm_pose_launch
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I] + [D] * 12 + [I, P, P, P]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"ba_lm_pose: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"ba_lm_pose: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ba_lm_pose: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"ba_lm_pose: {name} must be contiguous")


def _launch(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params, iterations,
            float64):
    """One kernel launch over B streams: T_c_w [B,W,4,4] f32, obs_uv
    [B,W,K,2] f32, obs_pid [B,W,K] int32, obs_valid [B,W,K] bool, pts [B,M,3]
    f32, frame_valid [B,W] bool, on one CUDA device. Returns (T_c_w
    [B,W,4,4], costs [B,iterations]), float32."""
    dev = T_c_w.device
    if dev.type != "cuda":
        raise ValueError(f"ba_lm_pose: unsupported device {dev}")
    b, w, k, m = T_c_w.shape[0], T_c_w.shape[1], obs_uv.shape[2], pts.shape[1]
    for name, t, dt, shape in (("T_c_w", T_c_w, torch.float32, (b, w, 4, 4)),
                               ("obs_uv", obs_uv, torch.float32, (b, w, k, 2)),
                               ("obs_pid", obs_pid, torch.int32, (b, w, k)),
                               ("obs_valid", obs_valid, torch.bool, (b, w, k)),
                               ("pts", pts, torch.float32, (b, m, 3)),
                               ("frame_valid", frame_valid, torch.bool, (b, w))):
        _check(name, t, dt, shape, dev)
    T_out = torch.empty((b, w, 4, 4), dtype=torch.float32, device=dev)
    costs = torch.empty((b, iterations), dtype=torch.float32, device=dev)
    err = _library().ba_lm_pose_launch(
        *(t.data_ptr() for t in (T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid)),
        b, w, k, m, iterations, *params, int(float64), T_out.data_ptr(), costs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise ValueError(f"ba_lm_pose: a window of {w} frames x {k} observations over {m} "
                         f"landmarks does not fit the kernel's shared memory")
    if err != 0:
        raise RuntimeError(f"ba_lm_pose launch failed: CUDA error {err}")
    ba_lm_pose.launches += 1
    return T_out, costs


def _settings(params: Sequence[float], w: int, iterations: int, float64: bool):
    """(BAConfig, Camera) of the operator's flat parameters (see :func:`_params`)."""
    from monocular_visual_odometry_tpu_torch.ops.camera import Camera

    fx, fy, cx, cy, *info, huber, lam0, regate_px, sigma_mult = params
    bc = BAConfig(window=w, information_matrix=tuple(info), fix_map_points=True,
                  iterations=iterations, huber_delta=huber, init_lambda=lam0,
                  regate_px=regate_px, regate_sigma_mult=sigma_mult, deterministic=float64)
    return bc, Camera(fx, fy, cx, cy)


def _plain(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params, iterations, float64):
    """The plain version on one stream's CPU tensors: ``models/ba.py::lm_loop``."""
    from monocular_visual_odometry_tpu_torch.models import ba

    bc, cam = _settings(params, T_c_w.shape[0], iterations, float64)
    prob = ba.BAProblem(T_c_w=T_c_w, obs_uv=obs_uv, obs_pid=obs_pid, obs_valid=obs_valid,
                        pts=pts, pt_used=None, frame_valid=frame_valid)
    T_new, _, costs = ba.lm_loop(bc, cam, prob)
    return T_new.clone(), costs  # an operator's output may not alias its input


def ba_lm_pose_batched(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params,
                       iterations, float64):
    """B independent solves in one: every input carries a leading [B];
    returns (T_c_w [B,W,4,4], costs [B,iterations]). On CUDA tensors one
    kernel launch, on CPU tensors the plain version per stream."""
    if T_c_w.device.type == "cpu":
        outs = [_plain(*one, params, iterations, float64)
                for one in zip(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid)]
        return tuple(torch.stack(o) for o in zip(*outs))
    return _launch(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params, iterations,
                   float64)


@torch.library.custom_op("mvo::ba_lm_pose", mutates_args=())
def _op(T_c_w: torch.Tensor, obs_uv: torch.Tensor, obs_pid: torch.Tensor,
        obs_valid: torch.Tensor, pts: torch.Tensor, frame_valid: torch.Tensor,
        params: Sequence[float], iterations: int,
        float64: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if T_c_w.device.type == "cpu":
        return _plain(T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params, iterations,
                      float64)
    T_new, costs = _launch(*(t[None] for t in (T_c_w, obs_uv, obs_pid, obs_valid, pts,
                                               frame_valid)), params, iterations, float64)
    return T_new[0], costs[0]


@_op.register_vmap
def _op_vmap(info, in_dims, T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid, params,
             iterations, float64):
    """vmap of the operator: the batch dim to the front (an unbatched input
    is expanded), then one :func:`ba_lm_pose_batched` call."""
    def front(t, d):
        t = t.expand((info.batch_size,) + t.shape) if d is None else t.movedim(d, 0)
        return t.contiguous()
    args = map(front, (T_c_w, obs_uv, obs_pid, obs_valid, pts, frame_valid), in_dims[:6])
    return ba_lm_pose_batched(*args, params, iterations, float64), (0, 0)


def _params(bc: BAConfig, cam) -> list[float]:
    """The operator's flat parameters: the camera, the information matrix,
    Huber delta, the initial lambda, the re-gate's pixels and sigma multiple."""
    return [float(v) for v in (*cam, *bc.information_matrix, bc.huber_delta, bc.init_lambda,
                               bc.regate_px, bc.regate_sigma_mult)]


def ba_lm_pose(bc: BAConfig, cam, prob):
    """``ba_solve`` with the landmarks fixed, under the BA settings ``bc``
    (``cfg.ba``) and the camera ``cam``, on a ``models/ba.py::BAProblem``
    (its ``pt_used`` is not read). Returns (new T_c_w [W,4,4], pts [M,3] as
    given, the accepted cost per valid observation after each iteration
    [iterations]), float32. Under ``torch.func.vmap`` the whole batch is one
    launch. Raises for the joint mode, which is ``lm_loop``'s alone."""
    if not bc.fix_map_points:
        raise ValueError("ba_lm_pose: the kernel solves the pose-only LM (fix_map_points); "
                         "the joint mode is models/ba.py::lm_loop")
    T_new, costs = _op(prob.T_c_w, prob.obs_uv, prob.obs_pid, prob.obs_valid, prob.pts,
                       prob.frame_valid, _params(bc, cam), int(bc.iterations),
                       bool(bc.deterministic))
    return T_new, prob.pts, costs


ba_lm_pose.launches = 0  # kernel launches since the last reset, batched or not
