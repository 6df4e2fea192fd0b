"""Fixed-capacity VO state records.

Port of ``monocular_visual_odometry_tpu.models.state``: the same fields and
layouts as NamedTuples of tensors. One difference: ``VOState.rng`` is a
0-d int64 tensor that stays on the CPU (an integer key, split per stage
with ``ops.ransac.split_key``), in place of a JAX PRNG key, so drawing a
stage's key never waits for the device. A stack of B states
(:func:`stack_states`, the batched step's input) has a leading ``[B]`` on
every field, and its ``rng`` is a ``[B]`` int64 tensor on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_visual_odometry_tpu_torch.ops.features import FrameFeatures
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

STAGE_BLANK = 0
STAGE_INITIALIZING = 1
STAGE_TRACKING = 2


def _eye4(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def put_row(a: torch.Tensor, slot, v) -> torch.Tensor:
    """A copy of ``a`` with row ``slot`` set to ``v``. A 0-d tensor ``slot``
    is written through ``index_put``: no readback of the slot, and under
    ``torch.func.vmap`` each stream writes its own row."""
    if not torch.is_tensor(slot):
        out = a.clone()
        out[slot] = v
        return out
    if not torch.is_tensor(v):  # a fill, not a copy from host memory (which syncs)
        v = torch.full(a.shape[1:], v, dtype=a.dtype, device=a.device)
    return a.index_put((slot.reshape(1).to(torch.int64),), v.to(a.dtype).expand(a.shape[1:])[None])


class MapState(NamedTuple):
    """The local map: a fixed pool of landmark slots."""

    pts: torch.Tensor          # [M,3] world positions
    desc: torch.Tensor         # [M,32] uint8 packed descriptors
    normals: torch.Tensor      # [M,3] view direction at creation
    visible: torch.Tensor      # [M] int32
    matched: torch.Tensor      # [M] int32
    valid: torch.Tensor        # [M] bool
    gray: torch.Tensor         # [M] f32 intensity at creation
    created_idx: torch.Tensor  # [M] int32 frame index at creation

    @property
    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))

    @staticmethod
    def empty(capacity: int, device="cuda") -> "MapState":
        return MapState(
            pts=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, 32), dtype=torch.uint8, device=device),
            normals=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            visible=torch.zeros(capacity, dtype=torch.int32, device=device),
            matched=torch.zeros(capacity, dtype=torch.int32, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
            gray=torch.zeros(capacity, dtype=torch.float32, device=device),
            created_idx=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        )


class FrameRing(NamedTuple):
    """Ring buffer of the last F frames: pose, keypoints, keypoint->map links."""

    poses: torch.Tensor     # [F,4,4] T_w_c
    kpts: torch.Tensor      # [F,K,2]
    mp_idx: torch.Tensor    # [F,K] int32, -1 = not linked
    occupied: torch.Tensor  # [F] bool
    is_kf: torch.Tensor     # [F] bool

    @staticmethod
    def empty(n_frames: int, n_kpts: int, device="cuda") -> "FrameRing":
        return FrameRing(
            poses=_eye4(device).repeat(n_frames, 1, 1),
            kpts=torch.zeros((n_frames, n_kpts, 2), dtype=torch.float32, device=device),
            mp_idx=torch.full((n_frames, n_kpts), -1, dtype=torch.int32, device=device),
            occupied=torch.zeros(n_frames, dtype=torch.bool, device=device),
            is_kf=torch.zeros(n_frames, dtype=torch.bool, device=device),
        )

    def push(self, slot, pose, kpts, mp_idx, is_kf=False) -> "FrameRing":
        """Write one slot, an int or a 0-d tensor (functional: returns a new
        ring)."""
        put = lambda a, v: put_row(a, slot, v)
        return FrameRing(poses=put(self.poses, pose), kpts=put(self.kpts, kpts),
                         mp_idx=put(self.mp_idx, mp_idx),
                         occupied=put(self.occupied, True),
                         is_kf=put(self.is_kf, is_kf))


class VOState(NamedTuple):
    """Complete VO engine state."""

    stage: torch.Tensor          # 0-d int32 (STAGE_*)
    frame_idx: torch.Tensor      # 0-d int32
    T_w_c: torch.Tensor          # [4,4] current pose
    last_rel: torch.Tensor       # [4,4] last frame-to-frame motion
    ref_feats: FrameFeatures     # reference keyframe features
    ref_pose: torch.Tensor       # [4,4]
    ref_mp_idx: torch.Tensor     # [K] int32
    ref_frame_idx: torch.Tensor  # 0-d int32
    last_keyframe_pose: torch.Tensor  # [4,4]
    map: MapState
    ring: FrameRing
    erase_ratio: torch.Tensor    # 0-d f32
    rng: torch.Tensor            # 0-d int64 key, on the CPU
    kf_poses: torch.Tensor       # [Kf,4,4]
    kf_count: torch.Tensor       # 0-d int32
    ba_rejected: torch.Tensor    # 0-d int32


class StepOutput(NamedTuple):
    """Per-frame diagnostics."""

    T_w_c: torch.Tensor
    stage: torch.Tensor
    n_keypoints: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    is_keyframe: torch.Tensor
    tracking_ok: torch.Tensor
    used_homography: torch.Tensor
    n_map_points: torch.Tensor
    kpts: torch.Tensor
    kpt_valid: torch.Tensor
    kpt_inlier: torch.Tensor
    ba_rejected_total: torch.Tensor
    n_candidates: torch.Tensor


def _map_fields(fn, *sts: VOState) -> VOState:
    """``fn`` over the tensors of one or more states, field by field (the
    nested records too); ``fn`` gets the field name and the tensors."""
    def go(name, vs):
        if hasattr(vs[0], "_fields"):
            return type(vs[0])(*(go(name, sub) for sub in zip(*vs)))
        return fn(name, *vs)
    return VOState(*(go(name, vs) for name, vs in zip(VOState._fields, zip(*sts))))


def state_to(st: VOState, device) -> VOState:
    """A copy of the state with every tensor on ``device`` but ``rng``, which
    stays on the CPU."""
    return _map_fields(lambda name, t: t if name == "rng" else t.to(device), st)


def stack_states(sts: list[VOState]) -> VOState:
    """B states -> one state with a leading [B] on every field (``rng``
    becomes a [B] int64 tensor on the CPU): the batched step's input."""
    return _map_fields(lambda name, *ts: torch.stack(ts), *sts)


def unstack_state(st: VOState, b: int) -> VOState:
    """Stream ``b`` of a stacked state."""
    return _map_fields(lambda name, t: t[b], st)


def empty_features(k: int, device="cuda") -> FrameFeatures:
    return FrameFeatures(
        kpts=torch.zeros((k, 2), dtype=torch.float32, device=device),
        scores=torch.zeros(k, dtype=torch.float32, device=device),
        angles=torch.zeros(k, dtype=torch.float32, device=device),
        levels=torch.zeros(k, dtype=torch.int32, device=device),
        desc=torch.zeros((k, 32), dtype=torch.uint8, device=device),
        valid=torch.zeros(k, dtype=torch.bool, device=device),
        gray=torch.zeros(k, dtype=torch.float32, device=device),
    )


def init_state(cfg: VOConfig, seed: int = 0, device="cuda") -> VOState:
    """Blank state; ``seed`` becomes the integer RANSAC key (the JAX
    package's ``PRNGKey(seed)``)."""
    k = cfg.orb.max_keypoints
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return VOState(
        stage=i32(STAGE_BLANK),
        frame_idx=i32(0),
        T_w_c=_eye4(device),
        last_rel=_eye4(device),
        ref_feats=empty_features(k, device),
        ref_pose=_eye4(device),
        ref_mp_idx=torch.full((k,), -1, dtype=torch.int32, device=device),
        ref_frame_idx=i32(0),
        last_keyframe_pose=_eye4(device),
        map=MapState.empty(cfg.map.max_map_points, device),
        ring=FrameRing.empty(cfg.map.frame_buffer, k, device),
        erase_ratio=torch.tensor(cfg.map.default_erase_ratio, dtype=torch.float32,
                                 device=device),
        rng=torch.tensor(seed, dtype=torch.int64),
        kf_poses=_eye4(device).repeat(cfg.map.max_keyframes, 1, 1),
        kf_count=i32(0),
        ba_rejected=i32(0),
    )


def push_keyframe(st: VOState, pose: torch.Tensor) -> VOState:
    """Append a pose to the keyframe log (ring over max_keyframes)."""
    slot = st.kf_count.to(torch.int64) % st.kf_poses.shape[0]
    return st._replace(kf_poses=put_row(st.kf_poses, slot, pose), kf_count=st.kf_count + 1)


def insert_map_points(
    m: MapState, pts: torch.Tensor, desc: torch.Tensor, normals: torch.Tensor,
    mask: torch.Tensor, frame_idx=0, gray: torch.Tensor | None = None,
) -> tuple[MapState, torch.Tensor]:
    """Insert the masked rows into the lowest free slots (stable argsort of
    the validity). Rows beyond the free capacity are dropped: they write
    into a scratch row M that is cut off again. Returns (new map, slot per
    row, -1 if dropped)."""
    M = m.valid.shape[0]
    free_order = torch.argsort(m.valid.to(torch.int32), stable=True)
    n_free = torch.sum(~m.valid)
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    can = mask & (pos < n_free)
    slot = torch.where(can, free_order[torch.clamp(pos, 0, M - 1)], torch.full_like(pos, M))
    if gray is None:
        gray = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)

    def put(a, v):
        if not torch.is_tensor(v):  # a fill, not a copy from host memory
            v = torch.full((), v, dtype=a.dtype, device=a.device)
        out = torch.cat([a, a[:1]])  # scratch row M absorbs dropped rows
        out[slot] = v
        return out[:M]

    fi = frame_idx.to(torch.int32) if torch.is_tensor(frame_idx) else int(frame_idx)
    new = MapState(
        pts=put(m.pts, pts), desc=put(m.desc, desc), normals=put(m.normals, normals),
        visible=put(m.visible, 1), matched=put(m.matched, 1),
        valid=put(m.valid, True), gray=put(m.gray, gray),
        created_idx=put(m.created_idx, fi),
    )
    return new, torch.where(can, slot, torch.full_like(slot, -1)).to(torch.int32)
