"""Port parity: the fixed-capacity state updates of the PyTorch package
against the JAX package (CPU), and carrying a state and a config across.

Every update here moves or compares integers and copies floats, so each
comparison is bit-exact: slot assignment by stable argsort, the scratch row
that takes the place of JAX's ``mode="drop"``, and the scatter-max links.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.models import vo as JV
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models import vo as TV
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig as TConfig


def _assert_map_equal(tm, jm):
    for f in JS.MapState._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)


def test_insert_map_points_sequence_bit_identical():
    """Insert, cull and insert again until the pool overflows: the same
    slots, the same map, the same dropped rows."""
    rng = np.random.default_rng(0)
    cap, rows = 64, 24
    jm, tm = JS.MapState.empty(cap), TS.MapState.empty(cap, device="cpu")
    for step in range(8):
        pts = rng.normal(size=(rows, 3)).astype(np.float32)
        desc = rng.integers(0, 256, (rows, 32), dtype=np.uint8)
        nrm = rng.normal(size=(rows, 3)).astype(np.float32)
        gray = rng.uniform(0, 255, rows).astype(np.float32)
        mask = rng.uniform(size=rows) < 0.7
        jm, js = JS.insert_map_points(jm, jnp.asarray(pts), jnp.asarray(desc),
                                      jnp.asarray(nrm), jnp.asarray(mask),
                                      frame_idx=step, gray=jnp.asarray(gray))
        tm, ts = TS.insert_map_points(tm, torch.from_numpy(pts), torch.from_numpy(desc),
                                      torch.from_numpy(nrm), torch.from_numpy(mask),
                                      frame_idx=torch.tensor(step, dtype=torch.int32),
                                      gray=torch.from_numpy(gray))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _assert_map_equal(tm, jm)
        # cull a random third, as the keyframe update does
        keep = rng.uniform(size=cap) > 0.33
        jm = jm._replace(valid=jm.valid & jnp.asarray(keep))
        tm = tm._replace(valid=tm.valid & torch.from_numpy(keep))
    assert (np.asarray(js) == -1).any(), "the sequence never overflowed the pool"


def test_push_keyframe_and_ring_match_jax():
    cfg = JConfig()
    cfg = cfg.replace(orb=dataclasses.replace(cfg.orb, max_keypoints=16),
                      map=dataclasses.replace(cfg.map, max_map_points=32, max_keyframes=3,
                                              frame_buffer=4))
    tcfg = convert.config_to_torch(dataclasses.asdict(cfg))
    js, ts = JS.init_state(cfg, 0), TS.init_state(tcfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(7):  # wraps both rings
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        kpts = rng.uniform(0, 640, (16, 2)).astype(np.float32)
        links = rng.integers(-1, 32, 16).astype(np.int32)
        js = JS.push_keyframe(js, jnp.asarray(pose))
        ts = TS.push_keyframe(ts, torch.from_numpy(pose))
        js = js._replace(ring=js.ring.push(i % 4, jnp.asarray(pose), jnp.asarray(kpts),
                                           jnp.asarray(links), is_kf=i % 2 == 0))
        ts = ts._replace(ring=ts.ring.push(i % 4, torch.from_numpy(pose),
                                           torch.from_numpy(kpts), torch.from_numpy(links),
                                           is_kf=i % 2 == 0))
    np.testing.assert_array_equal(ts.kf_poses.numpy(), np.asarray(js.kf_poses))
    assert int(ts.kf_count) == int(js.kf_count) == 7
    for f in JS.FrameRing._fields:
        np.testing.assert_array_equal(getattr(ts.ring, f).numpy(),
                                      np.asarray(getattr(js.ring, f)), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_links_and_compact_mask_match_jax(seed):
    """Duplicate, negative and out-of-range train indices, as the matcher's
    dedup losers and the -1 links produce them."""
    rng = np.random.default_rng(seed)
    k, m = 40, 64
    base = rng.integers(-1, 50, k).astype(np.int32)
    train = rng.integers(-3, k + 3, m).astype(np.int32)
    values = rng.integers(-1, 200, m).astype(np.int32)
    want = JV.scatter_links(jnp.asarray(base), jnp.asarray(train), jnp.asarray(values))
    got = TV.scatter_links(torch.from_numpy(base), torch.from_numpy(train).long(),
                           torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flags = rng.uniform(size=m) < 0.3
    want = JV.scatter_links(jnp.zeros(k, bool), jnp.asarray(train), jnp.asarray(flags))
    got = TV.scatter_links(torch.zeros(k, dtype=torch.bool), torch.from_numpy(train).long(),
                           torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = rng.uniform(size=m) < 0.4
    for capacity in (8, m):
        np.testing.assert_array_equal(
            TV.compact_mask(torch.from_numpy(mask), capacity).numpy(),
            np.asarray(JV.compact_mask(jnp.asarray(mask), capacity)))
    vals = rng.normal(size=m).astype(np.float32)
    for msk in (mask, np.zeros(m, bool)):
        np.testing.assert_array_equal(
            TV._masked_median(torch.from_numpy(vals), torch.from_numpy(msk)).numpy(),
            np.asarray(JV._masked_median(jnp.asarray(vals), jnp.asarray(msk))))


def test_config_carries_over():
    cfg = JConfig()
    cfg = cfg.replace(match=dataclasses.replace(cfg.match, max_pixel_dist_pnp=40.0),
                      ba=dataclasses.replace(cfg.ba, enabled=False))
    tcfg = convert.config_to_torch(dataclasses.asdict(cfg))
    assert isinstance(tcfg, TConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())


def test_state_round_trip_through_numpy():
    cfg = JConfig()
    cfg = cfg.replace(orb=dataclasses.replace(cfg.orb, max_keypoints=64),
                      map=dataclasses.replace(cfg.map, max_map_points=128))
    js = JS.init_state(cfg, seed=7)
    rng = np.random.default_rng(2)
    js = js._replace(T_w_c=jnp.asarray(rng.normal(size=(4, 4)).astype(np.float32)),
                     map=js.map._replace(valid=jnp.asarray(rng.uniform(size=128) < 0.5)))
    flat = {k: jax.device_get(v) for k, v in js._asdict().items()}
    ts = convert.state_from_numpy(flat, device="cpu")
    back = convert.state_to_numpy(ts)
    for name, value in flat.items():
        if name == "rng":
            assert int(ts.rng) >= 0
            continue
        if hasattr(value, "_asdict"):
            for f, a in value._asdict().items():
                np.testing.assert_array_equal(back[name][f], a, err_msg=f"{name}.{f}")
                assert back[name][f].dtype == a.dtype, f"{name}.{f}"
        else:
            np.testing.assert_array_equal(back[name], value, err_msg=name)
            assert back[name].dtype == np.asarray(value).dtype, name
    other = convert.state_from_numpy({**flat, "rng": jax.random.PRNGKey(8)}, device="cpu")
    assert int(other.rng) != int(ts.rng)
