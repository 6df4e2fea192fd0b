"""Port parity for state checkpoints: the port's ``save_state`` /
``load_state`` against the JAX package's, on the CPU.

Both write the same ``.npz`` layout (``treedef``, ``n_leaves``, ``leaf_i``
in the records' field order; 33 leaves). A port checkpoint resumes a run
bit for bit; a checkpoint written by the JAX package loads into the port
equal to ``convert.state_from_numpy`` of the same state, its two-word key
folded as ``convert`` folds it, and resumes the port's run; mismatches
raise with the JAX package's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.models import state as JS
from monocular_visual_odometry_tpu.utils import checkpoint as jck
from monocular_visual_odometry_tpu.utils.config import VOConfig as JConfig
from monocular_visual_odometry_tpu_torch import convert
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.models import state as TS
from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
from monocular_visual_odometry_tpu_torch.utils import checkpoint as tck

N_FRAMES = 8  # the state after frame N_FRAMES - 2 is saved, the last frame resumes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine's ops are small, and beside other
    test workers a pool of threads per process only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(map_points=2048):
    cfg = JConfig()
    return cfg.replace(orb=dataclasses.replace(cfg.orb, max_keypoints=512, num_keypoints=4000),
                       ransac=dataclasses.replace(cfg.ransac, pnp_n_hypotheses=128),
                       map=dataclasses.replace(cfg.map, max_map_points=map_points))


def _tcfg(map_points=2048):
    return convert.config_to_torch(dataclasses.asdict(_jcfg(map_points)))


def _assert_states_equal(a, b):
    la, lb = tck._leaves(a), tck._leaves(b)
    assert len(la) == len(lb) == 33
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"
    assert a.rng.device.type == "cpu"


@pytest.fixture(scope="module")
def run():
    """The port's engine on the CPU: the state before the last frame and
    that frame's output."""
    frames, _ = tsyn.render_sequence_arrays(N_FRAMES, seed=0, translation_step=0.05)
    eng = VOEngine(_tcfg(), 480, 640, device="cpu")
    for f in frames[:-1]:
        eng.add_frame(f)
    saved = eng.state
    last = eng.add_frame(frames[-1])
    return frames, saved, last


def _resume(frames, st):
    eng = VOEngine(_tcfg(), 480, 640, seed=123, device="cpu")
    eng.state = st
    return eng.add_frame(frames[-1])


def _assert_outputs_equal(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f


def test_treedef_is_spelled_as_jax():
    _, jdef = jax.tree_util.tree_flatten(JS.init_state(_jcfg()))
    assert tck._treedef(TS.init_state(_tcfg(), device="cpu")) == str(jdef)


def test_round_trip_resumes_bit_for_bit(run, tmp_path):
    frames, saved, last = run
    assert int(saved.stage) == TS.STAGE_TRACKING
    path = str(tmp_path / "sub" / "state.npz")
    tck.save_state(path, saved)
    back = tck.load_state(path, TS.init_state(_tcfg(), seed=7, device="cpu"))
    _assert_states_equal(back, saved)
    _assert_outputs_equal(_resume(frames, back), last)


def _as_jax_state(st):
    """The port state as a JAX VOState: the same arrays, the key as the two
    uint32 words that fold back into it."""
    nested = {"ref_feats": JS.FrameFeatures, "map": JS.MapState, "ring": JS.FrameRing}
    fields = {}
    for name, v in convert.state_to_numpy(st).items():
        if name in nested:
            fields[name] = nested[name](**{f: jnp.asarray(x) for f, x in v.items()})
        elif name == "rng":
            k = int(v) << 1
            fields[name] = jnp.asarray([k >> 32, k & 0xFFFFFFFF], dtype=jnp.uint32)
        else:
            fields[name] = jnp.asarray(v)
    return JS.VOState(**fields)


def test_jax_checkpoint_resumes_in_the_port(run, tmp_path):
    frames, saved, last = run
    jst = _as_jax_state(saved)
    path = str(tmp_path / "jax_state.npz")
    jck.save_state(path, jst)
    back = tck.load_state(path, TS.init_state(_tcfg(), device="cpu"))
    _assert_states_equal(back, convert.state_from_numpy(jax.device_get(jst), device="cpu"))
    _assert_states_equal(back, saved)
    _assert_outputs_equal(_resume(frames, back), last)


def test_jax_checkpoint_of_any_values_loads_as_convert(tmp_path):
    """Every leaf random (a random key too): the port's load equals
    ``convert.state_from_numpy`` of the same JAX state."""
    rng = np.random.default_rng(0)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return jnp.asarray(rng.uniform(size=a.shape) < 0.5)
        if a.dtype.kind in "iu":
            return jnp.asarray(rng.integers(0, 200, a.shape).astype(a.dtype))
        return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))

    jst = jax.tree.map(fill, JS.init_state(_jcfg()))
    jst = jst._replace(rng=jnp.asarray(rng.integers(0, 2**32, 2, dtype=np.uint64), jnp.uint32))
    path = str(tmp_path / "jax_random.npz")
    jck.save_state(path, jst)
    back = tck.load_state(path, TS.init_state(_tcfg(), device="cpu"))
    _assert_states_equal(back, convert.state_from_numpy(jax.device_get(jst), device="cpu"))


def _messages(path, jlike, tlike):
    with pytest.raises(ValueError) as je:
        jck.load_state(path, jlike)
    with pytest.raises(ValueError) as te:
        tck.load_state(path, tlike)
    return str(je.value), str(te.value)


def test_capacity_mismatch_raises_as_jax(tmp_path):
    path = str(tmp_path / "small.npz")
    tck.save_state(path, TS.init_state(_tcfg(map_points=1024), device="cpu"))
    jmsg, tmsg = _messages(path, JS.init_state(_jcfg()), TS.init_state(_tcfg(), device="cpu"))
    assert "has shape (1024, 3)" in tmsg and "(2048, 3)" in tmsg
    assert tmsg == jmsg


def test_leaf_count_and_structure_mismatch_raise_as_jax(tmp_path):
    path = str(tmp_path / "st.npz")
    tck.save_state(path, TS.init_state(_tcfg(), device="cpu"))
    with np.load(path) as data:
        arrays = dict(data)
    fewer = dict(arrays, n_leaves=np.asarray(32))
    np.savez(tmp_path / "fewer.npz", **fewer)
    jlike, tlike = JS.init_state(_jcfg()), TS.init_state(_tcfg(), device="cpu")
    jmsg, tmsg = _messages(str(tmp_path / "fewer.npz"), jlike, tlike)
    assert tmsg == jmsg == "checkpoint has 32 leaves, template has 33"
    other = bytes(arrays["treedef"]).decode().replace("MapState", "OtherState")
    np.savez(tmp_path / "other.npz",
             **dict(arrays, treedef=np.frombuffer(other.encode(), dtype=np.uint8)))
    jmsg, tmsg = _messages(str(tmp_path / "other.npz"), jlike, tlike)
    assert tmsg == jmsg and "does not match the template" in tmsg
