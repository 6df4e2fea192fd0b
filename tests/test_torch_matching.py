"""Port parity: the Hamming matcher of the PyTorch package against the JAX
package (CPU). The kernel cases live in ``test_torch_cuda.py``, which also
holds the CUDA kernel against its plain version on the card.

All values are small integers (Hamming distances <= 256, indices) or
exact fp32 products of the inputs, so every comparison is bit-exact,
including the lowest-index tie rule and the union radius gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.ops import matching as JM
from monocular_visual_odometry_tpu.ops.pallas.hamming import hamming_nn_top2 as jax_kernel
from monocular_visual_odometry_tpu_torch.ops import matching as TM
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH
from test_torch_cuda import CASES


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_kernel(case):
    make, r = CASES[case]
    x = make()
    pm1 = lambda d: JM.unpack_pm1(jnp.asarray(d))
    alt = None if x["alt"] is None else jnp.asarray(x["alt"])
    want = jax_kernel(pm1(x["d1"]), jnp.asarray(x["uv1"]), jnp.asarray(x["v1"]),
                      pm1(x["d2"]), jnp.asarray(x["uv2"]), jnp.asarray(x["v2"]),
                      jnp.float32(r), uv1_alt=alt, interpret=True)
    t = {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in x.items()}
    got = TH.hamming_nn_top2(t["d1"], t["uv1"], t["v1"], t["d2"], t["uv2"], t["v2"],
                             r, uv1_alt=t["alt"])
    for g, w, what in zip(got, want, ("best", "second", "idx")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    if case == "forced_tie":
        assert (got[0] == got[1]).all() and (got[2] < 128).all()


def test_unpack_pm1_matches_jax():
    d = np.random.default_rng(9).integers(0, 256, (64, 32), dtype=np.uint8)
    np.testing.assert_array_equal(TH.unpack_pm1(torch.from_numpy(d)).numpy(),
                                  np.asarray(JM.unpack_pm1(jnp.asarray(d))))


def test_all_pairs_helpers_match_jax():
    """The JAX XLA route's building blocks, which make up the plain version."""
    x = CASES["forced_tie"][0]()
    x["v1"][::7] = False
    jd = JM.hamming_matrix(jnp.asarray(x["d1"]), jnp.asarray(x["d2"]),
                           jnp.asarray(x["v1"]), jnp.asarray(x["v2"]))
    td = TH.hamming_matrix(*(torch.from_numpy(x[k]) for k in ("d1", "d2", "v1", "v2")))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for a, b in zip(TH.top2_min(td), JM.top2_min(jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        TH.pixel_dist2_matrix(torch.from_numpy(x["uv1"]), torch.from_numpy(x["uv2"])).numpy(),
        np.asarray(JM.pixel_dist2_matrix(jnp.asarray(x["uv1"]), jnp.asarray(x["uv2"]))))


def _match_inputs(seed):
    """Queries with noisy, displaced copies among the train set, so every
    threshold, the dedup and the gates have work to do."""
    rng = np.random.default_rng(seed)
    k1, k2 = 256, 512
    d1 = rng.integers(0, 256, (k1, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (k2, 32), dtype=np.uint8)
    src = rng.permutation(k1)[:200]
    dst = rng.permutation(k2)[:200]
    flips = (rng.uniform(size=(200, 32, 8)) < rng.uniform(0.0, 0.3, (200, 1, 1)))
    d2[dst] = d1[src] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
    d2[dst[:20]] = d1[src[0]]  # a descriptor cluster: duplicate train winners
    uv1 = rng.uniform(0, 640, (k1, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 640, (k2, 2)).astype(np.float32)
    uv2[dst] = uv1[src] + rng.normal(0, 30, (200, 2)).astype(np.float32)
    alt = (uv1 + rng.normal(0, 40, (k1, 2))).astype(np.float32)
    v1 = rng.uniform(size=k1) > 0.05
    v2 = rng.uniform(size=k2) > 0.05
    return d1, d2, v1, v2, uv1, uv2, alt


@pytest.mark.parametrize("method,ambiguity,use_alt", [
    (1, 1.0, False), (2, 1.0, False), (3, 1.0, False), (3, 0.8, False),
    (3, 1.0, True), (1, 0.9, False)])
def test_match_features_matches_jax(method, ambiguity, use_alt):
    d1, d2, v1, v2, uv1, uv2, alt = _match_inputs(method * 10 + int(use_alt))
    kw = dict(method=method, max_pixel_dist=50.0, ambiguity_ratio=ambiguity)
    mj = JM.match_features(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                           jnp.asarray(v2), jnp.asarray(uv1), jnp.asarray(uv2),
                           kpts1_alt=jnp.asarray(alt) if use_alt else None, **kw)
    t = lambda a: torch.from_numpy(a)
    mt = TM.match_features(t(d1), t(d2), t(v1), t(v2), t(uv1), t(uv2),
                           kpts1_alt=t(alt) if use_alt else None, **kw)
    assert int(mt.n_valid) > 10
    for f in ("query_idx", "train_idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    np.testing.assert_allclose(
        float(TM.mean_pixel_displacement(t(uv1), t(uv2), mt)),
        float(JM.mean_pixel_displacement(jnp.asarray(uv1), jnp.asarray(uv2), mj)),
        rtol=1e-6)
