"""The CUDA matcher kernel against its plain PyTorch version, on the card.

Marked ``cuda``: here, without a card, every test skips. On a machine with
one (which has no JAX, so the JAX-importing ``conftest.py`` is left out):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The outputs are Hamming distances, 1e9 sentinels and indices, so the kernel
must equal the plain version exactly (``torch.equal``), the lowest-index
tie rule and the union radius gate included. ``CASES`` also feeds the
plain version against the JAX kernel in ``test_torch_matching.py``.
"""

import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu_torch.ops import matching as TM
from monocular_visual_odometry_tpu_torch.ops.cuda import hamming as TH


def _inputs(k1, k2, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    return dict(
        d1=rng.integers(0, 256, (k1, 32), dtype=np.uint8),
        d2=rng.integers(0, 256, (k2, 32), dtype=np.uint8),
        uv1=rng.uniform(0, 400, (k1, 2)).astype(np.float32),
        uv2=rng.uniform(0, 400, (k2, 2)).astype(np.float32),
        v1=rng.uniform(size=k1) >= invalid,
        v2=rng.uniform(size=k2) >= invalid,
        alt=None,
    )


def _union_case():
    """Train i carries query i's descriptor, reachable only from the alt position."""
    x = _inputs(128, 512, 5, invalid=0.0)
    x["d2"][:128] = x["d1"]
    x["uv2"] = np.random.default_rng(6).uniform(0, 640, (512, 2)).astype(np.float32)
    x["uv1"] = x["uv2"][:128] + 500.0
    x["alt"] = x["uv2"][:128].copy()
    return x


def _tie_case():
    """Each train descriptor appears four times: best == second, lowest index wins."""
    x = _inputs(128, 512, 7, invalid=0.0)
    x["d2"] = np.tile(x["d2"][:128], (4, 1))
    x["uv2"] = np.tile(x["uv2"][:128], (4, 1))
    return x


CASES = {
    "random": (lambda: _inputs(256, 512, 0), 120.0),
    "radius_zero": (lambda: _inputs(256, 512, 1), 0.0),
    "all_invalid": (lambda: {**_inputs(256, 512, 2), "v1": np.zeros(256, bool)}, 1e6),
    "multi_tile": (lambda: _inputs(128, 1024, 3), 1e6),
    "union_gate": (_union_case, 50.0),
    "forced_tie": (_tie_case, 1e6),
}


def _on_card(x):
    return {k: None if v is None else torch.from_numpy(np.array(v)).cuda() for k, v in x.items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_version(card, case):
    make, r = CASES[case]
    x = _on_card(make())
    args = (x["d1"], x["uv1"], x["v1"], x["d2"], x["uv2"], x["v2"], r)
    before = TH.hamming_nn_top2.launches
    got = TH.hamming_nn_top2(*args, uv1_alt=x["alt"])
    want = TH.hamming_nn_top2_reference(*args, uv1_alt=x["alt"])
    torch.cuda.synchronize()
    assert TH.hamming_nn_top2.launches == before + 1
    for g, w, what in zip(got, want, ("best", "second", "idx")):
        assert torch.equal(g, w), what


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 2, 3])
def test_match_features_on_card_equals_cpu(card, method):
    x = CASES["union_gate"][0]()
    keys = ("d1", "d2", "v1", "v2", "uv1", "uv2")
    cpu = [torch.from_numpy(np.array(x[k])) for k in keys]
    alt = torch.from_numpy(x["alt"]) if method == 3 else None
    want = TM.match_features(*cpu, method=method, kpts1_alt=alt)
    before = TH.hamming_nn_top2.launches
    got = TM.match_features(*(t.cuda() for t in cpu), method=method,
                            kpts1_alt=None if alt is None else alt.cuda())
    assert TH.hamming_nn_top2.launches == before + 1
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = _on_card(CASES["random"][0]())
    args = [x["d1"], x["uv1"], x["v1"], x["d2"], x["uv2"], x["v2"], 50.0]
    with pytest.raises(ValueError):
        TH.hamming_nn_top2(x["d1"][:, :16], *args[1:])
    with pytest.raises(TypeError):
        TH.hamming_nn_top2(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        TH.hamming_nn_top2(args[0], args[1].cpu(), *args[2:])
