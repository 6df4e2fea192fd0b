"""The two-view pose on the card's factorization route (``lie.eigh_jacobi``,
``lie.svd3_jacobi``, forced onto CPU tensors through ``lie.card_route``)
against the CPU's (LAPACK), on the two-view A/B of
``profile_fivepoint_ab.py`` (``eval_protocol.fivepoint_ab``; phase 4j of
``chip_smoke.py`` runs it on the card at 12 seeds).

1. The float32 five-point solver picks the float64 solver's model: at
   outlier fraction 0.6, 12 seeds, the float32 route's rotation (read on the
   nearest rotation) is the float64 route's within 0.02 deg on at least 10
   seeds on either chart (LAPACK 10, the Jacobi 11). With its Gram matrices
   formed and factored in float32 (``fivepoint._gram_eigvecs`` before the
   repair) LAPACK's agreed on 9, the Jacobi's on 10; the roots themselves
   are ``test_torch_eigh.py::test_float32_solver_keeps_the_float64_roots``.
2. ``epipolar.decompose_homography`` on the card's 3x3 Jacobi SVD gives
   the float64 decomposition's four (R, t, n) candidates as closely as on
   LAPACK's (float32 rounding over the singular value gap), as a set: the
   two SVDs may pair the singular vectors with other signs, which permutes
   the candidates. Held on the A/B's homographies at outlier fraction 0
   (singular value gaps down to ~1e-3) and on ones with gaps down to 5e-5.
3. At outlier fraction 0 both charts pick the same rotation on every seed,
   read on the nearest rotation (within 0.01 deg); the protocol's own
   reading, the arccos of R^T R_gt's trace, also moves with a float32 R's
   ~1e-6 departure from the rotation group, a few hundredths of a degree
   near 0 either way, so its 12-seed medians differ between charts (and
   devices) where the rotations do not.
"""

import numpy as np
import pytest
import torch

from eval_protocol import AB_HYP, AB_SEEDS, fivepoint_ab
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.ops import epipolar as TE
from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops.ransac import split_key, uniforms

SEEDS = range(AB_SEEDS)
K = torch.tensor([[615.0, 0, 320], [0, 615, 240], [0, 0, 1]])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _route(monkeypatch, card):
    monkeypatch.setattr(lie, "card_route", lambda t: card)


@pytest.fixture(scope="module")
def float64_at_06():
    return fivepoint_ab("cpu", fracs=(0.6,), minimals=("5pt",), dtype=torch.float64)


@pytest.mark.parametrize("card", [False, True], ids=["lapack", "jacobi"])
def test_float32_solver_picks_the_float64_model(card, float64_at_06, monkeypatch):
    _route(monkeypatch, card)
    k = "outliers=0.6:5pt"
    got = fivepoint_ab("cpu", fracs=(0.6,), minimals=("5pt",))[k]["rot_orth_each"]
    want = float64_at_06[k]["rot_orth_each"]
    same = np.abs(np.subtract(got, want)) <= 0.02
    assert same.sum() >= 10, (np.round(got, 4), np.round(want, 4))


def _ab_homographies():
    """The H-RANSAC models of the A/B at outlier fraction 0, one per seed,
    with the draws ``fivepoint_ab`` gives them."""
    Hs = []
    for seed in SEEDS:
        sc = tsyn.synthesize_two_view(n=200, seed=seed, noise_px=0.5)
        n = len(sc.uv1)
        uv1, uv2 = (torch.tensor(uv, dtype=torch.float32) for uv in (sc.uv1, sc.uv2))
        hm = TE.estimate_homography(uv1, uv2, torch.ones(n, dtype=torch.bool), None,
                                    threshold_px=3.0, n_hypotheses=AB_HYP,
                                    u=uniforms(split_key(seed)[1], (AB_HYP, n), "cpu"))
        Hs.append(hm.model)
    return Hs


def _close_homographies():
    """Homographies of a plane seen across small baselines, whose normalized
    singular values part by ~1e-3 to 1e-4 (``decompose_homography`` calls
    them distinct from 1e-4)."""
    g = np.random.default_rng(0)
    Hs = []
    for _ in range(8):
        R = lie.so3_exp(torch.tensor(g.normal(0, 0.05, (1, 3))))[0]
        t = torch.tensor(g.normal(0, 1e-3, 3))
        nrm = torch.tensor(g.normal(0, 1, 3))
        nrm = nrm / nrm.norm() * torch.sign(nrm[2])
        Hs.append((K.double() @ (R + t[:, None] * nrm[None, :]) @ torch.linalg.inv(K.double()))
                  .float())
    return Hs


@pytest.mark.parametrize("which", ["ab", "close"])
def test_decompose_homography_card_route_gives_lapacks_candidates(which, monkeypatch):
    Hs = _ab_homographies() if which == "ab" else _close_homographies()
    gaps = []
    for H in Hs:
        Hn = torch.linalg.inv(K) @ H @ K
        s = torch.linalg.svdvals(Hn.double())
        gap = float(torch.min(s[:-1] / s[1:] - 1))
        gaps.append(gap)
        # the SVD alone: singular values and the product within rounding
        U, S, Vt = lie.svd3_jacobi(Hn)
        assert torch.allclose(S.double(), s, rtol=2e-6, atol=0)
        assert torch.allclose((U * S[None]) @ Vt, Hn, rtol=0, atol=2e-6)
        assert torch.allclose(U.T @ U, torch.eye(3), rtol=0, atol=2e-6)
        assert torch.allclose(Vt @ Vt.T, torch.eye(3), rtol=0, atol=2e-6)
        # the candidates of either route against the float64 decomposition of
        # the same H, as a set (one to one), within ~4 float32 roundings over
        # the singular value gap, the conditioning of the singular vectors
        _route(monkeypatch, False)
        want = torch.cat([v.flatten(1) for v in TE.decompose_homography(H.double(),
                                                                        K.double())[:3]], -1)
        for card in (False, True):
            _route(monkeypatch, card)
            Rs, ts, ns, ok = TE.decompose_homography(H, K)
            assert bool(ok.all()), s
            got = torch.cat([Rs.flatten(1), ts, ns], dim=-1).double()
            d = (got[:, None] - want[None]).abs().amax(-1)
            assert sorted(d.argmin(-1).tolist()) == [0, 1, 2, 3], (card, d)
            assert float(d.min(-1).values.max()) <= 2.5e-7 / gap, (card, gap, d)
    if which == "close":
        assert min(gaps) < 1e-4 and max(gaps) < 1e-3, gaps


@pytest.mark.parametrize("minimal", ["8pt", "5pt"])
def test_zero_outliers_same_rotation_on_both_charts(minimal, monkeypatch):
    k = f"outliers=0.0:{minimal}"
    run = {}
    for card in (False, True):
        _route(monkeypatch, card)
        run[card] = fivepoint_ab("cpu", fracs=(0.0,), minimals=(minimal,))[k]
    orth = np.abs(np.subtract(run[True]["rot_orth_each"], run[False]["rot_orth_each"]))
    assert orth.max() <= 0.01, orth
