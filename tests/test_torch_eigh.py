"""The card's symmetric eigensolver (``lie.eigh_jacobi``: cyclic two-sided
Jacobi in a tournament order, tensor ops only) and the five-point solver on
the card's route, both run here on the CPU.

``lie.eigh`` picks its route by ``lie.card_route``: Jacobi on a CUDA tensor,
LAPACK on the CPU. The tests that take the card's route on the CPU force
that choice with ``monkeypatch``.

Against ``torch.linalg.eigh`` and ``jnp.linalg.eigh`` (LAPACK), on 9x9 and
10x10 matrices in float32 and float64 (random symmetric, a rank-5 Gram
matrix with a 4- or 5-fold zero eigenvalue, a spectrum with a tight
cluster): eigenvalues within ``TOL[dtype]`` of the largest |eigenvalue|;
eigenvectors through the projector onto each cluster of eigenvalues
(those closer than ``GAP`` of the scale share one), whose difference is
bounded by TOL / gap; the basis of a repeated eigenvalue's space has no
canonical choice, so vectors are not compared one by one.

The five-point solver on the card's route (both ``eigh`` calls Jacobi) is
held to the JAX package in float64 as ``tests/test_torch_fivepoint.py``
holds the LAPACK route: its candidates as a set; and the RANSAC with JAX's
minimal sets and remix, on the samples where the two charts find the same
roots.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monocular_visual_odometry_tpu.ops import ransac as JR
from monocular_visual_odometry_tpu_torch.ops import epipolar as TE
from monocular_visual_odometry_tpu_torch.ops import fivepoint as TF
from monocular_visual_odometry_tpu_torch.ops import lie
from monocular_visual_odometry_tpu_torch.ops import ransac as TR
from test_torch_fivepoint import CASES, SAMPLES, _dist, _f64_draws, _jax_f64, _samples, _sets
from test_torch_geometry import _t, _two_view

DTYPES = {"f32": torch.float32, "f64": torch.float64}
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}   # eigenvalues, x the scale
GAP = 1e-3                                            # eigenvalues within this share a cluster


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the matrices are small, and beside other test
    workers a pool of threads per process only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrices(kind, n, dtype, batch=16, seed=0):
    g = np.random.default_rng(seed + n)
    if kind == "symmetric":
        X = g.normal(size=(batch, n, n))
        M = X + np.swapaxes(X, -1, -2)
    elif kind == "rank5_gram":
        A = g.normal(size=(batch, 5, n))
        M = np.swapaxes(A, -1, -2) @ A
    else:  # cluster: three eigenvalues within 1e-9 of each other, the rest spread
        Q, _ = np.linalg.qr(g.normal(size=(batch, n, n)))
        w = np.sort(g.normal(size=(batch, n)) * 3.0, axis=-1)
        w[:, 2:5] = w[:, 2:3] + 1e-9 * g.normal(size=(batch, 3))
        M = (Q * w[:, None, :]) @ np.swapaxes(Q, -1, -2)
        M = 0.5 * (M + np.swapaxes(M, -1, -2))
    return torch.from_numpy(M).to(dtype)


def _clusters(w, scale):
    """Index groups of sorted eigenvalues w [n] closer than GAP * scale."""
    groups = [[0]]
    for i in range(1, len(w)):
        if w[i] - w[i - 1] < GAP * scale:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def _assert_matches(w, V, w_ref, V_ref, M, dtype):
    """Eigenvalues within TOL of the scale, every cluster's projector within
    TOL / gap, V orthonormal and V diag(w) V' = M."""
    w, V, w_ref, V_ref, M = (np.asarray(a, np.float64) for a in (w, V, w_ref, V_ref, M))
    tol = TOL[dtype]
    scale = np.abs(w_ref).max(axis=-1)
    np.testing.assert_array_less(np.abs(w - w_ref).max(axis=-1), tol * 4 * scale)
    n = M.shape[-1]
    np.testing.assert_array_less(np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(n)).max(), 50 * tol)
    rec = (V * w[..., None, :]) @ np.swapaxes(V, -1, -2)
    np.testing.assert_array_less(np.abs(rec - M).max(axis=(-2, -1)), 50 * tol * scale)
    for b in range(M.shape[0]):
        groups = _clusters(w_ref[b], scale[b])
        for gi, idx in enumerate(groups):
            near = [w_ref[b, groups[j][k]] for j in (gi - 1, gi + 1) if 0 <= j < len(groups)
                    for k in (0, -1)]
            gap = min((abs(x - w_ref[b, i]) for x in near for i in idx), default=scale[b])
            P = V[b][:, idx] @ V[b][:, idx].T
            P_ref = V_ref[b][:, idx] @ V_ref[b][:, idx].T
            assert np.abs(P - P_ref).max() <= 50 * tol * scale[b] / gap + 50 * tol, (b, idx)


@pytest.mark.parametrize("kind", ["symmetric", "rank5_gram", "cluster"])
@pytest.mark.parametrize("n", [9, 10])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_jacobi_matches_lapack(kind, n, dt):
    """Against ``torch.linalg.eigh`` and ``jnp.linalg.eigh`` on the same
    matrices (float64 under ``jax.enable_x64``)."""
    dtype = DTYPES[dt]
    M = _matrices(kind, n, dtype)
    w, V = lie.eigh_jacobi(M)
    assert w.dtype == dtype and V.shape == M.shape
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    w_t, V_t = torch.linalg.eigh(M)
    _assert_matches(w, V, w_t, V_t, M, dtype)
    with jax.enable_x64(dtype == torch.float64):
        w_j, V_j = jnp.linalg.eigh(jnp.asarray(M.numpy()))
        w_j, V_j = np.asarray(w_j), np.asarray(V_j)
    _assert_matches(w, V, w_j, V_j, M, dtype)


def test_odd_size_padding_slot_takes_no_rotation():
    """n = 9 is factored in 10 slots: the padding slot never mixes in (the
    9x9 result is exact to rounding) and a 1x1 and a 3x3 work too."""
    for n in (1, 3, 9):
        M = _matrices("symmetric", n, torch.float64, batch=8)
        w, V = lie.eigh_jacobi(M)
        _assert_matches(w, V, *torch.linalg.eigh(M), M, torch.float64)


def test_vmap_equals_the_batch():
    """Under ``torch.func.vmap`` (the general batched step's body) with
    vmap's slow fallback off: every op has a batch rule, and the result is
    the batched call's."""
    M = _matrices("rank5_gram", 10, torch.float32, batch=12).reshape(3, 4, 10, 10)
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        w, V = torch.func.vmap(lie.eigh_jacobi)(M)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)
    w0, V0 = lie.eigh_jacobi(M)
    assert torch.equal(w, w0) and torch.equal(V, V0)


def test_non_finite_input_gives_nan(monkeypatch):
    """``lie.eigh`` on the card's route: a matrix with a NaN or an inf gives
    NaN factors, the others of the batch are untouched."""
    monkeypatch.setattr(lie, "card_route", lambda t: True)
    M = _matrices("symmetric", 9, torch.float32, batch=4)
    M[1, 2, 3] = float("nan")
    M[2, 0, 0] = float("inf")
    w, V = lie.eigh(M)
    for b in (1, 2):
        assert torch.isnan(w[b]).all() and torch.isnan(V[b]).all()
    for b in (0, 3):
        w_ref, V_ref = lie.eigh_jacobi(M[b:b + 1])
        assert torch.equal(w[b], w_ref[0]) and torch.equal(V[b], V_ref[0])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.__name__] += 1
        return func(*args, **(kwargs or {}))


FORBIDDEN = ("_local_scalar_dense.default", "nonzero.default", "_linalg_eigh.default",
             "lift_fresh.default")


def test_card_route_reads_nothing_back(monkeypatch):
    """``lie.eigh`` and the five-point solver on the card's route dispatch no
    readback (``_local_scalar_dense``, ``nonzero``), no tensor built from
    host data and no LAPACK ``eigh``; the CPU route does call LAPACK's."""
    M = _matrices("rank5_gram", 9, torch.float32, batch=8)
    x1, x2, key, _ = _samples("constraints")
    G = torch.from_numpy(np.array(jax.random.normal(key, (x1.shape[0], 4, 4))))
    with _Ops() as cpu:
        lie.eigh(M)
    assert cpu.ops["_linalg_eigh.default"] == 1
    monkeypatch.setattr(lie, "card_route", lambda t: True)
    x1, x2 = torch.from_numpy(x1), torch.from_numpy(x2)
    calls = (lambda: lie.eigh(M), lambda: TF.five_point_essential(x1, x2, G=G))
    for fn in calls:   # the cached constants made outside the mode
        fn()
    with _Ops() as mode:
        for fn in calls:
            fn()
    found = {k: mode.ops[k] for k in FORBIDDEN}
    assert sum(found.values()) == 0, found
    assert mode.ops["index_copy.default"] > 0


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_five_point_card_route_sets_match_jax(name, monkeypatch):
    """float64, the card's route (Jacobi bases) against JAX's candidates
    (LAPACK bases) with the same remix G: every candidate either has a
    counterpart within 1e-6 on the other side or is a root the other chart
    missed; misses stay under a tenth (``test_torch_fivepoint.py``'s rule)."""
    x1, x2, key, _ = _samples(name)
    Ej, okj, _, G = _jax_f64(x1, x2, key)
    monkeypatch.setattr(lie, "card_route", lambda t: True)
    Et, okt = (a.numpy() for a in TF.five_point_essential(
        torch.from_numpy(x1.astype(np.float64)), torch.from_numpy(x2.astype(np.float64)),
        G=torch.from_numpy(G)))
    assert okt.any(axis=1).all()
    for a, b in ((_sets(Ej, okj), _sets(Et, okt)), (_sets(Et, okt), _sets(Ej, okj))):
        d = np.asarray([_dist(E, other) for mine, other in zip(a, b) for E in mine])
        assert (d < 1e-6).mean() >= 0.9, np.sort(d)[-10:]


def _route(monkeypatch, card):
    monkeypatch.setattr(lie, "card_route", (lambda t: True) if card else (lambda t: t.is_cuda))


@pytest.mark.parametrize("seed,outliers", CASES)
def test_estimate_essential_5pt_card_route_same_samples(seed, outliers, monkeypatch):
    """float64, JAX's minimal sets ``idx`` and remix ``G``. The card's basis
    is another chart of each sample's solution set, so a root one chart
    misses the other may find (a few percent of the roots, either way) and
    the RANSAC's best can differ where that root would win. So: the samples
    whose candidate sets agree between the card's route and LAPACK's (the
    route ``test_torch_fivepoint.py`` holds to JAX with the same idx and G)
    are at least half of them, and on those samples the two RANSACs agree:
    equal inlier masks and E (up to sign) within 1e-6 of |E|."""
    uv1, uv2, valid, _ = _two_view(seed, outliers=outliers)
    x1 = _t((uv1.astype(np.float64) - [320.0, 240.0]) / 615.0)
    x2 = _t((uv2.astype(np.float64) - [320.0, 240.0]) / 615.0)
    key, n_hyp, th = jax.random.PRNGKey(seed), 128, 1.0 / 615.0
    idx, G = _f64_draws(valid, key, n_hyp)
    sets = {}
    for card in (False, True):
        _route(monkeypatch, card)
        Es, ok = TF.five_point_essential(x1[idx], x2[idx], G=G)
        sets[card] = _sets(Es.numpy(), ok.numpy())
    agree = np.array([all(_dist(E, b) < 1e-6 for E in a) and all(_dist(E, a) < 1e-6 for E in b)
                      for a, b in zip(sets[False], sets[True])])
    # each chart misses ~5% of the roots; at ~4 roots a sample and two
    # charts about a third of the samples differ: at least half agree
    assert agree.mean() >= 0.5, agree.mean()
    models = {}
    for card in (False, True):
        _route(monkeypatch, card)
        models[card] = TE.estimate_essential(x1, x2, _t(valid), 0, threshold=th,
                                             n_hypotheses=n_hyp, minimal="5pt",
                                             idx=idx[agree], G=G[agree])
    want, got = models[False], models[True]
    np.testing.assert_array_equal(got.inliers.numpy(), want.inliers.numpy())
    Ew, Eg = want.model.numpy(), got.model.numpy()
    Eg = Eg * np.sign(np.sum(Ew * Eg))
    np.testing.assert_allclose(Eg / np.linalg.norm(Ew), Ew / np.linalg.norm(Ew), atol=1e-6, rtol=0)
    assert int(want.inliers.sum()) > 50


def test_nullspace_via_eigh_card_route_matches_jax(monkeypatch):
    """``ransac.nullspace_via_eigh`` (off the main path) on the card's route
    against JAX's, float32, up to sign."""
    A = np.random.default_rng(2).normal(size=(16, 8, 9)).astype(np.float32)
    vj = np.asarray(JR.nullspace_via_eigh(jnp.asarray(A)))
    monkeypatch.setattr(lie, "card_route", lambda t: True)
    vt = TR.nullspace_via_eigh(_t(A)).numpy()
    sign = np.sign(np.sum(vj * vt, axis=-1, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=1e-4, rtol=0)


@pytest.mark.parametrize("card", [False, True], ids=["lapack", "jacobi"])
def test_float32_solver_keeps_the_float64_roots(card, monkeypatch):
    """The five-point solver on float32 samples, on either chart, finds at
    least 95% of the roots LAPACK's float64 solver finds (within 1e-2, up
    to sign) on 640 minimal samples of 10 noisy two-view scenes (0.5 px):
    its Gram matrices are formed and factored in float64. Formed and
    factored in float32 they kept 83.6% (LAPACK) and 94.7% (the Jacobi),
    and the two charts then picked other RANSAC winners in the two-view
    A/B of ``chip_smoke.py`` (phase 4j). The float64 solver on the other
    chart keeps ~96%: each chart misses a few percent of the roots."""
    from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
    from monocular_visual_odometry_tpu_torch.ops.camera import Camera, pixel2cam_norm_plane

    cam = Camera.create(615.0, 615.0, 320.0, 240.0)
    g = np.random.default_rng(0)
    x1, x2 = [], []
    for s in range(10):
        sc = tsyn.synthesize_two_view(n=200, seed=s, noise_px=0.5)
        p1, p2 = (pixel2cam_norm_plane(torch.tensor(uv, dtype=torch.float64), cam)
                  for uv in (sc.uv1, sc.uv2))
        for _ in range(64):
            i = torch.from_numpy(g.choice(len(sc.uv1), 5, replace=False))
            x1.append(p1[i])
            x2.append(p2[i])
    x1, x2 = torch.stack(x1), torch.stack(x2)
    G = TF.remix_draw(1, x1.shape[0], "cpu", torch.float64)
    E_ref, ok_ref = TF.five_point_essential(x1, x2, G=G)
    _route(monkeypatch, card)
    Es, ok = TF.five_point_essential(x1.float(), x2.float(), G=G.float())
    a, b = E_ref[:, :, None].flatten(-2), Es.double()[:, None].flatten(-2)
    d = torch.minimum((a - b).norm(dim=-1), (a + b).norm(dim=-1))
    d = torch.where(ok[:, None, :], d, torch.full_like(d, 9.0)).min(-1).values[ok_ref]
    assert ok_ref.sum() > 2000
    assert float((d <= 1e-2).double().mean()) >= 0.95, float((d <= 1e-2).double().mean())
