"""Port parity: the five-point minimal solver and the ``minimal="5pt"``
RANSAC path of the PyTorch package against the JAX package (CPU).

The solver takes the null space of a rank-5 [9,9] Gram matrix from
``eigh``. That eigenspace is 4-fold degenerate, so LAPACK builds return
different bases of it, and each basis is a different chart of the same
solution set: a root one chart brackets on its tan-grid another can miss
(two roots in one grid cell, or |z| > 100). In float32 the grid signs near
a root are set by the rounding of a 10x10 LU, so the two packages' float32
candidates are no more comparable one by one than JAX's own float32
candidates are with its float64 ones.

So the parity is held where it is exact, in float64 (``jax.enable_x64``):
given the same remixed basis the candidates agree slot for slot; with each
package's own basis the sets agree up to roots one chart misses; and with
the JAX-drawn samples ``idx`` and remix ``G`` the RANSAC results agree. The
port's float32 candidates are held to the bounds of ``tests/test_fivepoint.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu.ops import epipolar as JE
from monocular_visual_odometry_tpu.ops import ransac as JR
from monocular_visual_odometry_tpu.ops import twoview as JT
from monocular_visual_odometry_tpu.ops.fivepoint import five_point_essential as j_five_point
from monocular_visual_odometry_tpu_torch.ops import epipolar as TE
from monocular_visual_odometry_tpu_torch.ops import fivepoint as TF
from monocular_visual_odometry_tpu_torch.ops import twoview as TT
from test_fivepoint import _gt_essential, _norm_plane
from test_torch_geometry import JCAM, TCAM, _t, _two_view

# the minimal samples of tests/test_fivepoint.py: (points, scene seed,
# samples, index seed, PRNG key)
SAMPLES = {"exact_recovery": (64, 0, 32, 0, 1), "constraints": (32, 3, 8, 1, 2)}


def _samples(name):
    n, seed, nb, idx_seed, key = SAMPLES[name]
    sc = jsyn.synthesize_two_view(n=n, seed=seed)
    x1 = _norm_plane(sc.uv1, sc.K).astype(np.float32)
    x2 = _norm_plane(sc.uv2, sc.K).astype(np.float32)
    rng = np.random.default_rng(idx_seed)
    idx = np.stack([rng.choice(n, 5, replace=False) for _ in range(nb)])
    return x1[idx].copy(), x2[idx].copy(), jax.random.PRNGKey(key), sc


def _dist(E, others):
    """Frobenius distance up to sign from E to the nearest of ``others``."""
    return min((min(np.linalg.norm(E - F), np.linalg.norm(E + F)) for F in others),
               default=np.inf)


def _sets(Es, ok):
    return [[Es[b, r] for r in range(Es.shape[1]) if ok[b, r]] for b in range(Es.shape[0])]


def _jax_f64(x1, x2, key):
    """JAX candidates in float64, and the remixed basis they were solved in."""
    with jax.enable_x64(True):
        X1, X2 = jnp.asarray(x1, jnp.float64), jnp.asarray(x2, jnp.float64)
        Es, ok = j_five_point(X1, X2, key)
        u1, v1, u2, v2 = X1[..., 0], X1[..., 1], X2[..., 0], X2[..., 1]
        A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                       jnp.ones_like(u1)], axis=-1)
        basis = jnp.linalg.eigh(jnp.einsum("bmi,bmj->bij", A, A))[1][..., :4]
        G = jax.random.normal(key, (x1.shape[0], 4, 4), dtype=jnp.float64)
        basis = basis @ jnp.linalg.qr(G)[0]
        return np.asarray(Es), np.asarray(ok), np.asarray(basis), np.asarray(G)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_candidates_equal_jax_in_the_same_basis(name):
    """float64, JAX's remixed basis handed to the port: the same roots are
    bracketed, so ``ok`` and every candidate agree slot for slot."""
    x1, x2, key, _ = _samples(name)
    Ej, okj, basis, _ = _jax_f64(x1, x2, key)
    Et, okt = (a.numpy() for a in TF._candidates(torch.from_numpy(basis.copy())))
    np.testing.assert_array_equal(okt, okj)
    assert okj.any(axis=1).all()
    np.testing.assert_allclose(np.where(okj[..., None, None], Et, 0.0),
                               np.where(okj[..., None, None], Ej, 0.0), atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_candidate_sets_match_jax_in_own_basis(name):
    """float64, each package's own eigh basis, the same remix G: every
    candidate either has a counterpart within 1e-6 on the other side or is
    a root the other chart missed; misses stay under a tenth."""
    x1, x2, key, _ = _samples(name)
    Ej, okj, _, G = _jax_f64(x1, x2, key)
    Et, okt = (a.numpy() for a in TF.five_point_essential(
        torch.from_numpy(x1.astype(np.float64)), torch.from_numpy(x2.astype(np.float64)),
        G=torch.from_numpy(G)))
    for a, b in ((_sets(Ej, okj), _sets(Et, okt)), (_sets(Et, okt), _sets(Ej, okj))):
        d = np.asarray([_dist(E, other) for mine, other in zip(a, b) for E in mine])
        assert (d < 1e-6).mean() >= 0.9, np.sort(d)[-10:]


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_float32_candidates_meet_the_jax_bounds(name):
    """float32, the port's own basis and JAX's G: each candidate is on the
    essential manifold (rank 2, equal leading singular values); each
    sample's best root annihilates its correspondences; the bulk of the
    roots do; and the ground-truth E is recovered (tests/test_fivepoint.py)."""
    x1, x2, key, sc = _samples(name)
    G = np.asarray(jax.random.normal(key, (x1.shape[0], 4, 4), dtype=jnp.float32))
    Es, ok = (a.numpy() for a in TF.five_point_essential(
        torch.from_numpy(x1), torch.from_numpy(x2), G=torch.from_numpy(G)))
    assert ok.any(axis=1).all(), "every sample must yield >=1 real root"
    h = lambda p: np.concatenate([p, np.ones_like(p[..., :1])], -1)
    E_gt, _ = _gt_essential(sc)
    all_res, best_gt = [], []
    for b, cands in enumerate(_sets(Es, ok)):
        res = []
        for E in cands:
            s = np.linalg.svd(E, compute_uv=False)
            assert s[2] < 1e-4 * s[0] + 1e-6
            assert abs(s[0] - s[1]) < 0.05 * s[0]
            res.append(np.abs(np.einsum("ni,ij,nj->n", h(x2[b]), E, h(x1[b]))).max())
        assert min(res) < 1e-4, res
        all_res += res
        best_gt.append(_dist(E_gt, [E / np.linalg.norm(E) for E in cands]))
    assert (np.asarray(all_res) < 1e-2).mean() > 0.8
    assert np.median(best_gt) < 1e-3, np.median(best_gt)


_j_estimate_essential = jax.jit(JE.estimate_essential,
                                static_argnames=("threshold", "n_hypotheses", "minimal"))
_j_relative_pose = jax.jit(JT.estimate_relative_pose,
                           static_argnames=("n_hypotheses", "essential_minimal"))


def _f64_draws(valid, key, n_hyp):
    """JAX's 5pt draws under ``key``: the sample indices and the remix G."""
    with jax.enable_x64(True):
        k_s, k_b = jax.random.split(key)
        n_samples = max(n_hyp // 4, 8)
        idx = np.asarray(JR.sample_minimal_sets(k_s, jnp.asarray(valid), n_samples, 5))
        G = np.asarray(jax.random.normal(k_b, (n_samples, 4, 4), dtype=jnp.float64))
    return _t(idx).long(), _t(G)


CASES = [(seed, outliers) for seed in (0, 3) for outliers in (0.1, 0.4)]


@pytest.mark.parametrize("seed,outliers", CASES)
def test_estimate_essential_5pt_same_samples(seed, outliers):
    """float64, JAX's idx and G handed to the port: equal inlier masks and E
    (up to sign) within 1e-6 of |E|."""
    uv1, uv2, valid, _ = _two_view(seed, outliers=outliers)
    x1 = (uv1.astype(np.float64) - [320.0, 240.0]) / 615.0
    x2 = (uv2.astype(np.float64) - [320.0, 240.0]) / 615.0
    key, n_hyp, th = jax.random.PRNGKey(seed), 128, 1.0 / 615.0
    idx, G = _f64_draws(valid, key, n_hyp)
    with jax.enable_x64(True):
        mj = _j_estimate_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key,
                                   threshold=th, n_hypotheses=n_hyp, minimal="5pt")
        Ej, inl_j = np.asarray(mj.model), np.asarray(mj.inliers)
    mt = TE.estimate_essential(_t(x1), _t(x2), _t(valid), 0, threshold=th,
                               n_hypotheses=n_hyp, minimal="5pt", idx=idx, G=G)
    np.testing.assert_array_equal(mt.inliers.numpy(), inl_j)
    Et = mt.model.numpy() * np.sign(np.sum(Ej * mt.model.numpy()))
    np.testing.assert_allclose(Et / np.linalg.norm(Ej), Ej / np.linalg.norm(Ej), atol=1e-6, rtol=0)
    assert inl_j.sum() > 50


@pytest.mark.parametrize("seed,outliers", CASES)
def test_estimate_relative_pose_5pt_same_samples(seed, outliers):
    """float64, JAX's E, H and 5pt draws handed to the port: the same model
    wins, with equal inlier masks and R, t within 1e-6."""
    uv1, uv2, valid, _ = _two_view(seed, outliers=outliers)
    uv1, uv2 = uv1.astype(np.float64), uv2.astype(np.float64)
    key, n_hyp = jax.random.PRNGKey(seed), 128
    with jax.enable_x64(True):
        k_e, k_h = jax.random.split(key)
        idx_h = np.asarray(JR.sample_minimal_sets(k_h, jnp.asarray(valid), n_hyp, 4))
        rj = _j_relative_pose(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                              JCAM, key, n_hypotheses=n_hyp, essential_minimal="5pt")
        rj = jax.device_get(rj)
    idx_e, G_e = _f64_draws(valid, k_e, n_hyp)
    rt = TT.estimate_relative_pose(_t(uv1), _t(uv2), _t(valid), TCAM, seed, n_hypotheses=n_hyp,
                                   essential_minimal="5pt", idx_e=idx_e,
                                   idx_h=_t(idx_h).long(), G_e=G_e)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-6, rtol=0)
