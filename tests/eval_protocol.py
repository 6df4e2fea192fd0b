"""The JAX package's evaluation protocol on the port, shared by
``tests/test_torch_profiles.py`` and phase 4j of ``chip_smoke.py``.

- :func:`eval_configs`: the configurations of ``profile_robustness_r5.py``
  (the four tracking profiles and the five-point row) and of
  ``profile_ba_ablation.py`` (BA on, off, the 3 px re-gate) as the port's
  ``VOConfig``s.
- :func:`fivepoint_ab`: ``profile_fivepoint_ab.py``'s two-view A/B on the
  port's ``twoview.estimate_relative_pose``, and :func:`ab_gate`, the gate
  that holds the card's (Jacobi) chart to LAPACK's.

Imports torch, numpy and the port only (the card's machine has no JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AB_FRACS = (0.0, 0.2, 0.4, 0.6)
AB_SEEDS = 12
AB_HYP = 256
# the five-point A/B gate, the card's (Jacobi) chart against LAPACK's, 5pt at
# every outlier fraction: median rotation error <= x * LAPACK's + deg, median
# translation-direction error <= x * LAPACK's + deg, failures <= LAPACK's + n
AB_GATE = dict(ratio=1.25, rot_deg=0.05, t_deg=0.5, fails=1)


def eval_configs(cfg):
    """The JAX package's evaluation configurations as the port's VOConfigs:
    the four tracking profiles of profile_robustness_r5.py (``default`` is
    ``cfg``), its five-point end-to-end row, and the BA variants of
    profile_ba_ablation.py (``ba_on`` is ``cfg``)."""
    def variant(mm=True, union=True, amb=1.0, minimal="8pt"):
        return cfg.replace(
            tracking=dataclasses.replace(cfg.tracking, use_motion_model=mm,
                                         motion_gate_union=union),
            match=dataclasses.replace(cfg.match, method3_ambiguity_ratio=amb),
            ransac=dataclasses.replace(cfg.ransac, essential_minimal=minimal))
    return {
        # the reference's behaviour: stale-pose projection, no ambiguity gate
        "reference_parity": variant(mm=False, union=False),
        # the prediction-only gate
        "predict_only": variant(union=False),
        "default": cfg,
        # the ambiguity gate on the matcher's second-best distance
        "robust": variant(amb=0.8),
        "default_5pt": variant(minimal="5pt"),
        "ba_off": cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=False)),
        # the chi2 re-gate between LM rounds, measured and not made the default
        "ba_on_regate3": cfg.replace(ba=dataclasses.replace(cfg.ba, regate_px=3.0)),
    }


def rotation_error_deg(R: np.ndarray, R_gt: np.ndarray, orthonormalize: bool = False) -> float:
    """The angle of R^T R_gt in degrees, from its trace as
    profile_fivepoint_ab.py reads it. A float32 R leaves the rotation group
    by ~1e-6, and near an angle of 0 the trace reads that as a few hundredths
    of a degree either way; ``orthonormalize`` reads the nearest rotation
    (the polar factor, in float64) instead."""
    R = np.asarray(R, dtype=np.float64)
    if orthonormalize:
        U, _, Vt = np.linalg.svd(R)
        R = U @ Vt
    c = (np.trace(R.T @ R_gt) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def fivepoint_ab(device, seeds=range(AB_SEEDS), fracs=AB_FRACS, minimals=("8pt", "5pt"),
                 dtype=torch.float32):
    """profile_fivepoint_ab.py's two-view A/B on the port's
    ``twoview.estimate_relative_pose`` on ``device``: per outlier fraction
    and minimal solver, ``synthesize_two_view(n=200, seed, noise_px=0.5,
    outlier_frac)``, AB_HYP hypotheses, 1 px; each seed's draws made on the
    host from the key ``seed`` as ``estimate_relative_pose(key=seed)`` makes
    them on the CPU (the same on every route, so routes differ only in their
    arithmetic). Rotation error and sign-free translation-direction error in
    degrees; a failure is > 5 deg or > 10 deg. Returns
    {"outliers=<frac>:<minimal>": FIVEPOINT_AB_r04.json's fields, with the
    per-seed errors (``rot_each``, ``t_dir_each``) and the per-seed rotation
    error of the nearest rotation (``rot_orth_each``, its median
    ``rot_orth_deg_med``)}."""
    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.ops import fivepoint, twoview
    from monocular_visual_odometry_tpu_torch.ops.camera import Camera
    from monocular_visual_odometry_tpu_torch.ops.ransac import split_key, uniforms

    cam = Camera.create(615.0, 615.0, 320.0, 240.0)
    on = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype).to(device)
    out = {}
    for frac in fracs:
        for minimal in minimals:
            rot, rot_orth, tdir = [], [], []
            for seed in seeds:
                sc = syn.synthesize_two_view(n=200, seed=seed, noise_px=0.5, outlier_frac=frac)
                n = len(sc.uv1)
                k_e, k_h = split_key(seed)
                if minimal == "5pt":
                    n_s = max(AB_HYP // 4, 8)
                    k_s, k_b = split_key(k_e)
                    u_e, G = uniforms(k_s, (n_s, n), "cpu"), fivepoint.remix_draw(k_b, n_s, "cpu")
                else:
                    u_e, G = uniforms(k_e, (AB_HYP, n), "cpu"), None
                tv = twoview.estimate_relative_pose(
                    on(sc.uv1), on(sc.uv2), torch.ones(n, dtype=torch.bool, device=device), cam,
                    None, threshold_px=1.0, n_hypotheses=AB_HYP, essential_minimal=minimal,
                    u_e=on(u_e), u_h=on(uniforms(k_h, (AB_HYP, n), "cpu")), G_e=on(G))
                # the estimate is frame 2 from frame 1: x2 = R x1 + t
                T_gt = np.linalg.inv(sc.T_c1_c2)
                R, t = tv.R.double().cpu().numpy(), tv.t.double().cpu().numpy()
                rot.append(rotation_error_deg(R, T_gt[:3, :3]))
                rot_orth.append(rotation_error_deg(R, T_gt[:3, :3], orthonormalize=True))
                t, t_gt = (v / (np.linalg.norm(v) + 1e-12) for v in (t, T_gt[:3, 3]))
                tdir.append(float(np.degrees(np.arccos(np.clip(abs(float(t @ t_gt)), 0, 1)))))
            out[f"outliers={frac}:{minimal}"] = dict(
                rot_err_deg_med=float(np.median(rot)),
                rot_err_deg_p90=float(np.percentile(rot, 90)),
                t_dir_err_deg_med=float(np.median(tdir)),
                t_dir_err_deg_p90=float(np.percentile(tdir, 90)),
                fail_count=sum(r > 5.0 or t_ > 10.0 for r, t_ in zip(rot, tdir)),
                seeds=len(rot), rot_each=rot, t_dir_each=tdir,
                rot_orth_deg_med=float(np.median(rot_orth)), rot_orth_each=rot_orth)
    return out


def ab_gate(jacobi, lapack, fracs=AB_FRACS):
    """The rows where the card's (Jacobi) chart misses AB_GATE against
    LAPACK's, five-point, at every outlier fraction (empty: it holds)."""
    g, misses = AB_GATE, []
    for frac in fracs:
        k = f"outliers={frac}:5pt"
        j, l_ = jacobi[k], lapack[k]
        if not (j["rot_err_deg_med"] <= g["ratio"] * l_["rot_err_deg_med"] + g["rot_deg"]
                and j["t_dir_err_deg_med"] <= g["ratio"] * l_["t_dir_err_deg_med"] + g["t_deg"]
                and j["fail_count"] <= l_["fail_count"] + g["fails"]):
            misses.append(k)
    return misses
