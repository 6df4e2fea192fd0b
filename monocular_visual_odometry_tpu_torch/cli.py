"""Command-line VO runner.

The port's counterpart of ``monocular_visual_odometry_tpu.cli``, with its
flags and outputs: reads a config (the reference's own YAML layout is
accepted) or generates the synthetic benchmark, loops over frames calling
the engine on the card, and writes per-frame annotated images, the
trajectory in the reference's 12-number format, a trajectory plot (where
matplotlib is installed), an interactive viewer, state checkpoints and a
report with the ATE when ground truth is available.

Examples
--------
Run on the built-in synthetic benchmark (generates frames on first use)::

    python -m monocular_visual_odometry_tpu_torch.cli --synthetic --frames 60 \
        --output /tmp/vo_out

Run on a dataset directory in the reference's layout (rgb_%05d.png)::

    python -m monocular_visual_odometry_tpu_torch.cli --config config.yaml

It runs on ``cuda``; ``--cpu`` is the only way to the CPU. Without a card
and without ``--cpu`` it exits with code 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np


def _missing(*modules: str) -> list[str]:
    """The modules of ``modules`` that are not installed."""
    return [m for m in modules if importlib.util.find_spec(m) is None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1],
                                 prog="python -m monocular_visual_odometry_tpu_torch.cli")
    ap.add_argument("--config", help="YAML config (framework or reference layout)")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on the generated synthetic benchmark sequence")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--output", default="output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--viewer", action="store_true",
                    help="write viewer.html — standalone interactive 3-D "
                         "replay (orbit/zoom, arrow-key frame stepping, "
                         "space to play)")
    ap.add_argument("--animate", action="store_true",
                    help="also write trajectory.gif (incremental growing "
                         "trajectory + map cloud; needs matplotlib and Pillow)")
    ap.add_argument("--save-frames", action="store_true",
                    help="write annotated frames")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save VO state every N frames (0 = off)")
    ap.add_argument("--resume", help="resume from a state checkpoint (.npz)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from monocular_visual_odometry_tpu_torch.data import synthetic as syn
    from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
    from monocular_visual_odometry_tpu_torch.runtime import FrameLoader, png_size
    from monocular_visual_odometry_tpu_torch.utils import io as vio
    from monocular_visual_odometry_tpu_torch.utils import metrics
    from monocular_visual_odometry_tpu_torch.utils.checkpoint import load_state, save_state
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig, load_config
    from monocular_visual_odometry_tpu_torch.utils.logging import (StageTimer, format_step,
                                                                   torch_trace)
    from monocular_visual_odometry_tpu_torch.viz import draw, trajectory

    os.makedirs(args.output, exist_ok=True)

    # ---- dataset ----------------------------------------------------------
    gt = None
    if args.synthetic:
        cfg = VOConfig()
        seq_dir = os.path.join(args.output, "synthetic_seq")
        if not os.path.exists(os.path.join(seq_dir, f"rgb_{args.frames-1:05d}.png")):
            print(f"[cli] rendering {args.frames}-frame synthetic benchmark -> {seq_dir}")
            syn.render_sequence(seq_dir, n_frames=args.frames, seed=args.seed)
        paths = vio.image_paths(seq_dir, args.frames)
        gt = vio.read_trajectory(os.path.join(seq_dir, "cam_traj_truth.txt"))
    elif args.config:
        cfg = load_config(args.config)
        paths = vio.image_paths(cfg.dataset.dataset_dir,
                                min(cfg.dataset.num_images, cfg.max_num_imgs_to_proc))
        if cfg.dataset.is_draw_true_traj and cfg.dataset.true_traj_filename:
            gt = vio.read_trajectory(cfg.dataset.true_traj_filename)
    else:
        ap.error("provide --config or --synthetic")

    H, W = png_size(paths[0])

    try:
        engine = VOEngine(cfg, H, W, seed=args.seed, device="cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"[cli] {e}", file=sys.stderr)
        return 1
    if args.resume:
        engine.state = load_state(args.resume, engine.state)
        print(f"[cli] resumed from {args.resume} at frame {int(engine.state.frame_idx)}")

    # prefetching loader: zlib inflate + the C++ row unfilter, on worker threads
    print("[cli] frame loader: native C++")
    timer = StageTimer()
    est = []
    kf_frames = []
    # resume carries the historical rejection count — warn only on NEW ones
    ba_rejected_seen = int(engine.state.ba_rejected)
    t_start = time.perf_counter()
    with torch_trace(args.profile_dir), FrameLoader(paths, H, W) as loader:
        it = enumerate(loader)
        while True:
            try:  # stop on an unreadable frame, keeping the results so far
                i, img = next(it)
            except StopIteration:
                break
            except IOError as e:
                print(f"[cli] frame read failed: {e}; stopping")
                break
            with timer.time("vo_step"):
                out = engine.add_frame(img)
            est.append(out.T_w_c.numpy())
            if bool(out.is_keyframe):
                kf_frames.append(i)
            # tracking candidate-pool pressure must be visible, not silent
            n_cand = int(out.n_candidates)
            if cfg.map.track_candidates and n_cand > cfg.map.track_candidates:
                print(f"[cli] WARNING frame {i}: {n_cand} in-frustum "
                      f"candidates exceed track_candidates="
                      f"{cfg.map.track_candidates}; newest "
                      f"{n_cand - cfg.map.track_candidates} excluded from "
                      "matching this frame")
            # likewise the BA trust region (cfg.ba.max_pose_correction)
            n_rej = int(out.ba_rejected_total)
            if n_rej > ba_rejected_seen:
                print(f"[cli] WARNING frame {i}: BA window update rejected "
                      f"by the trust region (total {n_rej}) — correction "
                      f"exceeded ba.max_pose_correction="
                      f"{cfg.ba.max_pose_correction}")
                ba_rejected_seen = n_rej
            print(format_step(i, out))
            if args.save_frames:
                with timer.time("draw"):
                    # current frame's keypoints green, inlier matches red
                    draw.draw_frame(
                        img.astype(np.uint8), out.kpts.numpy(), out.kpt_valid.numpy(),
                        inlier_mask=out.kpt_inlier.numpy(),
                        out_path=os.path.join(args.output, f"frame_{i:05d}.png"))
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                with timer.time("checkpoint"):
                    save_state(os.path.join(args.output, f"state_{i:05d}.npz"),
                               engine.state)
    wall = time.perf_counter() - t_start

    # ---- outputs ----------------------------------------------------------
    est = np.stack(est) if est else np.zeros((0, 4, 4))
    traj_path = os.path.join(args.output, "cam_traj.txt")
    vio.write_trajectory(traj_path, est)
    print(f"[cli] trajectory ({len(est)} poses) -> {traj_path}")

    st = engine.state
    host = lambda t: t.detach().cpu().numpy()
    valid = host(st.map.valid)
    pts = host(st.map.pts)
    map_pts = pts[valid]
    map_gray = host(st.map.gray)[valid]
    # newly-triangulated points: created at the most recent keyframe event
    created = host(st.map.created_idx)
    last_created = created[valid].max() if valid.any() else -1
    new_pts = pts[valid & (created == last_created)]
    n_kf = min(int(st.kf_count), st.kf_poses.shape[0])
    keyframes = host(st.kf_poses)[:n_kf]
    gt_run = gt[: len(est)] if gt is not None else None
    if _missing("matplotlib"):
        print("[cli] plot skipped: matplotlib is not installed")
    else:
        plot = trajectory.plot_trajectory(
            est, gt_run, map_pts, keyframes=keyframes, new_pts=new_pts, map_gray=map_gray,
            out_path=os.path.join(args.output, "trajectory.png"),
            title=f"{len(est)} frames, {n_kf} keyframes, {len(map_pts)} map points")
        print(f"[cli] plot -> {plot}")
    if args.viewer and len(est) > 0:
        from monocular_visual_odometry_tpu_torch.viz.viewer import export_viewer

        html = export_viewer(
            est, gt_run, map_pts=map_pts, map_gray=map_gray,
            map_created_idx=created[valid],
            keyframe_indices=np.asarray(kf_frames, int),
            out_path=os.path.join(args.output, "viewer.html"),
            title=f"tpu-mono-vo — {len(est)} frames")
        print(f"[cli] interactive viewer -> {html}")
    if args.animate and len(est) > 2:
        missing = _missing("matplotlib", "PIL")
        if missing:
            verb = "is" if len(missing) == 1 else "are"
            print(f"[cli] animation skipped: {' and '.join(missing)} {verb} not installed")
        else:
            gif = trajectory.animate_trajectory(
                est, gt_run, map_pts=map_pts, map_created_idx=created[valid],
                out_path=os.path.join(args.output, "trajectory.gif"))
            print(f"[cli] animation -> {gif}")

    report = {
        "frames": len(est),
        "wall_s": round(wall, 3),
        "fps": round(len(est) / wall, 2) if wall > 0 else 0.0,
        "map_points": int(len(map_pts)),
        "keyframes": n_kf,
    }
    if gt is not None and len(est) == len(gt_run) and len(est) > 2:
        report["ate_sim3"] = metrics.ate_rmse(est, gt_run, "sim3")
        report["ate_scale"] = metrics.ate_rmse(est, gt_run, "scale")
        report["gt_traj_length"] = metrics.trajectory_length(gt_run)
        drift = metrics.drift_curve(est, gt_run)
        report["drift_final"] = float(drift[-1])
        report["drift_per_frame"] = [round(float(d), 4) for d in drift]
    with open(os.path.join(args.output, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[cli] report: {json.dumps(report)}")
    print(timer.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
