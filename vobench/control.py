"""The readings the limits of ``correct`` are set from: the program's, its
lower-precision control's and its planted faults'.

    python3 vobench/control.py --workload <cell> --seconds <s> --fault <name> --seeds <n> ...

Each seed is one run of the cell through ``run.measure`` (the benchmark's
own set-up, window, gather and judge; a window of ``--seconds``, without the
steady warm-up, which only steadies the timing), in one process whose
captured programs serve every seed. Faults, planted before the first
capture so that the captured programs hold them:

- ``none``: the program as it is: the lower readings;
- ``tf32``: the control, the program's own lower-precision path: TF32
  matrix products switched on (the configuration states float32 with TF32
  off);
- ``ba_skip``: BA skipped (``ba_update_state`` returns its state);
- ``hypotheses``: RANSAC with 16 hypotheses where the configuration states
  its own number (PnP, the two-view init, the keyframe filter);
- ``init``: the two-view init's rotation turned by 0.05 degrees where it is
  estimated;
- ``keypoints``: keypoints moved by one pixel where the frontend makes them;
- ``match``: the tracking match (the union-gated one) pairs each map point
  with its second-nearest keypoint in the gate, not its nearest.

One JSON line per seed (every number compared, ``correct``, the numbers
that failed), then one with each number's largest and smallest reading.
Needs a CUDA device; the benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402

FAULTS = ("none", "tf32", "ba_skip", "hypotheses", "init", "keypoints", "match")


def plant(fault: str, cell):
    """``cell`` with ``fault`` planted (the program patched in place)."""
    import torch

    from monocular_visual_odometry_tpu_torch.models import ba
    from monocular_visual_odometry_tpu_torch.ops import twoview

    if fault == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif fault == "ba_skip":
        def unchanged(cfg, cam, st):
            return st

        unchanged.calls = 0
        ba.ba_update_state = unchanged
    elif fault == "hypotheses":
        cell = cell._replace(config=copy.deepcopy(cell.config))
        r = cell.config["vo_config"]["ransac"]
        r["n_hypotheses"] = r["pnp_n_hypotheses"] = 16
    elif fault == "init":
        import math

        estimate = twoview.estimate_relative_pose
        c, s = math.cos(math.radians(0.05)), math.sin(math.radians(0.05))

        def turned(*args, **kw):
            tv = estimate(*args, **kw)
            turn = torch.eye(3, device=tv.R.device)    # filled in place: captured
            for (i, j), v in (((0, 0), c), ((1, 1), c), ((0, 1), -s), ((1, 0), s)):
                turn[i, j].fill_(v)
            return tv._replace(R=turn @ tv.R)

        twoview.estimate_relative_pose = turned
    elif fault == "keypoints":
        from monocular_visual_odometry_tpu_torch.models import vo

        made = vo.features_from_config

        def moved(img, cfg):
            f = made(img, cfg)
            kpts = f.kpts.clone()
            kpts[:, 0] += 1.0
            return f._replace(kpts=kpts)

        vo.features_from_config = moved
    elif fault == "match":
        from monocular_visual_odometry_tpu_torch.ops import matching
        from monocular_visual_odometry_tpu_torch.ops.cuda import hamming

        nearest = matching.hamming_nn_top2

        def second(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt=None):
            if uv1_alt is None:
                return nearest(desc1, uv1, valid1, desc2, uv2, valid2, r, uv1_alt=uv1_alt)
            d = hamming.hamming_matrix(desc1, desc2, valid1, valid2)
            p2 = torch.minimum(hamming.pixel_dist2_matrix(uv1, uv2),
                               hamming.pixel_dist2_matrix(uv1_alt, uv2))
            d = torch.where(p2 <= r * r, d, torch.full_like(d, 1e9))
            first = torch.argmin(d, dim=-1)
            cols = torch.arange(d.shape[-1], device=d.device)
            d = torch.where(cols == first[:, None], torch.full_like(d, 1e9), d)
            best, idx = torch.min(d, dim=-1)
            return best, best, idx.to(torch.int32)

        matching.hamming_nn_top2 = second
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=FAULTS, default="none")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bench", default=str(run.BENCH), help="the benchmark's folder")
    args = ap.parse_args(argv)
    run._environment(run.ROOT)
    sys.path[:0] = [str(run.ROOT), str(run.BENCH)]
    import torch

    from harness import spec

    torch.set_num_threads(run.THREADS)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.Path(args.bench)
    cell = spec.find_cell(args.workload, bench.parent, bench)
    cell = cell._replace(traffic=dict(cell.traffic, warm_seconds=0))
    cell = plant(args.fault, cell)
    lo, hi = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _ = run.measure(cell, seed, args.seconds, False, "cuda", t0, reuse=True,
                                every=True)
        checks = result["checks"]
        failing = sorted(k for k, c in checks.items() if c["rule"] and not (
            c["value"] <= c["limit"] if c["rule"] == "<=" else c["value"] >= c["limit"]))
        vals = {k: c["value"] for k, c in checks.items()}
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "failing": failing, "numbers": vals,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in vals.items():
            lo[k], hi[k] = min(lo.get(k, v), v), max(hi.get(k, v), v)
    print(json.dumps({"workload": cell.name, "fault": args.fault, "seeds": args.seeds,
                      "largest": hi, "smallest": lo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
