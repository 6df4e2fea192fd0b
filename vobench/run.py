"""Runs one cell of the port's benchmark once and prints its result.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``vobench/`` and
the port (``monocular_visual_odometry_tpu_torch``). Set-up renders the
cell's frames on the card from the seed, builds the engine (or the batched
step), runs a warm pass and captures the programs; the window then drives the
cell's traffic for ``--seconds``; afterwards the timed path's outputs are
compared with the plain reference (``harness/check.py``). ``--trace 1`` adds
a profiled slice after the window and reports the per-layer metrics instead
of the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error list the same numbers. The run exits with
2 and prints no result without a CUDA device (or with fewer than the cell
asks for), and with 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "monocular_visual_odometry_tpu")
THREADS = 1   # host threads: the frame loop is one thread's work, and a pool jitters


def _environment(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    THREADS host threads."""
    base = root / "build" / "vobench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            reuse: bool = False, every: bool = False) -> tuple:
    """One run of ``cell`` (``harness.spec.Cell``) on ``device``: (the result
    object, ``checks`` last; what ``check.gather`` took). ``reuse``: the
    driver keeps its captured programs for the next run in this process;
    ``every``: ``checks`` also lists the numbers no limit holds."""
    import torch

    from harness import check, spec

    cfg = spec.vo_config(cell.config)
    traffic = cell.traffic
    drv = spec.driver(traffic["driver"], cell.bench_dir)(cfg, traffic, seed, device,
                                                           reuse=reuse)
    t_window = time.perf_counter()
    marks = [("process start", t_start)] + drv.setup
    print("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    win = drv.window(seconds)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = {"setup_s": t_window - t_start}
    e2e.update(drv.end_to_end(win))
    prof = None
    if trace:
        prof = drv.trace(traffic["profile"])
        prof["driver"] = traffic["driver"]
    got = check.gather(drv, win)
    failed = sum(int(((p["stages"] == check.STAGE_TRACKING) & ~p["ok"]).sum())
                 for p in got["passes"])
    drv.free()
    del drv
    if on_card:
        torch.cuda.empty_cache()
    rows = check.judge(got, cell.config, cell.limits, device, every)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir)(prof)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    result = {"correct": all(r[3] for r in rows.values()), "attempted": int(win.frames),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = prof["breakdown"]
    result["checks"] = {k: {"value": v, "rule": op, "limit": lim}
                        for k, (v, op, lim, _) in rows.items()}
    return result, got


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result object."""
    return measure(cell, seed, seconds, trace, device, t_start)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(ROOT)
    sys.path[:0] = [str(ROOT), str(BENCH)]
    from harness import spec

    cell = spec.find_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vobench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"vobench: {cell.name} seed {args.seed} on {_power_limit()}; peaks: H100 SXM "
          "(harness/counts.py)", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"vobench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} {c['rule']} {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
