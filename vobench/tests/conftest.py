"""Fixtures of the benchmark's own tests.

Run from the root of the checkout: ``python -m pytest vobench/tests -q``
(CPU; the tests marked ``cuda`` skip without a card, and run on one with
``python -m pytest vobench/tests -q -m cuda``). None imports JAX.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH)]

# a live and a batch cell small enough for the CPU: full-width frames (the
# two-view init needs the pixels), short passes at twice the step
TINY_LIVE = {"driver": "live", "pass_frames": 16, "translation_step": 0.08, "warm_frames": 12,
             "warm_seconds": 0,
             "sample": {"passes": 2, "frames": 2, "from": 10},
             "profile": {"frames": 14}}
TINY_BATCH = {"driver": "batch", "streams": 2, "pass_frames": 12, "stagger": 6,
              "translation_step": 0.08, "max_steps": 100,
              "sample": {"steps": 8, "from": 2, "to": 14, "inits": 2},
              "profile": {"steps": 2}}
TINY_LIMITS = dict(json.loads((BENCH / "limits" / "vo_default.live.json").read_text()),
                   score_frames=1, pose_frames=1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    """A copy of the benchmark in a temporary checkout with two more cells
    added as data only: new traffic and limits files and new entries in
    ``BENCHMARK.json``, no file of the benchmark edited. Their accuracy
    budget is the configuration's, widened for 20-frame passes (a short pass
    reads high: the 3% budget is one of 150 frames)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "vobench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, traffic, like in (("tiny_live", TINY_LIVE, "vo_default.live"),
                                ("tiny_batch", TINY_BATCH, "vo_default.batch25")):
        cell = f"vo_tiny.{name}"
        bench["workloads"].append({"name": cell, "config": "vo_tiny", "traffic": name,
                                   "chips": 1, "why": "a CPU test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
        (root / "vobench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (root / "vobench" / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    # a kind of traffic added as a file: a driver of its own, found by name
    shutil.copy(BENCH / "drivers" / "live.py", root / "vobench" / "drivers" / "live_copy.py")
    copy_cell = "vo_tiny.tiny_copy"
    bench["workloads"].append({"name": copy_cell, "config": "vo_tiny", "traffic": "tiny_copy",
                               "chips": 1, "why": "a CPU test's cell with a driver of its own"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vo_tiny.tiny_live" in m.get("workloads", ()):
            m["workloads"].append(copy_cell)
    (root / "vobench" / "traffic" / "tiny_copy.json").write_text(
        json.dumps(dict(TINY_LIVE, driver="live_copy")))
    (root / "vobench" / "limits" / f"{copy_cell}.json").write_text(json.dumps(TINY_LIMITS))
    bench["configs"].append(dict(bench["configs"][0], name="vo_tiny",
                                 file="vobench/configs/vo_tiny.json"))
    tiny = json.loads((BENCH / "configs" / "vo_default.json").read_text())
    tiny["name"] = "vo_tiny"
    tiny["accuracy"] = dict(tiny["accuracy"], ate_pct_max=20.0)
    (root / "vobench" / "configs" / "vo_tiny.json").write_text(json.dumps(tiny))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
