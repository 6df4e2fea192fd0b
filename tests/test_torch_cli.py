"""The port's command-line entry point on the CPU, against the JAX package's
renderer and CLI, and against the port's engine driven in-process.

``cli.main([... "--synthetic", "--frames", "8", "--cpu"])`` renders the
sequence (pixels equal to JAX ``render_sequence``'s, truth file byte-equal),
writes trajectory rows equal to an in-process ``VOEngine(device="cpu")``
run on the same frames (to the 6 written decimals), and a ``report.json``
with the JAX CLI's keys; without ``--cpu`` and without a card it exits
non-zero. Its summary prints the span totals (its own ``vo_step``, ``draw``
and ``checkpoint``; with ``--profile-dir`` the engine's spans too, which its
trace then carries) and the engine's counters.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu_torch import cli
from monocular_visual_odometry_tpu_torch.models.vo import VOEngine
from monocular_visual_odometry_tpu_torch.runtime import decode_png
from monocular_visual_odometry_tpu_torch.utils import logging as lg
from monocular_visual_odometry_tpu_torch.utils import io as tio
from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

ROOT = Path(__file__).resolve().parents[1]
N = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine's ops are small, and beside other
    test workers a pool of threads per process only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cli")
    rc, stdout = _main(["--synthetic", "--frames", str(N), "--output", str(out), "--cpu",
                        "--viewer", "--save-frames", "--checkpoint-every", "4"])
    return out, rc, stdout


def test_cli_runs_and_writes_its_outputs(run):
    out, rc, stdout = run
    assert rc == 0
    assert "[cli] frame loader: native C++" in stdout
    assert len(re.findall(r"^frame +\d+ \[", stdout, flags=re.M)) == N
    assert f"[cli] trajectory ({N} poses)" in stdout
    for name in ["cam_traj.txt", "report.json", "trajectory.png", "viewer.html",
                 "state_00003.npz", "state_00007.npz"] + [f"frame_{i:05d}.png" for i in range(N)]:
        assert (out / name).stat().st_size > 0, name
    assert tio.read_trajectory(out / "cam_traj.txt").shape == (N, 4, 4)


def _rows(stdout):
    """The summary's rows: {name: the numbers after it}."""
    return {m[0]: m[1].split() for m in re.findall(r"^([a-z_.]+) +([\d. ]+)$", stdout, re.M)}


def test_summary_prints_the_span_totals_and_the_counters(run):
    """A row per span (calls, total s, mean ms: the form ``chip_smoke.py``
    reads), the engine's spans only with spans on (not here), and the
    counters, which match the banners."""
    _, _, stdout = run
    rows = _rows(stdout)
    assert rows["vo_step"][0] == rows["draw"][0] == str(N) and rows["checkpoint"][0] == "2"
    assert not any(k.startswith("engine.") for k in rows)
    banners = re.findall(r"^frame +\d+ \[(\w+) *\].*(KF|  ) (ok|TRACK-FAIL)$", stdout, re.M)
    assert len(banners) == N
    assert int(rows["keyframes"][0]) == sum(kf == "KF" for _, kf, _ in banners)
    assert int(rows["frames.first"][0]) == 1
    assert sum(int(rows[f"frames.{k}"][0]) for k in ("first", "init", "track")) == N
    assert not lg.spans_on()


def test_rendered_sequence_equals_jax(run, tmp_path):
    out, _, _ = run
    jsyn.render_sequence(str(tmp_path), n_frames=N, seed=0)
    seq = out / "synthetic_seq"
    assert (seq / "cam_traj_truth.txt").read_bytes() == \
        (tmp_path / "cam_traj_truth.txt").read_bytes()
    for i in range(N):
        name = f"rgb_{i:05d}.png"
        np.testing.assert_array_equal(decode_png(str(seq / name), 480, 640),
                                      decode_png(str(tmp_path / name), 480, 640), err_msg=name)


def test_trajectory_equals_in_process_engine(run, tmp_path):
    out, _, _ = run
    paths = tio.image_paths(out / "synthetic_seq", N)
    eng = VOEngine(VOConfig(), 480, 640, device="cpu")
    poses = np.stack([eng.add_frame(decode_png(p, 480, 640)).T_w_c.numpy() for p in paths])
    tio.write_trajectory(tmp_path / "ref.txt", poses)
    assert (out / "cam_traj.txt").read_text() == (tmp_path / "ref.txt").read_text()


def _jax_report_keys():
    """The keys the JAX CLI writes into report.json, read from its source."""
    src = (ROOT / "monocular_visual_odometry_tpu" / "cli.py").read_text()
    literal = src[src.index("report = {"):src.index("}", src.index("report = {"))]
    return set(re.findall(r'"(\w+)":', literal)) | set(re.findall(r'report\["(\w+)"\]', src))


def test_report_has_the_jax_keys(run):
    out, _, stdout = run
    report = json.loads((out / "report.json").read_text())
    keys = _jax_report_keys()
    assert "ate_sim3" in keys and "drift_per_frame" in keys
    assert set(report) == keys
    assert report["frames"] == N and len(report["drift_per_frame"]) == N
    assert f"[cli] report: {json.dumps(report)}" in stdout


def test_resume_without_matplotlib_and_with_a_trace(run, tmp_path, monkeypatch):
    """--resume restores the state and the loader starts at frame 0, as in
    the JAX CLI; without matplotlib (or Pillow) the plot and the animation
    are skipped and said so, and everything else is written."""
    out, _, _ = run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc, stdout = _main(["--synthetic", "--frames", "3", "--output", str(tmp_path), "--cpu",
                        "--resume", str(out / "state_00003.npz"), "--animate",
                        "--profile-dir", str(tmp_path / "trace")])
    assert rc == 0
    assert f"[cli] resumed from {out / 'state_00003.npz'} at frame 4" in stdout
    assert re.search(r"^frame +0 \[", stdout, flags=re.M)
    assert "[cli] plot skipped: matplotlib is not installed" in stdout
    assert "[cli] animation skipped: matplotlib is not installed" in stdout
    assert not (tmp_path / "trajectory.png").exists()
    assert tio.read_trajectory(tmp_path / "cam_traj.txt").shape == (3, 4, 4)
    assert (tmp_path / "report.json").exists() and (tmp_path / "trace" / "trace.json").exists()
    # --profile-dir turned spans on for the run: the trace has the engine's
    # ranges and the summary their totals; off again afterwards
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"vo.engine.launch"' in trace and '"vo.vo_step"' in trace
    rows = _rows(stdout)
    assert rows["engine.launch"][0] == rows["vo_step"][0] == "3"
    # the resumed state is past its first frame: each frame ran a marked program
    assert sum(int(rows.get(f"{p}.features", ["0"])[0]) for p in ("init", "track")) == 3
    assert not lg.spans_on()


def test_cuda_without_a_card_exits_non_zero(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out, _, _ = run
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc, _ = _main(["--synthetic", "--frames", str(N), "--output", str(out)])
    assert rc != 0 and "cuda" in buf.getvalue()
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        cli.main(["--output", str(out)])
    assert e.value.code == 2


def test_entry_points():
    """``python -m ...cli`` runs, and the packaging names the script."""
    r = subprocess.run([sys.executable, "-m", "monocular_visual_odometry_tpu_torch.cli", "--help"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0 and "--checkpoint-every" in r.stdout
    assert 'mvo-run-torch = "monocular_visual_odometry_tpu_torch.cli:main"' in \
        (ROOT / "pyproject.toml").read_text()
