"""A whole run on the CPU (the look for a card skipped): the last line's
shape, and ``correct`` coming out false when the timed path is broken
underneath: a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced (keypoints, a pose). A run on
one card has no exchange between chips to leave out."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT

import run
from harness import spec

SEED = 2**31 + 99


def _run(tiny_bench, name, seconds):
    cell = spec.find_cell(name, tiny_bench, tiny_bench / "vobench")
    return cell, run.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter())


def _broken_in_window(monkeypatch, tiny_bench, owner, attr, fault):
    """``owner.attr`` replaced by ``fault(original)`` from the window's start
    on: set-up (the warm pass, the captures) runs the sound program."""
    original = getattr(owner, attr)
    for kind in ("live", "batch"):
        drv = spec.driver(kind, tiny_bench / "vobench")
        window = drv.window

        def broken(self, seconds, window=window):
            monkeypatch.setattr(owner, attr, fault(original))
            return window(self, seconds)

        monkeypatch.setattr(drv, "window", broken)


def _failing(result):
    return sorted(k for k, c in result["checks"].items()
                  if not (c["value"] <= c["limit"] if c["rule"] == "<=" else
                          c["value"] >= c["limit"]))


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "vobench/run.py", "--workload", "vo_default.live",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "vobench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "vobench/run.py", "--workload", "vo_default.live",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "monocular_visual_odometry_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "monocular_visual_odometry_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "monocular_visual_odometry_tpu"]


@pytest.fixture(scope="module")
def sound_live(tiny_bench):
    return _run(tiny_bench, "vo_tiny.tiny_live", 30.0)


def test_the_last_line_has_its_keys_and_the_checks_last(sound_live):
    cell, r = sound_live
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "rule", "limit"} for c in line["checks"].values())
    assert line["correct"] is True and line["attempted"] > 0, _failing(r)


def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny_bench, monkeypatch):
    from monocular_visual_odometry_tpu_torch.models import vo as V

    def frozen(call):
        def step(self, st, img, stage, key):
            _, out = call(self, st, img, stage, key)
            return st, out._replace(stage=st.stage, T_w_c=st.T_w_c)
        return step

    _broken_in_window(monkeypatch, tiny_bench, V.StagePrograms, "__call__", frozen)
    _, r = _run(tiny_bench, "vo_tiny.tiny_live", 30.0)
    assert r["correct"] is False and "ate_pct" in _failing(r)


def test_keypoints_altered_where_they_are_made_are_not_correct(tiny_bench, monkeypatch):
    from monocular_visual_odometry_tpu_torch.models import vo as V

    def shifted(made):
        def features(img, cfg):
            f = made(img, cfg)
            return f._replace(kpts=f.kpts + torch.tensor([1.0, 0.0]))
        return features

    _broken_in_window(monkeypatch, tiny_bench, V, "features_from_config", shifted)
    _, r = _run(tiny_bench, "vo_tiny.tiny_live", 30.0)
    assert r["correct"] is False and "score_gap" in _failing(r)


def test_poses_altered_where_ba_writes_them_are_not_correct(tiny_bench, monkeypatch):
    from monocular_visual_odometry_tpu_torch.models import ba

    def moved(update):
        def written(cfg, cam, st):
            new = update(cfg, cam, st)
            shift = torch.zeros(4, 4)
            shift[0, 3] = 1e-3
            return new._replace(T_w_c=new.T_w_c + shift,
                                ring=new.ring._replace(poses=new.ring.poses + shift))
        written.calls = 0
        return written

    _broken_in_window(monkeypatch, tiny_bench, ba, "ba_update_state", moved)
    _, r = _run(tiny_bench, "vo_tiny.tiny_live", 30.0)
    assert r["correct"] is False and "pose_excess_med_px" in _failing(r)


def test_a_driver_of_its_own_runs_the_copied_traffic(tiny_bench):
    _, r = _run(tiny_bench, "vo_tiny.tiny_copy", 20.0)
    assert set(r["metrics"]) == {"fps", "frame_ms_p95", "setup_s"} and r["attempted"] > 0


def test_the_batch_cell_runs_and_is_correct(tiny_bench):
    _, r = _run(tiny_bench, "vo_tiny.tiny_batch", 40.0)
    assert set(r["metrics"]) == {"agg_fps", "setup_s"}
    assert r["correct"] is True, _failing(r)


def test_half_of_the_batch_left_out_is_not_correct(tiny_bench, monkeypatch):
    from monocular_visual_odometry_tpu_torch.models import vo as V

    def half(step):
        def stepped(cfg, cam, sts, imgs, **kw):
            new, out = step(cfg, cam, sts, imgs, **kw)
            left = torch.arange(imgs.shape[0]) >= imgs.shape[0] // 2
            where = spec._load("driver", "batch", tiny_bench / "vobench").where
            kept = where(left, sts, new)._replace(rng=new.rng)
            return kept, out._replace(
                T_w_c=torch.where(left[:, None, None], sts.T_w_c, out.T_w_c),
                stage=torch.where(left, sts.stage, out.stage))
        return stepped

    _broken_in_window(monkeypatch, tiny_bench, V, "step_general_batched", half)
    _, r = _run(tiny_bench, "vo_tiny.tiny_batch", 40.0)
    assert r["correct"] is False and "ate_pct" in _failing(r)
