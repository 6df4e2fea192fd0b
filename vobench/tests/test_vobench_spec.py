"""The benchmark's definition: cells, configurations and metrics found by
name, ``BENCHMARK.json`` within the rules it is held to, and a cell added as
data only."""

import dataclasses
import json
import re

import pytest
from conftest import BENCH, ROOT

from harness import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
PER_LAYER = [m["name"] for m in BENCHMARK["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    cell = spec.find_cell(name, ROOT)
    assert spec.driver(cell.traffic["driver"]).__name__ == "Driver"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_an_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("vo_default.nothing", ROOT)


@pytest.mark.parametrize("name", PER_LAYER)
def test_every_per_layer_metric_has_a_reader(name):
    read = spec.metric_reader(name)
    assert read({}) is None  # nothing to read: the metric is left out, never 0


def _changed(full: dict, default: dict, prefix: str = "") -> list:
    """Dotted keys at which ``full`` differs from ``default``."""
    out = []
    for k, v in full.items():
        if isinstance(v, dict) and isinstance(default.get(k), dict):
            out += _changed(v, default[k], f"{prefix}{k}.")
        elif v != default.get(k):
            out.append(prefix + k)
    return out


@pytest.mark.parametrize("entry", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_configurations_are_the_ports(entry):
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    cfg = json.loads((ROOT / entry["file"]).read_text())
    built = spec.vo_config(cfg)
    assert json.loads(json.dumps(dataclasses.asdict(built))) == cfg["vo_config"]
    default = json.loads(json.dumps(dataclasses.asdict(VOConfig())))
    changed = _changed(cfg["vo_config"], default)
    assert sorted(changed) == sorted(cfg["changed_from_default"])
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["name"] == entry["name"]


def test_benchmark_json_keeps_its_rules():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["vobench"] and b["command"] == ["python3", "vobench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in b["end_to_end"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        for w in m["workloads"]:
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", CELLS)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_as_data_only_is_found(tiny_bench):
    new = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    old = {w["name"]: w for w in BENCHMARK["workloads"]}
    assert all(old[w["name"]] == w for w in new["workloads"] if w["name"] in old)
    for name in ("vo_tiny.tiny_live", "vo_tiny.tiny_batch"):
        cell = spec.find_cell(name, tiny_bench, tiny_bench / "vobench")
        assert cell.config_name == "vo_tiny" and cell.limits["passes"] == 1
        for f in (f"traffic/{cell.traffic_name}.json", f"limits/{name}.json"):
            assert not (BENCH / f).exists() and (tiny_bench / "vobench" / f).is_file()


def test_a_driver_added_as_a_file_is_found_by_name(tiny_bench):
    cell = spec.find_cell("vo_tiny.tiny_copy", tiny_bench, tiny_bench / "vobench")
    assert cell.traffic["driver"] == "live_copy"
    assert not (BENCH / "drivers" / "live_copy.py").exists()
    copy = spec.driver("live_copy", tiny_bench / "vobench")
    assert copy is not spec.driver("live") and copy.__name__ == "Driver"
    with pytest.raises(FileNotFoundError):
        spec.driver("nothing", tiny_bench / "vobench")


def test_stage_pieces_are_kept_only_while_they_close_on_the_program():
    from harness import trace

    units = [dict(program=2, kernels=7000, busy_ms=13.0)] * 3 + [dict(program=1, kernels=1,
                                                                      busy_ms=1.0)]
    p = dict(kernels={"a": 1100, "c": 1500, "d": 4000, "ba": 2800, "keyframe": 100},
             busy_ms={"a": 3.2, "c": 3.6, "d": 7.5, "ba": 4.9, "keyframe": 0.5})
    assert trace.closure(p, units, 2) == ""
    # BA taken off the program's path while its piece still builds
    assert trace.closure(p, [dict(u, kernels=4200, busy_ms=8.0) for u in units], 2)
    assert trace.closure(p, units[3:], 2) == "no tracking frame profiled"
