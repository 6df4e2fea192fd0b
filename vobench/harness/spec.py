"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics. Everything that belongs
to one of them lives in a file of its own under ``vobench/``, found by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the whole ``VOConfig`` as it is run
  (``vo_config``), the keys changed from the port's defaults, the source,
  what was assumed and the accuracy the deployment promises;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  driver its ``driver`` key names;
- ``drivers/<driver>.py``: a kind of traffic's generator and driver, a class
  ``Driver`` (set-up in its constructor, ``window``, ``end_to_end``,
  ``trace``, ``frame``, ``free``);
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``
  in that cell, with the readings they were set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(trace) -> float | None`` over what the traced run recorded.

A new cell, configuration, traffic mix or per-layer metric is new files and
new entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    """One entry of ``workloads`` with what its names point to."""

    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json
    end_to_end: list      # the end_to_end entries this cell reports
    per_layer: list       # the per_layer entries this cell reports
    bench_dir: Path       # where its files are


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``bench_dir``. Raises KeyError for a name the benchmark does not list,
    FileNotFoundError where one of its files is missing."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({[w['name'] for w in bench['workloads']]})")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"],
        config=_read_json(bench_dir / "configs" / f"{entry['config']}.json", "config"),
        traffic_name=entry["traffic"],
        traffic=_read_json(bench_dir / "traffic" / f"{entry['traffic']}.json", "traffic"),
        limits=_read_json(bench_dir / "limits" / f"{name}.json", "limits"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir,
    )


_LOADED: dict = {}


def _load(kind: str, name: str, bench_dir: Path):
    """The module ``<kind>s/<name>.py`` under ``bench_dir`` (loaded once)."""
    path = bench_dir / f"{kind}s" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: {path} is missing")
    if path in _LOADED:
        return _LOADED[path]
    spec = importlib.util.spec_from_file_location(
        f"vobench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return _load("metric", name, bench_dir).read


def driver(name: str, bench_dir: Path = BENCH_DIR):
    """``drivers/<name>.py``'s ``Driver``."""
    return _load("driver", name, bench_dir).Driver


def _replace(obj: Any, changes: dict, where: str) -> Any:
    """``obj`` (a dataclass) with ``changes`` applied; a dict value is a
    nested dataclass's changes. An unknown key raises."""
    names = {f.name for f in dataclasses.fields(obj)}
    kw = {}
    for key, value in changes.items():
        if key not in names:
            raise KeyError(f"{where}: {type(obj).__name__} has no field {key!r}")
        cur = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(cur):
            kw[key] = _replace(cur, value, f"{where}.{key}")
        else:
            kw[key] = tuple(value) if isinstance(cur, tuple) else type(cur)(value)
    return dataclasses.replace(obj, **kw)


def vo_config(config: dict):
    """The port's ``VOConfig`` as the file's ``vo_config`` states it."""
    from monocular_visual_odometry_tpu_torch.utils.config import VOConfig

    return _replace(VOConfig(), config["vo_config"], config.get("name", "config"))
