"""What a run is asked to do, found by name: the cell's entry in
`BENCHMARK.json`, its parameters (`workloads/<cell>.json`), its traffic
mix (`traffic/<traffic>.json`, which names the mode that drives it), its
configuration (`configs/<config>.json`), and the metrics that the cell
reports, each read by `metrics/<metric>.py`."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    chips: int
    params: dict
    traffic: dict
    config: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _metrics(entries, cell: str) -> list:
    """The metrics of `entries` that `cell` reports: those that list it,
    and those that list no cells."""
    return [Metric(m["name"], m["unit"]) for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, benchmark: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `benchmark` (default: the checkout's
    `BENCHMARK.json`), its files read from `bench_dir`."""
    benchmark = benchmark if benchmark is not None else load_benchmark(bench_dir.parent)
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {sorted(entries)})")
    entry = entries[name]
    params = _json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if params[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {params[key]!r} in its file and {entry[key]!r} in BENCHMARK.json")
    return Cell(
        name=name,
        chips=entry["chips"],
        params=params,
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        config=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        end_to_end=_metrics(benchmark["end_to_end"], name),
        per_layer=_metrics(benchmark["per_layer"], name),
        bench_dir=bench_dir,
    )


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_module(cell: Cell):
    return load_module(cell.bench_dir / "modes" / f"{cell.mode}.py", f"gpubench_mode_{cell.mode}")


def metric_reader(cell: Cell, metric: Metric):
    path = cell.bench_dir / "metrics" / f"{metric.name}.py"
    return load_module(path, "gpubench_metric_" + metric.name.replace(".", "_").replace("-", "_")).read
