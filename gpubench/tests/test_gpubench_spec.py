"""`BENCHMARK.json` against the contract's shape, and every cell, traffic
mix, configuration and metric found by name."""

import json
import re
import shutil

import pytest

from gpubench_helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "gpubench/run.py"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    from gpubench.harness import spec

    cell = spec.load_cell(w["name"])
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert (ROOT / "gpubench" / "modes" / f"{cell.mode}.py").exists()
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(cell, m))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
    else:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["reduced"] == c["reduced"] == []
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cell_from_files_alone(tmp_path):
    """A cell, a traffic mix and a per-layer metric added as files and
    entries alone run through the harness unchanged."""
    import torch

    from gpubench.harness import runner, spec

    bench_dir = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench_dir / "traffic" / "random_again.json").write_text(json.dumps(
        dict(json.loads((bench_dir / "traffic" / "random.json").read_text()), note="a fixture mix")))
    (bench_dir / "workloads" / "empty8x8.fixture.json").write_text(json.dumps(dict(
        json.loads((bench_dir / "workloads" / "empty8x8.random.json").read_text()),
        traffic="random_again", batch=16, steps=8, check_within=1, reference_block=16)))
    (bench_dir / "metrics" / "fixture.calls.py").write_text("def read(run):\n    return float(len(run.calls_s))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "empty8x8.fixture", "config": "empty8x8", "traffic": "random_again",
                               "chips": 1, "why": "a fixture"})
    bench["per_layer"].append({"name": "fixture.calls", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "carry surface", "moves": "env_steps_per_s",
                               "workloads": ["empty8x8.fixture"]})
    bench["end_to_end"][0]["workloads"].append("empty8x8.fixture")
    cell = spec.load_cell("empty8x8.fixture", bench, bench_dir)
    assert [m.name for m in cell.per_layer] == ["fixture.calls"]
    res = runner.run(cell, 5, 0.0, True, torch.device("cpu"), 0.0)
    assert res["correct"] and res["metrics"]["fixture.calls"]["value"] == res["attempted"]
