"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `minigrid_tpu` (the port, `minigrid_tpu_torch`,
passes: names are compared whole), and nothing of the port in the
reference."""

import json
import os
import subprocess
import sys

import pytest

from gpubench_helpers import ROOT

PROBE_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
from gpubench_helpers import tiny_cell
from gpubench.harness import runner
import gpubench.run
res = runner.run(tiny_cell("empty8x8.random", batch=8, steps=8), 1, 0.0, True, torch.device("cpu"), 0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

PROBE_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import gpubench.reference.rollout, gpubench.reference.minigrid
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), tests=str(ROOT / "gpubench" / "tests"))],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = _top_level(PROBE_RUN)
    assert "minigrid_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "minigrid_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _top_level(PROBE_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "minigrid_tpu", "minigrid_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    from gpubench.harness import runner

    monkeypatch.setitem(sys.modules, "minigrid_tpu_torch_probe", sys)
    assert "minigrid_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "minigrid_tpu.envs", sys)
    assert runner.forbidden_modules() == ["minigrid_tpu"]


def test_forbidden_module_loaded_by_the_check_refuses_the_result(monkeypatch):
    """A module of the JAX package loaded after the window, by the
    comparison, still ends the run without a result."""
    import torch

    from gpubench.harness import runner
    from gpubench_helpers import tiny_cell

    cell = tiny_cell("empty8x8.random", batch=8, steps=8)

    def loads_it(mode):
        check = mode.check

        def check_and_load():
            monkeypatch.setitem(sys.modules, "minigrid_tpu.envs", sys)
            return check()

        mode.check = check_and_load

    with pytest.raises(SystemExit, match="minigrid_tpu"):
        runner.run(cell, 1, 0.0, False, torch.device("cpu"), 0.0, after_setup=loads_it)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "empty8x8.random", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_prints_no_result(tmp_path):
    """A directory with only `BENCHMARK.json` and the benchmark's files: no
    program to run, so no result, whether or not a card is present."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "empty8x8.random", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
