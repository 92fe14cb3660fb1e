"""The plain reference against the port's plain path at a few lanes on the
CPU, in every mode: the start that set-up packs, and whole calls through
the harness with their resets. The tests may import the port; the
reference may not (test_gpubench_imports.py)."""

import pytest
import torch

from gpubench_helpers import RANDOM_CELLS, tiny_cell


@pytest.mark.parametrize("name", RANDOM_CELLS)
def test_start_matches_port(name):
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.ops import fused_rollout as fr

    from gpubench.modes.random import reference_config
    from gpubench.reference import rollout as R

    cell = tiny_cell(name)
    env = make(cell.config["env_id"])
    seed, b = 2**31 + 9, cell.params["batch"]
    states = env.generate(prng.split(prng.key(seed, device="cpu"), b), env.config)
    carry = fr.packed_init(env, states, "regen")
    want = R.start(reference_config(cell.config), seed, b, "cpu")
    for got, ref in zip((carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, carry.rng), want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("name", RANDOM_CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_calls_match_port(name, seed):
    from gpubench.harness import runner

    res = runner.run(tiny_cell(name), seed, 0.0, False, torch.device("cpu"), 0.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["state_lanes_wrong"]["value"] == 0


def test_checked_calls_hold_resets():
    """The tiny cells' checked calls end episodes, so the resets' layouts
    and keys are compared too."""
    from gpubench.harness import spec

    for name in RANDOM_CELLS:
        cell = tiny_cell(name)
        mode = spec.mode_module(cell).Mode(cell, 7, torch.device("cpu"))
        for i in range(mode.min_calls):
            mode.call(i, lambda _p: None)
        assert sum(int(m.episodes) for *_, m in mode.kept.values()) > 0, name
