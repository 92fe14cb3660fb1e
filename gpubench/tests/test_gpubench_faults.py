"""The comparison fails what it should: the controls (the reference in the
program's place at a lower precision, or breaking the regen guarantee),
and a run whose timed path is broken underneath, on the CPU at a few
lanes. The harness's look for a card is skipped: `runner.run` is driven
on the CPU directly."""

import pytest
import torch

from gpubench_helpers import RANDOM_CELLS, tiny_cell


def _readings(name, controls, seed=11):
    from gpubench.harness import spec

    cell = tiny_cell(name)
    mode = spec.mode_module(cell).Mode(cell, seed, torch.device("cpu"))
    for i in range(mode.min_calls):
        mode.call(i, lambda _p: None)
    return {w: {c.name: c for c in checks} for w, checks in mode.readings(controls).items()}


def test_reward_bf16_control_fails_empty():
    r = _readings("empty8x8.random", ("reward_bf16",))
    assert all(c.ok for c in r[None].values())
    ctl = r["reward_bf16"]
    assert not ctl["reward_gap"].ok and ctl["state_lanes_wrong"].ok


@pytest.mark.parametrize("name", RANDOM_CELLS)
def test_stale_control_fails(name):
    r = _readings(name, ("stale",))
    assert all(c.ok for c in r[None].values())
    assert not r["stale"]["state_lanes_wrong"].ok


def _unchanged(step):
    def broken(source, carry, mark=None, **kw):
        _, metrics = step(source, carry, **kw)
        return carry, metrics

    return broken


def _half_batch(step):
    """Steps the first half of the lanes, keeps the rest as they were, and
    scales the half's totals to the batch (the mean over the rest)."""
    from minigrid_tpu_torch.ops.fused_rollout import PackedCarry

    def broken(source, carry, mark=None, **kw):
        h = carry.words.shape[1] // 2
        half = PackedCarry(*(x[:, :h].contiguous() for x in carry[:4]), carry.rng[:h])
        out, m = step(source, half, **kw)
        merged = PackedCarry(*(torch.cat([a, b[:, h:]], 1) for a, b in zip(out[:4], carry[:4])),
                             torch.cat([out.rng, carry.rng[h:]]))
        return merged, m._replace(episodes=m.episodes * 2, total_reward=m.total_reward * 2,
                                  obs_checksum=m.obs_checksum * 2)

    return broken


def _altered(step):
    def broken(source, carry, mark=None, **kw):
        out, m = step(source, carry, **kw)
        words = out.words.clone()
        words[5, 3] ^= 1 << 4  # one cell's colour in one lane
        return out._replace(words=words), m

    return broken


@pytest.mark.parametrize("name", RANDOM_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered], ids=["unchanged", "half_batch", "altered"])
def test_broken_timed_path_is_not_correct(name, fault):
    from gpubench.harness import runner

    def breaks(mode):
        mode.step = fault(mode.step)

    res = runner.run(tiny_cell(name), 11, 0.0, False, torch.device("cpu"), 0.0, after_setup=breaks)
    assert not res["correct"], res["checks"]
