"""The rollout kernel's launch plan and its 16-bit cells, on the CPU.

`rollout_plan` (lanes a block, threads a lane, cell width) on every
ported id: the block fits shared memory, a lane's threads never straddle a
warp, and the shared memory is what `csrc/rollout_kernel.cuh` carves. The
16-bit cell's plain codec (`ops/packing.py`) round-trips every word of the
committed reference files (the JAX package's generators and rollouts) and
of a short `plain_rollout` of each ported family, and refuses a word that
does not fit. This file imports no JAX.
"""

import dataclasses
import glob
from pathlib import Path

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.ops.packing import fits_cell16, pack_cell16, unpack_cell16

DATA = Path(__file__).resolve().parent / "data"
BATCHES = (256, 8192, 32_768, 262_144, 2_097_152)


def _family_ids():
    """The first ported id of each family."""
    seen = {}
    for env_id in env_list:
        seen.setdefault(make(env_id).config.family, env_id)
    return sorted(seen.values())


@pytest.mark.parametrize("env_id", env_list)
def test_rollout_plan_fits_every_ported_id(env_id):
    cfg = make(env_id).config
    assert fr.rollout_cell_bits(cfg) == 16  # every ported family at view 7
    for b in BATCHES:
        plan = fr.rollout_plan(cfg, b)
        threads = plan.lanes * plan.threads_per_lane
        assert plan.smem <= fr._SMEM_LIMIT and threads <= {1: 128, 4: 256}[plan.threads_per_lane]  # launch bounds
        assert plan.lanes in fr.LANE_BLOCKS[16, plan.threads_per_lane]
        assert 32 % plan.threads_per_lane == 0 and threads % 32 == 0 and plan.lanes % 32 == 0
        assert plan.smem == fr.rollout_smem_bytes(cfg, plan.lanes, plan.threads_per_lane, plan.cell_bits)
        assert 1 <= plan.blocks_per_sm == fr.mirror_blocks_per_sm(threads, plan.smem)
        assert 0 < plan.warps_per_sm <= 64


def test_rollout_plan_takes_more_threads_only_where_warps_are_short():
    """One thread a lane wherever it holds `ENOUGH_WARPS` an SM (B = 32,768
    gives at most 7.76 at one thread a lane); four where the grid's cells
    leave an SM fewer lanes (MultiRoom's 25x25 at B = 32,768: 3.9)."""
    for env_id, b in (("MiniGrid-Empty-8x8-v0", 2_097_152), ("MiniGrid-KeyCorridorS6R3-v0", 32_768),
                      ("MiniGrid-Fetch-8x8-N3-v0", 32_768), ("MiniGrid-Dynamic-Obstacles-16x16-v0", 262_144)):
        plan = fr.rollout_plan(make(env_id).config, b)
        assert plan.threads_per_lane == 1 and plan.warps_per_sm >= fr.ENOUGH_WARPS, env_id
    plan = fr.rollout_plan(make("MiniGrid-MultiRoom-N4-S5-v0").config, 32_768)
    assert plan.threads_per_lane == 4 and plan.warps_per_sm > 32_768 / fr.SM_COUNT / 32
    # The card's occupancy decides where it is given.
    plan = fr.rollout_plan(make("MiniGrid-Empty-8x8-v0").config, 2_097_152, lambda lanes, tpl, bits, smem: 1)
    assert plan.threads_per_lane == 4 and plan.lanes == 64


def test_rollout_plan_runs_int32_cells_off_the_16_bit_configurations():
    cfg = make("MiniGrid-Empty-8x8-v0").config
    assert "babyai" not in {make(e).config.family for e in env_list}
    for other in (dataclasses.replace(cfg, agent_view_size=5), dataclasses.replace(cfg, family="babyai")):
        plan = fr.rollout_plan(other, 32_768)
        assert (plan.cell_bits, plan.threads_per_lane) == (32, 1)
        assert plan.lanes <= fr.kernel_lane_block(other)
    with pytest.raises(ValueError, match="shared memory"):
        fr.rollout_plan(EnvConfig(family="empty", width=80, height=80, max_steps=100), 32)


def test_mirror_blocks_per_sm():
    assert fr.mirror_blocks_per_sm(128, 17_184) == 6  # registers: 80 a thread
    assert fr.mirror_blocks_per_sm(128, 17_184, registers=40) == 12  # shared memory
    assert fr.mirror_blocks_per_sm(512, 100_000, registers=32) == 2
    assert fr.mirror_blocks_per_sm(32, 1_000, registers=16) == 32


def _reference_words():
    """(name, int32 words) of every committed reference file: packed words,
    and state grids `(..., 5)` packed as `ops/packing.py` packs them."""
    for path in sorted(glob.glob(str(DATA / "*.npz"))):
        data = np.load(path)
        for k in data.files:
            x = data[k]
            if k.endswith("words"):
                yield f"{Path(path).name}:{k}", torch.from_numpy(x.astype(np.int32))
            elif k.endswith("grid") and x.shape[-1] == 5:
                g = torch.from_numpy(x.astype(np.int32))
                yield f"{Path(path).name}:{k}", g[..., 0] | g[..., 1] << 4 | g[..., 2] << 8 | g[..., 3] << 12 | (
                    g[..., 4] << 16)


def test_cell16_codec_round_trips_the_reference_files():
    names = []
    for name, words in _reference_words():
        assert bool(fits_cell16(words).all()), name
        assert torch.equal(unpack_cell16(pack_cell16(words)), words), name
        assert int(pack_cell16(words).max()) < 1 << 16 and int(pack_cell16(words).min()) >= 0, name
        names.append(name)
    assert len(names) >= 100  # every file, every case


@pytest.mark.parametrize("env_id", _family_ids())
def test_cell16_codec_round_trips_each_familys_plain_rollout(env_id):
    """Every word of a 16-step random-policy `plain_rollout` of the
    family's first id (64 lanes, cached mode: every reset reloads the
    template) fits and round-trips."""
    env = make(env_id)
    carry = fr.packed_init(env, env.reset_batch(key(0, device="cpu"), 64)[0], "cached")
    words, regs = carry.words, carry.regs
    actions = torch.from_numpy(np.random.default_rng(0).integers(0, 7, (16, 1, 64)).astype(np.int32))
    for a in actions:
        for w in (words, carry.tmpl_words):
            assert bool(fits_cell16(w).all()) and torch.equal(unpack_cell16(pack_cell16(w)), w)
        words, regs = fr.plain_rollout(words, regs, carry.tmpl_words, carry.tmpl_regs, a, env.config,
                                       env.transition)[:2]


def test_cell16_codec_refuses_words_that_do_not_fit():
    fit = torch.tensor([0, 1, 0x7F37F, 2 | 5 << 4, 4 | 4 << 4 | 2 << 8, 7 | 5 << 12 | 3 << 16], dtype=torch.int32)
    assert bool(fits_cell16(fit).all())
    assert torch.equal(unpack_cell16(pack_cell16(fit)), fit)
    bad = torch.tensor([8 << 4, 4 << 8, 8 << 16, 1 << 20, -1, 1 << 30], dtype=torch.int32)
    assert not bool(fits_cell16(bad).any())
