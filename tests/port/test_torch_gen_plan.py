"""The launch plans of the connect kernel (B4) and the room-chain kernel
(B5), on the CPU.

`connect_plan` and `mr_chain_plan` (`ops/gen_kernel.py`) on every ported
id that reaches B4 (KeyCorridor ×6) or B5 (MultiRoom ×3), at the main
path's B = 32,768 and on ragged batches, with the card's occupancy given
as numbers: a lane's threads never straddle a warp, the blocks cover the
batch, and the warps an SM runs follow the occupancy. A room grid the
masks do not hold, a chain longer than the kernel keeps, an empty batch
and an occupancy of no block raise. This file imports no JAX.
"""

import pytest

from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.ops import gen_kernel as gk

KC_IDS = sorted(i for i in env_list if make(i).config.family == "keycorridor")
MR_IDS = sorted(i for i in env_list if make(i).config.family == "multiroom")
BATCHES = (1, 33, 4096 + 77, 32_768, 32_768 + 5, 2_097_152)
# Blocks an SM holds: the card's (PERF.md §6: 5 of the connect kernel, 4
# of the room-chain kernel), and one, where a launch takes more waves.
OCCUPANCIES = {"card": {"connect": 5, "chain": 4}, "one": {"connect": 1, "chain": 1}}


def _warps(b, t, held, sms=gk.SM_COUNT):
    """Warps an SM runs on average over the launch's waves."""
    blocks = -(-b * t // gk.GEN_BLOCK_THREADS)
    return -(-b * t // 32) / (sms * -(-blocks // (held * sms)))


def _check(plan, b, threads, held):
    t = plan.threads_per_lane
    assert t == threads and 32 % t == 0  # a lane's threads lie in one warp
    assert plan.lanes * t == gk.GEN_BLOCK_THREADS
    assert (plan.blocks - 1) * plan.lanes < b <= plan.blocks * plan.lanes
    assert plan.blocks_per_sm == held
    assert plan.warps_per_sm == pytest.approx(_warps(b, t, held))


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCIES))
@pytest.mark.parametrize("env_id", KC_IDS)
def test_connect_plan_fits_each_keycorridor_id(env_id, occupancy):
    cfg = make(env_id).config
    held = OCCUPANCIES[occupancy]["connect"]
    for b in BATCHES:
        _check(gk.connect_plan(cfg.num_rows, cfg.num_cols, b, held), b, gk.CONNECT_THREADS, held)


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCIES))
@pytest.mark.parametrize("env_id", MR_IDS)
def test_mr_chain_plan_fits_each_multiroom_id(env_id, occupancy):
    cfg = make(env_id).config
    held = OCCUPANCIES[occupancy]["chain"]
    for b in BATCHES:
        _check(gk.mr_chain_plan(cfg.max_num_rooms, b, held), b, gk.MR_THREADS, held)


def test_plans_at_the_main_path_batch():
    """At the main path's 32,768 lanes: the connect kernel's 256 blocks of
    128 lanes run 15.5 warps an SM in one wave; the room-chain kernel's
    1,024 blocks of 32 lanes run 31 (4 blocks an SM held: two waves), 62
    where an SM holds 8."""
    plan = gk.connect_plan(3, 3, 32_768, 5)
    assert (plan.threads_per_lane, plan.lanes, plan.blocks) == (2, 128, 256)
    assert plan.warps_per_sm == pytest.approx(2048 / 132)
    plan = gk.mr_chain_plan(4, 32_768, 4)
    assert (plan.threads_per_lane, plan.lanes, plan.blocks) == (8, 32, 1024)
    assert plan.warps_per_sm == pytest.approx(8192 / (132 * 2))
    assert gk.mr_chain_plan(4, 32_768, 8).warps_per_sm == pytest.approx(8192 / 132)
    assert gk.connect_plan(3, 3, 32_768, 5, sms=264).blocks == 256  # the SMs change the waves, not the blocks


def test_plans_raise_where_nothing_fits():
    with pytest.raises(ValueError, match="no block"):
        gk.connect_plan(3, 3, 32_768, 0)
    with pytest.raises(ValueError, match="no block"):
        gk.mr_chain_plan(4, 32_768, 0)
    with pytest.raises(ValueError, match="room masks"):
        gk.connect_plan(5, 7, 32_768, 8)
    for nmax in (0, 9):
        with pytest.raises(ValueError, match="max_num_rooms"):
            gk.mr_chain_plan(nmax, 32_768, 8)
    for plan in (lambda b: gk.connect_plan(3, 3, b, 8), lambda b: gk.mr_chain_plan(4, b, 8)):
        with pytest.raises(ValueError, match="empty batch"):
            plan(0)
    assert gk.connect_plan(5, 6, 64, 8).blocks == 1  # 30 rooms, the most the masks hold
