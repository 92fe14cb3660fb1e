"""LavaGap, FourRooms, Lava and Simple Crossing, LockedRoom and Playground
in the port against the JAX package on the CPU: each of the 14
generators byte for byte per registered id, against `jax.vmap(generate)`
(B = 32) as `make_family_reference.py` stored it in
`data/family_generators_b32.npz` (the `slow` test recomputes it live),
with its configuration, the base transition and the missions. The draws
that are new to these generators (`fold_in`, `permute`, one key reduced
over two spans) are held to jax.random in test_torch_prng.py; the mixed
LavaCrossing + FourRooms batch in test_torch_mixed.py; the kernels on these
families in test_torch_kernel.py and test_torch_policy_kernel.py (on a
card)."""

import dataclasses

import make_family_reference as fref
import numpy as np
import pytest

from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.envs.base import BASE_STEP
from minigrid_tpu_torch.utils.convert import state_to_numpy

IDS = fref.ROOMS_CROSSINGS_IDS
FAMILIES = ("lavagap", "fourrooms", "crossing", "lockedroom", "playground")


def test_ids_are_the_jax_packages_in_order():
    assert IDS == [e for e in env_list if make(e).config.family in FAMILIES]
    assert len(env_list) == 70


def test_missions_are_the_jax_packages():
    jax = pytest.importorskip("jax")  # noqa: F841
    from minigrid_tpu.envs import crossing as jcr
    from minigrid_tpu.envs import fourrooms as jfo
    from minigrid_tpu.envs import lavagap as jlg
    from minigrid_tpu.envs import lockedroom as jlr
    from minigrid_tpu_torch.envs import fourrooms, lavagap, lockedroom

    assert (lavagap.MISSION_LAVA, lavagap.MISSION_WALL) == (jlg.MISSION_LAVA, jlg.MISSION_WALL)
    assert (lavagap.MISSION_LAVA, lavagap.MISSION_WALL) == (jcr.MISSION_LAVA, jcr.MISSION_WALL)
    assert fourrooms.MISSION == jfo.MISSION and lockedroom.MISSION == jlr.MISSION


@pytest.mark.parametrize("env_id", IDS)
def test_generator_and_registration_match_jax(env_id):
    jax = pytest.importorskip("jax")  # noqa: F841
    import minigrid_tpu

    env = make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(minigrid_tpu.make(env_id).config)
    assert env.transition == BASE_STEP
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", IDS)
def test_generator_reference_file_matches_jax(env_id):
    fref.assert_port_matches(env_id, fref.jax_states(env_id))


@pytest.mark.parametrize("env_id", ["MiniGrid-LavaCrossingS11N5-v0", "MiniGrid-SimpleCrossingS9N3-v0"])
def test_crossing_rivers_each_keep_one_opening_on_the_path(env_id):
    """Every river is a whole interior row or column of the obstacle but
    for the one opening the path makes in it (an opening lies between the
    other axis's rivers, so a river line lacks exactly one cell, and a
    line that is no river holds at most K obstacle cells): `n` rivers, and
    the obstacle count is their cells less `n` (a cell where two rivers
    cross counts once)."""
    env = make(env_id)
    cfg = env.config
    s = state_to_numpy(env.reset_batch(key(4, device="cpu"), 64)[0])
    obst = C.WALL if cfg.obstacle_type == "wall" else C.LAVA
    inner = s["grid"][:, 1:-1, 1:-1, 0] == obst
    goal = s["grid"][:, cfg.height - 2, cfg.width - 2, 0]
    assert (goal == C.GOAL).all() and (s["agent_pos"] == 1).all() and (s["agent_dir"] == 0).all()
    n_in = cfg.width - 2
    for lane in range(64):
        rows = [y for y in range(n_in) if inner[lane, y].sum() == n_in - 1]
        cols = [x for x in range(n_in) if inner[lane, :, x].sum() == n_in - 1]
        assert len(rows) + len(cols) == cfg.num_crossings, lane
        cells = len(rows) * n_in + len(cols) * n_in - len(rows) * len(cols)
        assert int(inner[lane].sum()) == cells - cfg.num_crossings, lane


def test_lockedroom_key_opens_the_locked_door_and_the_goal_is_behind_it():
    env = make("MiniGrid-LockedRoom-v0")
    s = state_to_numpy(env.reset_batch(key(5, device="cpu"), 64)[0])
    g = s["grid"]
    for lane in range(64):
        doors = np.argwhere(g[lane, :, :, 0] == C.DOOR)
        locked = [d for d in doors if g[lane, d[0], d[1], 2] == C.STATE_LOCKED]
        assert len(doors) == 6 and len(locked) == 1
        assert sorted(g[lane, doors[:, 0], doors[:, 1], 1]) == list(range(6))  # six distinct colours
        ly, lx = locked[0]
        (ky, kx), = np.argwhere(g[lane, :, :, 0] == C.KEY)
        assert g[lane, ky, kx, 1] == g[lane, ly, lx, 1] == s["mission"][lane, 1] == s["mission"][lane, 3]
        (gy, gx), = np.argwhere(g[lane, :, :, 0] == C.GOAL)
        assert gy // 6 == ly // 6 and (gx < 7) == (lx == 7)  # the goal's room is the locked door's
        ax, ay = s["agent_pos"][lane]
        assert 7 < ax < 11


def test_playground_places_twelve_objects_and_no_goal():
    env = make("MiniGrid-Playground-v0")
    s = state_to_numpy(env.reset_batch(key(6, device="cpu"), 64)[0])
    kinds = s["grid"][..., 0]
    assert ((kinds == C.KEY) | (kinds == C.BALL) | (kinds == C.BOX)).sum(axis=(1, 2)).tolist() == [12] * 64
    assert not (kinds == C.GOAL).any() and (kinds == C.DOOR).sum(axis=(1, 2)).tolist() == [12] * 64
    assert (s["mission"] == 0).all()
