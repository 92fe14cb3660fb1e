"""Every env id the JAX package registers, against the port's registry and
the rollout kernel's limits: the configuration carries across unchanged,
the kernel takes its grid and view, the offset tables agree, and `make`
returns that configuration (all 70 ids are ported); on every id and both
auto-reset modes, `fused_rollout_supported` is the JAX package's; and on
every cell of `tests/test_support_matrix.py`'s `FAMILY_REPS` (all 22
families), both modes and all three surfaces, the port's support
predicates are the JAX package's, and all true."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import minigrid_tpu
from minigrid_tpu.envs.registry import env_list as jax_env_list
from minigrid_tpu.ops import packing as jpk
from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs.base import STEP_FNS
from minigrid_tpu_torch.ops import packing as tpk
from minigrid_tpu_torch.ops.fused_rollout import fused_rollout_supported, kernel_lane_block


def test_ported_ids_keep_the_jax_registration_order():
    assert env_list == [e for e in jax_env_list if e in env_list]
    # Empty (4), Empty-Random (2), DistShift (2), LavaGap (3), FourRooms,
    # DoorKey (4), LavaCrossing (4), SimpleCrossing (4), DynamicObstacles
    # (6), Memory (6), Fetch (3), GoToDoor (3), GoToObject (2), PutNear
    # (2), RedBlueDoors (2), MultiRoom (3), LockedRoom, Playground, Unlock,
    # UnlockPickup, BlockedUnlockPickup, KeyCorridor (6), ObstructedMaze (8).
    assert len(env_list) == 70
    assert env_list == jax_env_list


@pytest.mark.parametrize("mode", ["cached", "regen"])
@pytest.mark.parametrize("env_id", env_list)
def test_fused_rollout_supported_matches_jax(env_id, mode):
    from minigrid_tpu.ops import fused_rollout as jfr

    want = jfr.fused_rollout_supported(minigrid_tpu.make(env_id), mode=mode)
    assert fused_rollout_supported(make(env_id), mode) == want


@pytest.mark.parametrize("env_id", jax_env_list)
def test_every_jax_id_carries_across(env_id):
    jcfg = minigrid_tpu.make(env_id).config
    cfg = EnvConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert kernel_lane_block(cfg) in (128, 64, 32)
    dims = (cfg.width, cfg.height, cfg.agent_view_size)
    for got, want in zip(tpk._dir_tables(*dims), jpk._dir_tables(*dims)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert make(env_id).config == cfg
    assert make(env_id).transition in STEP_FNS


def _family_reps():
    """`FAMILY_REPS` of tests/test_support_matrix.py, read without importing
    that module."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "test_support_matrix.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "FAMILY_REPS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("FAMILY_REPS not found")


PORTED_REPS = [e for e in _family_reps() if e in env_list]


def test_twenty_one_of_the_support_matrix_families_are_ported():
    """All 22 of them, now: the name stays, as its count does."""
    assert len(_family_reps()) == 22 and PORTED_REPS == _family_reps()
    assert "MiniGrid-ObstructedMaze-1Dl-v0" in PORTED_REPS


@pytest.mark.parametrize("surface", ["fused", "eval", "collect"])
@pytest.mark.parametrize("mode", ["cached", "regen"])
@pytest.mark.parametrize("env_id", PORTED_REPS)
def test_support_matrix_cell_matches_jax(env_id, mode, surface):
    from minigrid_tpu.ops import fused_rollout as jfr
    from minigrid_tpu.ops import policy_rollout as jpr
    from minigrid_tpu_torch.ops import policy_rollout as tpr

    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    if surface == "fused":
        got, want = fused_rollout_supported(env, mode), jfr.fused_rollout_supported(jenv, mode=mode)
    else:
        collect = surface == "collect"
        got = tpr.policy_rollout_supported(env, mode, collect=collect)
        want = jpr.policy_rollout_supported(jenv, mode, collect=collect)
    assert got == want is True
