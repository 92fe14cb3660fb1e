"""Every env id the JAX package registers, against the port's registry and
the rollout kernel's limits: the configuration carries across unchanged,
the kernel takes its grid and view, the offset tables agree, and `make`
either returns that configuration or names ROADMAP.md."""

import dataclasses

import numpy as np
import pytest

import minigrid_tpu
from minigrid_tpu.envs.registry import env_list as jax_env_list
from minigrid_tpu.ops import packing as jpk
from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import packing as tpk
from minigrid_tpu_torch.ops.fused_rollout import kernel_lane_block


def test_ported_ids_keep_the_jax_registration_order():
    assert env_list == [e for e in jax_env_list if e in env_list]
    assert len(env_list) == 15  # Empty (4), DistShift (2), KeyCorridor (6), MultiRoom (3)


@pytest.mark.parametrize("env_id", jax_env_list)
def test_every_jax_id_carries_across(env_id):
    jcfg = minigrid_tpu.make(env_id).config
    cfg = EnvConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert kernel_lane_block(cfg) in (128, 64, 32)
    dims = (cfg.width, cfg.height, cfg.agent_view_size)
    for got, want in zip(tpk._dir_tables(*dims), jpk._dir_tables(*dims)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if env_id in env_list:
        assert make(env_id).config == cfg
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make(env_id)
