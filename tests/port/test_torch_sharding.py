"""The port's meshes and sharded values (`parallel/sharding.py`,
`parallel/packed.py::shard_carry`): the mesh shapes of the JAX package's
`make_env_mesh` over its 8 CPU devices, no mesh without a card by
default, and every split and join byte for byte. This file imports no
JAX outside the test that reads the JAX package's mesh."""

import dataclasses

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.models.policy import ActorCritic
from minigrid_tpu_torch.ops.fused_rollout import packed_init
from minigrid_tpu_torch.parallel import sharding
from minigrid_tpu_torch.parallel.packed import gather_carry, shard_carry

CPU8 = ["cpu"] * 8


def test_mesh_shapes_match_the_jax_package():
    jax = pytest.importorskip("jax")
    from minigrid_tpu.parallel.sharding import make_env_mesh as jax_mesh

    assert jax.device_count() == 8
    for mp in (1, 2):
        mesh = sharding.make_env_mesh(CPU8, model_parallel=mp)
        assert mesh.shape == jax_mesh(model_parallel=mp).devices.shape == (8 // mp, mp)
        assert mesh.axis_names == (sharding.ENV_AXIS, sharding.MODEL_AXIS) == ("env", "model")
        assert mesh.n_env == mesh.n_global == 8 // mp and mesh.shard_offset == 0
        assert mesh.shard_devices == (torch.device("cpu"),) * (8 // mp)
        assert mesh.distinct_devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="model_parallel=3"):
        sharding.make_env_mesh(CPU8, model_parallel=3)


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        assert sharding.make_env_mesh().shard_devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_env_mesh()


def _states(env_id, b, seed):
    return make(env_id).reset_batch(key(seed, device="cpu"), b)[0]


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-8x8-v0", "MiniGrid-DoorKey-5x5-v0"])
def test_states_shard_and_gather_back_byte_for_byte(env_id):
    states = _states(env_id, 64, 3)
    mesh = sharding.make_env_mesh(CPU8)
    shards = sharding.shard_states(states, mesh)
    assert len(shards) == 8
    for i, s in enumerate(shards):
        for f in dataclasses.fields(states):
            assert torch.equal(getattr(s, f.name), getattr(states, f.name)[8 * i : 8 * (i + 1)]), f.name
    back = sharding.gather_states(shards)
    for f in dataclasses.fields(states):
        assert torch.equal(getattr(back, f.name), getattr(states, f.name)), f.name
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_states(_states(env_id, 12, 3), mesh)


@pytest.mark.parametrize("mode", ["cached", "regen"])
def test_carry_shards_and_gathers_back_byte_for_byte(mode):
    env = make("MiniGrid-DoorKey-5x5-v0")
    carry = packed_init(env, _states("MiniGrid-DoorKey-5x5-v0", 64, 4), mode)
    mesh = sharding.make_env_mesh(["cpu"] * 4)
    shards = shard_carry(carry, mesh)
    for i, s in enumerate(shards):
        lanes = slice(16 * i, 16 * (i + 1))
        for name in ("words", "regs", "tmpl_words", "tmpl_regs"):
            assert torch.equal(getattr(s, name), getattr(carry, name)[:, lanes]), name
            assert getattr(s, name).is_contiguous()
        assert torch.equal(s.rng, carry.rng[lanes])  # batch-major
    for a, b in zip(gather_carry(shards), carry):
        assert torch.equal(a, b)


def test_replicated_keeps_one_copy_per_device():
    mesh = sharding.make_env_mesh(["cpu"] * 3)
    model = ActorCritic(7, device="cpu")
    copies = sharding.replicated({"m": model, "t": (torch.ones(2), np.zeros(1))}, mesh)
    assert len(copies) == 3 and all(c["m"] is model for c in copies)
    assert all(torch.equal(c["t"][0], torch.ones(2)) for c in copies)


def test_map_shards_runs_every_shard_in_order():
    mesh = sharding.make_env_mesh(["cpu"] * 5)
    seen = []
    assert sharding.map_shards(mesh, lambda i: seen.append(i) or i * i) == [0, 1, 4, 9, 16]
    assert seen == [0, 1, 2, 3, 4]
