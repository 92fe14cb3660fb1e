"""The sharded rollouts, policy evaluation and mixed batches of the port
(`parallel/packed.py`, `parallel/mixed.py`) over 8 CPU shards against
the JAX package's over its 8-device CPU mesh (`tests/conftest.py`).

The JAX outputs come from `data/parallel_reference.npz`
(`make_parallel_reference.py`; the `slow` test recomputes them live), so
this file imports no JAX outside that test. Final carries and states and
the integer metrics are held byte for byte, `total_reward` to rtol 1e-6
(the batch-sum order). The rollouts and policy evaluation are per-shard
replays (shard `i` under `fold_in(key, i)` on its 16 lanes), the random
`MixedEnv` batch is the unsharded rollout on the whole batch: both key
rules are checked here against the port's own one-device build functions too.
The `gpu` test holds the kernels' sharded surfaces (two shards of the
card) to the same file."""

import dataclasses
import functools

import make_multiroom_reference as mref
import make_parallel_reference as pref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import fold_in, key
from minigrid_tpu_torch.core.rollout import build_rollout
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.parallel import mixed
from minigrid_tpu_torch.parallel import packed as pk
from minigrid_tpu_torch.parallel.sharding import gather_states, make_env_mesh, shard_states
from minigrid_tpu_torch.utils.convert import carry_from_numpy, state_from_numpy

SURFACE_CASES = sorted(pref.ROLLOUT_CASES) + sorted(pref.POLICY_CASES) + sorted(pref.MIXED_CASES)


@functools.lru_cache(maxsize=None)
def _stored():
    return mref.load(pref.PATH)


@pytest.mark.parametrize("name", SURFACE_CASES)
def test_sharded_surface_matches_jax(name):
    want = pref.case_arrays(name)
    got = pref.port_case(name, _stored())
    # The stored inputs are the port's own carries and states.
    for k, v in pref._inputs(name).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    mref.assert_same_arrays(got, want)
    episodes = [int(v) for k, v in want.items() if k.endswith("/metrics/episodes")]
    assert min(episodes) > 0
    if name.endswith("_auto_regen"):
        assert str(want[f"{name}/backend"]) == "packed"  # the JAX package's pick; the port's is "plain"
        assert pk._pick_backend(make(pref.ROLLOUT_CASES[name][0]), "regen", torch.device("cpu")) == "plain"


@pytest.mark.slow
@pytest.mark.parametrize("name", pref.CASES)
def test_parallel_reference_file_matches_jax(name):
    pytest.importorskip("jax")
    mref.assert_same_arrays(pref.jax_case(name), pref.case_arrays(name))


def _carry(name):
    return carry_from_numpy(pref._stored_inputs(name, _stored()), device="cpu")


@pytest.mark.parametrize("name", ["doorkey5_regen", "policy_empty8_cached"])
def test_each_shard_replays_the_one_device_builder_under_fold_in(name):
    """A sharded rollout is a per-shard replay: shard i equals the
    one-device plain build function on its lanes under `fold_in(key, i)`."""
    env_id, mode, _ = {**pref.ROLLOUT_CASES, **pref.POLICY_CASES}[name]
    env = make(env_id)
    mesh = make_env_mesh(["cpu"] * 4)
    shards = pk.shard_carry(_carry(name), mesh)
    k = key(3, device="cpu")
    if name in pref.ROLLOUT_CASES:
        sharded = pk.build_sharded_rollout(env, 8, mesh, mode=mode, backend="plain", as_carry=True)
        one = tfr.build_packed_plain_rollout(env, 8, mode=mode, as_carry=True)
    else:
        from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_plain_rollout
        from minigrid_tpu_torch.testing import dyadic_flax_params

        params = dyadic_flax_params(1)
        sharded = pk.build_sharded_policy_eval(env, params, 8, mesh, mode=mode, backend="plain", as_carry=True)
        one = build_policy_eval_plain_rollout(env, params, 8, mode=mode, as_carry=True)
    got, total = sharded(k, shards)
    ms = []
    for i, shard in enumerate(shards):
        c, m = one(fold_in(k, i), shard)
        assert all(torch.equal(a, b) for a, b in zip(c, got[i])), i
        ms.append(m)
    for field in ("episodes", "total_steps", "obs_checksum", "reset_overlaps", "total_reward"):
        want = ms[0]._asdict()[field]
        for m in ms[1:]:
            want = want + m._asdict()[field]
        assert torch.equal(getattr(total, field), want), field
    if name in pref.ROLLOUT_CASES:  # ...so the result depends on the shard count
        mesh2 = make_env_mesh(["cpu"] * 2)
        step2 = pk.build_sharded_rollout(env, 8, mesh2, mode=mode, backend="plain", as_carry=True)
        two, _ = step2(k, pk.shard_carry(_carry(name), mesh2))
        assert not torch.equal(pk.gather_carry(two).words, pk.gather_carry(got).words)


def test_states_surface_equals_the_carry_surface():
    env_id, mode, seed = pref.ROLLOUT_CASES["emptyrandom5_regen"]
    env = make(env_id)
    mesh = make_env_mesh(["cpu"] * 8)
    states = state_from_numpy(pref.port_states(env_id, pref.B, seed), device="cpu")
    k = key(4, device="cpu")
    finals, m_states = pk.build_sharded_rollout(env, 8, mesh, mode=mode)(k, shard_states(states, mesh))
    carries = pk.shard_carry(tfr.packed_init(env, states, mode), mesh)
    carries, m_carry = pk.build_sharded_rollout(env, 8, mesh, mode=mode, as_carry=True)(k, carries)
    unpacked = tfr.packed_finish(env, pk.gather_carry(carries))
    for f in dataclasses.fields(unpacked):
        assert torch.equal(getattr(gather_states(finals), f.name), getattr(unpacked, f.name)), f.name
    for a, b in zip(m_states, m_carry):
        assert torch.equal(a, b)


def test_engine_backend_replays_the_per_env_rollout():
    """`backend="engine"` (the JAX package's "vmap"): each shard's
    `core/rollout.py::build_rollout` under `fold_in(key, i)`; the states
    surface only."""
    env = make("MiniGrid-Dynamic-Obstacles-5x5-v0")
    mesh = make_env_mesh(["cpu"] * 4)
    states = state_from_numpy(pref.port_states(env.env_id, 32, 15), device="cpu")
    shards = shard_states(states, mesh)
    k = key(5, device="cpu")
    finals, total = pk.build_sharded_rollout(env, 8, mesh, backend="engine")(k, shards)
    one = build_rollout(env, 8)
    for i, shard in enumerate(shards):
        f, _ = one(fold_in(k, i), shard)
        for field in dataclasses.fields(f):
            assert torch.equal(getattr(f, field.name), getattr(finals[i], field.name)), (i, field.name)
    assert int(total.total_steps) == 32 * 8 and int(total.episodes) > 0
    with pytest.raises(ValueError, match="as_carry needs a packed backend"):
        pk.build_sharded_rollout(env, 8, mesh, backend="engine", as_carry=True)
    with pytest.raises(ValueError, match="unknown backend"):
        pk.build_sharded_rollout(env, 8, mesh, backend="pallas")


def test_mixed_env_rollout_over_the_mesh_is_the_unsharded_rollout():
    """`build_mixed_rollout` over the mesh takes each lane's action of the
    whole batch: its states and integer totals equal the one-device call's."""
    menv = mixed.MixedEnv.create(pref.MIXED_IDS)
    states = state_from_numpy(pref.mixed_env_states(), device="cpu")
    k = key(6, device="cpu")
    mesh = make_env_mesh(["cpu"] * 4)
    finals, m_mesh = mixed.build_mixed_rollout(menv, 8, mesh=mesh)(k, shard_states(states, mesh))
    final, m_one = mixed.build_mixed_rollout(menv, 8)(k, states)
    got = gather_states(finals)
    for f in dataclasses.fields(final):
        assert torch.equal(getattr(got, f.name), getattr(final, f.name)), f.name
    for field in ("episodes", "total_steps", "obs_checksum"):
        assert torch.equal(getattr(m_mesh, field), getattr(m_one, field)), field
    torch.testing.assert_close(m_mesh.total_reward, m_one.total_reward, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SURFACE_CASES)
def test_cuda_sharded_surface_matches_jax(name):
    """The kernels' sharded surfaces, the file's 8 shards on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from minigrid_tpu_torch.ops import policy_rollout as tpr

    launches = tfr.rollout_kernel_launches + tpr.policy_kernel_launches
    got = pref.port_case(name, _stored(), device="cuda", plain=False)
    mref.assert_same_arrays(got, pref.case_arrays(name))
    if not name.startswith("mixed_env"):
        assert tfr.rollout_kernel_launches + tpr.policy_kernel_launches > launches
