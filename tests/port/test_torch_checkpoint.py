"""Checkpoint round trips (`utils/checkpoint.py`) and the profiler
(`tools/profile.py`), on the CPU. This file imports no JAX.

The save must be exact: every leaf byte for byte (f32 bit for bit), the
structure checked on load, and a restored state, carry or shard stepping
exactly as the one that never left memory. Mirrors the JAX package's
`tests/test_checkpoint.py`; the orbax pair's counterpart saves the shards
of a CPU mesh.
"""

import dataclasses
import json
import os

import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.rollout import build_rollout
from minigrid_tpu_torch.ops.fused_rollout import PackedCarry, build_fused_rollout, packed_init
from minigrid_tpu_torch.parallel import sharding
from minigrid_tpu_torch.parallel.packed import shard_carry
from minigrid_tpu_torch.parallel.train import flatten_params, init_train_state
from minigrid_tpu_torch.utils.checkpoint import load_pytree, load_sharded, save_pytree, save_sharded, structure

CPU = torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for x in tree for t in _leaves(x)]


def _assert_equal(a, b):
    assert structure(a) == structure(b)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def test_env_state_batch_round_trip(tmp_path):
    env = make("MiniGrid-DoorKey-5x5-v0")
    states, _ = env.reset_batch(key(0, device=CPU), 16)
    rollout = build_rollout(env, 7)
    states, _ = rollout(key(1, device=CPU), states)
    path = str(tmp_path / "env_state.pt")
    save_pytree(path, states)
    restored = load_pytree(path, states, device=CPU)
    _assert_equal(states, restored)
    s1, m1 = rollout(key(2, device=CPU), restored)
    s2, m2 = rollout(key(2, device=CPU), states)
    _assert_equal(s1, s2)
    assert float(m1.total_reward) == float(m2.total_reward) and int(m1.episodes) == int(m2.episodes)


def test_restored_state_steps_identically(tmp_path):
    env = make("MiniGrid-Empty-8x8-v0")
    state, _ = env.reset(key(8, device=CPU))
    path = str(tmp_path / "single.pt")
    save_pytree(path, state)
    restored = load_pytree(path, state, device=CPU)
    a = torch.tensor([2], dtype=torch.int32)
    _assert_equal(env.step(state, a)[0], env.step(restored, a)[0])


def test_packed_carry_round_trip_steps_identically(tmp_path):
    env = make("MiniGrid-DoorKey-5x5-v0")
    carry = packed_init(env, env.reset_batch(key(4, device=CPU), 64)[0], "regen")
    step = build_fused_rollout(env, 16, mode="regen", as_carry=True, regen_chunk=8)
    carry, _ = step(key(5, device=CPU), carry)
    path = str(tmp_path / "carry.pt")
    save_pytree(path, carry)
    restored = load_pytree(path, carry, device=CPU)
    assert isinstance(restored, PackedCarry)
    _assert_equal(carry, restored)
    (c1, m1), (c2, m2) = step(key(6, device=CPU), carry), step(key(6, device=CPU), restored)
    _assert_equal(c1, c2)
    _assert_equal(tuple(m1), tuple(m2))


def test_train_state_round_trip(tmp_path):
    env = make("MiniGrid-Empty-5x5-v0")
    ts = init_train_state(env, generator=torch.Generator().manual_seed(3))
    ts = ts._replace(opt_state=ts.opt_state._replace(mu=torch.randn(ts.opt_state.mu.shape), count=ts.opt_state.count + 2))
    path = str(tmp_path / "train_state.pt")
    save_pytree(path, ts)
    like = init_train_state(env, device=CPU)
    restored = load_pytree(path, like, device=CPU)
    _assert_equal(ts, restored)
    assert restored.params is not like.params
    assert torch.equal(flatten_params(restored.params.flax_params()), flatten_params(ts.params.flax_params()))
    assert int(restored.opt_state.count) == 2


def test_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "tree.pt")
    save_pytree(path, {"a": torch.arange(3), "b": torch.arange(4)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, {"a": torch.arange(3), "c": torch.arange(4)}, device=CPU)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, [torch.arange(3), torch.arange(4)], device=CPU)
    env = make("MiniGrid-Empty-5x5-v0")
    state, _ = env.reset(key(0, device=CPU))
    save_pytree(path, state)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, packed_init(env, state, "cached"), device=CPU)
    # The same structure loads whatever the leaves' values.
    save_pytree(path, {"a": torch.arange(3), "b": torch.arange(4)})
    out = load_pytree(path, {"b": torch.zeros(4), "a": torch.zeros(3)}, device=CPU)
    assert torch.equal(out["a"], torch.arange(3)) and list(out) == ["b", "a"]
    # What `torch.load(weights_only=True)` reads: tensors, strings, lists.
    assert set(torch.load(path, weights_only=True)) == {"structure", "leaves"}


def test_shards_of_a_cpu_mesh_round_trip_and_step_identically(tmp_path):
    env = make("MiniGrid-Empty-8x8-v0")
    mesh = sharding.make_env_mesh([CPU] * 2)
    carry = packed_init(env, env.reset_batch(key(4, device=CPU), 128)[0], "cached")
    shards = shard_carry(carry, mesh)
    step = build_fused_rollout(env, 16, mode="cached", as_carry=True)
    shards = tuple(step(key(5 + i, device=CPU), s)[0] for i, s in enumerate(shards))
    path = str(tmp_path / "carry_shards")
    save_sharded(path, shards)
    restored = load_sharded(path, shards)
    assert len(restored) == 2 and sorted(os.listdir(path)) == ["shard_0.pt", "shard_1.pt"]
    for s, r in zip(shards, restored):
        _assert_equal(s, r)
        _assert_equal(step(key(7, device=CPU), s)[0], step(key(7, device=CPU), r)[0])
    with pytest.raises(ValueError, match="2 shards"):
        load_sharded(path, shards[:1])


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "t.pt")
    save_pytree(path, {"a": torch.arange(3)})
    if torch.cuda.is_available():
        assert load_pytree(path, {"a": torch.arange(3)})["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pytree(path, {"a": torch.arange(3)})


def test_profile_trace_annotate_and_timing(tmp_path):
    """`trace` on the host writes a Chrome trace holding the annotated
    region; `timed_steps_per_sec` measures a callable."""
    from minigrid_tpu_torch.tools import profile

    env = make("MiniGrid-Empty-5x5-v0")
    states, _ = env.reset_batch(key(0, device=CPU), 8)
    with profile.trace(str(tmp_path), device=CPU):
        with profile.annotate("mg_rollout_region"):
            build_rollout(env, 2)(key(1, device=CPU), states)
    with open(tmp_path / profile.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mg_rollout_region" in names
    rate = profile.timed_steps_per_sec(env.step, states, torch.zeros(8, dtype=torch.int32), steps_per_call=8, iters=2)
    assert rate > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profile.trace(str(tmp_path)):
                pass


@pytest.mark.gpu
def test_round_trip_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = make("MiniGrid-DoorKey-8x8-v0")
    carry = packed_init(env, env.reset_batch(key(0), 4096)[0], "regen")
    path = str(tmp_path / "carry.pt")
    save_pytree(path, carry)
    restored = load_pytree(path, carry)
    assert restored.words.is_cuda
    _assert_equal(carry, restored)
    step = build_fused_rollout(env, 16, mode="regen", as_carry=True, regen_chunk=8)
    _assert_equal(step(key(1), carry)[0], step(key(1), restored)[0])
