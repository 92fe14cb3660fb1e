"""Empty-Random and DoorKey, the families without a packed generator whose
regen mode runs chunked regen on the batched `generate` (the JAX package's
`_pack_rolled(vmap(generate))` route), in the port against the JAX package
on the CPU:

  * each generator byte for byte per registered id, against
    `jax.vmap(generate)` (B = 32) as `make_family_reference.py` stored it
    in `data/family_generators_b32.npz` (the `slow` test recomputes it
    live), with its configuration;
  * `packed_generator` of a family without a packed generator is its
    `generate`, packed and agent-centred;
  * DoorKey-5x5 regen at chunks 4 and 8 with `max_steps` cut to 5 (at
    chunk 8 lanes end two episodes in a chunk, so resets are deferred), and
    Empty-Random-6x6 regen at chunk 8, two calls of T = 16 from the same
    carry and actions, against `build_packed_xla_rollout`: carries,
    `episodes`, `obs_checksum` and `reset_overlaps` byte-exact,
    `total_reward` to rtol 1e-6 (ROADMAP.md §C).

DoorKey-5x5's train step in regen mode: test_torch_train_regen.py.
"""

import dataclasses

import make_family_reference as fref
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import minigrid_tpu  # noqa: E402
from minigrid_tpu.ops import fused_rollout as jfr  # noqa: E402
from minigrid_tpu_torch import env_list, make  # noqa: E402
from minigrid_tpu_torch.core.prng import key, split  # noqa: E402
from minigrid_tpu_torch.ops import fused_rollout as tfr  # noqa: E402
from minigrid_tpu_torch.ops import packed_gen  # noqa: E402
from minigrid_tpu_torch.utils.convert import carry_to_numpy  # noqa: E402

IDS = fref.DOORKEY_IDS
B = 64
T = 16


@pytest.mark.parametrize("env_id", IDS)
def test_generator_matches_jax_vmap_generate(env_id):
    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(jenv.config)
    assert env.transition == "base"
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", IDS)
def test_generator_reference_file_matches_jax(env_id):
    fref.assert_port_matches(env_id, fref.jax_states(env_id))


def test_packed_generator_packs_the_batched_generate():
    assert IDS == [e for e in env_list if e.startswith(("MiniGrid-Empty-Random-", "MiniGrid-DoorKey-"))]
    env = make("MiniGrid-DoorKey-8x8-v0")
    assert packed_gen.get_packed_generator(env) is None
    keys = split(key(2, device="cpu"), 16)
    words, regs = packed_gen.packed_generator(env)(keys, env.config, plain=True)
    want_w, want_r = tfr._pack_rolled(env.config, env.generate(keys, env.config))
    assert torch.equal(words, want_w) and torch.equal(regs, want_r)
    assert words.is_contiguous()


@pytest.mark.parametrize("env_id,chunk,max_steps", [
    ("MiniGrid-DoorKey-5x5-v0", 4, 5), ("MiniGrid-DoorKey-5x5-v0", 8, 5), ("MiniGrid-Empty-Random-6x6-v0", 8, None),
])
def test_regen_matches_jax_packed_xla_rollout(env_id, chunk, max_steps):
    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    if max_steps is not None:
        env, jenv = (dataclasses.replace(e, config=dataclasses.replace(e.config, max_steps=max_steps))
                     for e in (env, jenv))
    acts = np.random.default_rng(chunk).integers(0, 7, (T, B)).astype(np.int32)
    carry = tfr.packed_init(env, env.reset_batch(key(8, device="cpu"), B)[0], "regen")
    step = tfr.build_packed_plain_rollout(env, T, mode="regen", regen_chunk=chunk, as_carry=True,
                                          actions_override=acts)
    jstep = jax.jit(jfr.build_packed_xla_rollout(jenv, T, mode="regen", regen_chunk=chunk, as_carry=True,
                                                 actions_override=acts))
    jc = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(carry).items()})
    metrics = []
    for i in range(2):
        carry, m = step(None, carry)
        jc, jm = jstep(jax.random.PRNGKey(0), jc)
        for name, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
        for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
            assert getattr(m, name).dtype == torch.int32, name
            assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        metrics.append(m)
    assert sum(int(m.episodes) for m in metrics) > 0
    if max_steps is not None and chunk > max_steps:
        assert sum(int(m.reset_overlaps) for m in metrics) > 0
