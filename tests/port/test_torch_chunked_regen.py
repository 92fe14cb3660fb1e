"""KeyCorridor on the packed rollout, end to end: the port's exact chunked
regen (`ops/chunked_regen.py`) with the pickup-target hook, against the
JAX package's `build_packed_xla_rollout(env, T, mode=..., regen_chunk=c)`
(the way tests/test_fused_rollout.py::test_xla_regen_chunk4 runs it), on
the same numpy states and actions; on a card, the kernel path against the
plain path.

KeyCorridorS3R1, B = 128, two calls of T = 48 steps on the same actions. The states are
doctored as the JAX package's tests doctor them
(`testing.plant_pickup_target`): the agent at (1, 1) facing the ball
planted at (2, 1), hands free, so the hook's success fires. Cases:
  1. regen, chunk 4: successes reset lanes mid-chunk (fresh layouts);
  2. regen, chunk 8, `max_steps` cut to 5 on both sides: lanes end two
     episodes in one chunk, so steps freeze and re-enter
     (`reset_overlaps > 0`);
  3. cached mode with the hook.
Final carries (words, registers, templates, rng chain), `episodes`,
`obs_checksum` and `reset_overlaps` must be byte-exact; `total_reward`
gets rtol 1e-6 for the batch-sum order (ROADMAP.md §C).

JAX is imported only by the tests that compare with it, so the `gpu`
tests also run on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" tests/port/test_torch_chunked_regen.py -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.ops import chunked_regen as tcr
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.ops import gen_kernel as tgk
from minigrid_tpu_torch.testing import plant_pickup_target
from minigrid_tpu_torch.utils.convert import carry_to_numpy, state_from_numpy, state_to_numpy

ENV_ID = "MiniGrid-KeyCorridorS3R1-v0"
B = 128
T = 48
CASES = {"regen-c4": ("regen", 4, None), "regen-c8-max5": ("regen", 8, 5), "cached": ("cached", 4, None)}


def _env(max_steps=None, env_id=ENV_ID):
    env = make(env_id)
    if max_steps is not None:
        env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))
    return env


def _states(env_id=ENV_ID, b=B, seed=5):
    return plant_pickup_target(state_to_numpy(make(env_id).reset_batch(key(seed, device="cpu"), b)[0]))


def _actions(b=B, t=T, seed=0):
    """The `(T, B)` actions of each call (the same for both, so JAX compiles
    one step)."""
    return np.random.default_rng(seed).integers(0, 7, (t, b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_two_calls(case):
    """(carry0, [(carry, metrics)] * 2) of the JAX package, as numpy. In
    cached mode carry0 is JAX's `packed_init` (the pinned template rng
    rows); in regen mode it is the port's, whose templates
    test_torch_keycorridor.py holds against JAX's `generate_packed`, which
    saves a compile of it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import minigrid_tpu
    from minigrid_tpu.core.state import EnvState
    from minigrid_tpu.ops import fused_rollout as jfr

    mode, chunk, max_steps = CASES[case]
    env = minigrid_tpu.make(ENV_ID)
    if max_steps is not None:
        env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))
    if mode == "cached":
        states = EnvState(**{k: jnp.asarray(v) for k, v in _states().items()})
        carry = jax.jit(lambda s: jfr.packed_init(env, s, mode))(states)
    else:
        carry = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(_port_init(case)[1]).items()})
    step = jax.jit(
        jfr.build_packed_xla_rollout(env, T, mode=mode, regen_chunk=chunk, as_carry=True, actions_override=_actions())
    )
    out = [{k: np.asarray(v) for k, v in carry._asdict().items()}]
    for _ in range(2):
        carry, metrics = step(jax.random.PRNGKey(0), carry)
        out.append(({k: np.asarray(v) for k, v in carry._asdict().items()}, metrics))
    return out


def _port_init(case, device="cpu", env_id=ENV_ID, b=B):
    mode, _, max_steps = CASES[case]
    env = _env(max_steps, env_id)
    return env, tfr.packed_init(env, state_from_numpy(_states(env_id, b), device=device), mode)


def _port_two_calls(case, env, carry, build=tfr.build_fused_rollout, t=T):
    """(carry0, [(carry, metrics)] * 2) of the port, the carries as numpy."""
    mode, chunk, _ = CASES[case]
    step = build(env, t, mode=mode, regen_chunk=chunk, as_carry=True, actions_override=_actions(carry.words.shape[1], t))
    out = [carry_to_numpy(carry)]
    for _ in range(2):
        carry, metrics = step(None, carry)
        out.append((carry_to_numpy(carry), metrics))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_regen_matches_jax_packed_xla_rollout(case):
    want = _jax_two_calls(case)
    got = _port_two_calls(case, *_port_init(case))
    for name in want[0]:
        np.testing.assert_array_equal(got[0][name], want[0][name], err_msg=f"packed_init {name}")
    for i in (1, 2):
        (c, m), (jc, jm) = got[i], want[i]
        for name in jc:
            np.testing.assert_array_equal(c[name], jc[name], err_msg=f"call {i} {name}")
        for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
            assert getattr(m, name).dtype == torch.int32, name
            assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
    metrics = [m for _, m in got[1:]]
    assert sum(int(m.episodes) for m in metrics) > 0
    if case == "regen-c4":
        assert float(metrics[0].total_reward) > 0  # the hook's successes
    if case == "regen-c8-max5":
        assert sum(int(m.reset_overlaps) for m in metrics) > 0
        assert tcr.reentry_passes > 0


def test_chunked_regen_leaves_the_carry_passed_in_as_it_was():
    env = _env()
    carry = tfr.packed_init(env, state_from_numpy(_states(), device="cpu"), "regen")
    before = carry_to_numpy(carry)
    step = tfr.build_packed_plain_rollout(env, 8, regen_chunk=4, as_carry=True, actions_override=_actions()[:8])
    step(None, carry)
    for name, leaf in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(leaf, before[name], err_msg=name)


def test_random_layout_regen_needs_a_packed_generator():
    """A random layout without a packed generator (Empty-8x8 with a random
    start) runs chunked regen on the family's batched `generate`, packed,
    as the JAX package's `_pack_rolled(vmap(generate))` route does: the
    plain path against `build_packed_xla_rollout`, two calls at chunk 4,
    byte for byte. A hook the port lacks still raises."""
    jax = pytest.importorskip("jax")
    import minigrid_tpu
    from minigrid_tpu.ops import fused_rollout as jfr

    def random_start(env):
        return dataclasses.replace(env, config=dataclasses.replace(env.config, agent_start_pos=None, max_steps=6))

    env, jenv = random_start(make("MiniGrid-Empty-8x8-v0")), random_start(minigrid_tpu.make("MiniGrid-Empty-8x8-v0"))
    carry = tfr.packed_init(env, env.reset_batch(key(4, device="cpu"), 64)[0], "regen")
    acts = _actions(64, 16)
    jc = jfr.PackedCarry(**carry_to_numpy(carry))
    jstep = jax.jit(jfr.build_packed_xla_rollout(jenv, 16, mode="regen", regen_chunk=4, as_carry=True,
                                                  actions_override=acts))
    step = tfr.build_packed_plain_rollout(env, 16, mode="regen", regen_chunk=4, as_carry=True, actions_override=acts)
    for i in range(2):
        jc, jm = jstep(jax.random.PRNGKey(0), jc)
        carry, m = step(None, carry)
        for name, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
        for name in ("episodes", "obs_checksum", "reset_overlaps"):
            assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
        np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        assert int(m.episodes) > 0
    unported_hook = dataclasses.replace(make(ENV_ID), transition="no_such_transition")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfr.build_fused_rollout(unported_hook, 8, mode="cached")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-KeyCorridorS6R3-v0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_path_matches_plain_path(case, env_id):
    """From one carry on the card: the kernel path (the rollout kernel, and
    the connect kernel in the template refresh) against the plain path
    (`plain_rollout` and the plain generator), byte for byte, reward sums
    bit for bit."""
    dev = _cuda()
    env, carry = _port_init(case, dev, env_id, 1024)
    launches = tfr.rollout_kernel_launches, tgk.connect_kernel_launches
    want = _port_two_calls(case, env, carry, tfr.build_packed_plain_rollout, 32)
    assert (tfr.rollout_kernel_launches, tgk.connect_kernel_launches) == launches
    got = _port_two_calls(case, env, carry, tfr.build_fused_rollout, 32)
    assert tfr.rollout_kernel_launches > launches[0]
    if CASES[case][0] == "regen":
        assert tgk.connect_kernel_launches > launches[1]
    for i in (1, 2):
        (c, m), (pc, pm) = got[i], want[i]
        for name in pc:
            np.testing.assert_array_equal(c[name], pc[name], err_msg=f"call {i} {name}")
        for a, b in zip(m, pm):
            assert torch.equal(a, b)
    assert sum(int(m.episodes) for _, m in got[1:]) > 0
