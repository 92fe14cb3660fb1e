"""The mixed batch (`parallel/mixed.py`, BASELINE.md's config 5 at test
size: LavaCrossingS9N1 + FourRooms, 64 lanes a member) against the JAX
package's `build_packed_mixed_rollout` (cached and regen) and
`build_mixed_policy_eval` (regen, dyadic weights through
`ActorCritic.from_flax`), both `backend="xla"`, four calls of T = 32 each:
the member carries and the integer metrics byte for byte, `total_reward`
to rtol 1e-6 (the batch-sum order). The JAX outputs come from
`data/mixed_reference.npz` (`make_mixed_reference.py`; the `slow` test
recomputes them live), so this file imports no JAX outside that test, and
its `gpu` test holds the kernels' mixed surfaces to the same file on a
card."""

import dataclasses

import make_mixed_reference as mx
import make_multiroom_reference as mref
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import fold_in, key
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.parallel import mixed
from minigrid_tpu_torch.testing import dyadic_flax_params
from minigrid_tpu_torch.utils.convert import carry_to_numpy


@pytest.mark.parametrize("name", sorted(mx.CASES))
def test_mixed_surface_matches_jax(name):
    _, mode = mx.CASES[name]
    want = mx.case_arrays(name)
    for i, carry in enumerate(mx.port_carries(mode)):  # the port's own packed_init carries
        for field, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, want[f"{name}/in/{i}/{field}"], err_msg=f"member {i} {field}")
    got = mx.port_case(name)
    mref.assert_same_arrays(got, want)
    episodes = [int(want[f"{name}/call{c}/metrics/episodes"]) for c in range(mx.CALLS)]
    assert min(episodes) > 0 and episodes[-1] > mx.B  # FourRooms truncates every lane in the last call
    if mode == "regen":
        assert sum(int(want[f"{name}/call{c}/metrics/reset_overlaps"]) for c in range(mx.CALLS)) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(mx.CASES))
def test_mixed_reference_file_matches_jax(name):
    pytest.importorskip("jax")
    mref.assert_same_arrays(mx.jax_case(name), mx.case_arrays(name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(mx.CASES))
def test_cuda_mixed_surface_matches_jax(name):
    """The kernels' mixed surfaces on the card against the same file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = tfr.rollout_kernel_launches
    got = mx.port_case(name, plain=False, device="cuda")
    mref.assert_same_arrays(got, mx.case_arrays(name))
    if mx.CASES[name][0] == "random":
        assert tfr.rollout_kernel_launches > launches


def test_members_step_under_fold_in_and_the_metrics_add_up():
    """A mixed call is its members' calls, member i under `fold_in(key, i)`,
    with the totals summed in member order (cached, 32 lanes, T = 8)."""
    carries = tuple(mref.port_carry(e, 32, s, mode="cached") for e, s in zip(mx.IDS, mx.CARRY_SEEDS))
    k = key(9, device="cpu")
    got, total = mixed.build_packed_mixed_plain_rollout(mx.IDS, 8, mode="cached", as_carry=True)(k, carries)
    metrics = []
    for i, (env_id, carry) in enumerate(zip(mx.IDS, carries)):
        step = tfr.build_packed_plain_rollout(make(env_id), 8, mode="cached", as_carry=True)
        c, m = step(fold_in(k, i), carry)
        for a, b in zip(c, got[i]):
            assert torch.equal(a, b)
        metrics.append(m)
    for field in ("episodes", "total_steps", "obs_checksum", "reset_overlaps", "total_reward"):
        assert torch.equal(getattr(total, field), getattr(metrics[0], field) + getattr(metrics[1], field)), field
    assert int(total.total_steps) == 2 * 32 * 8


def test_state_surface_resets_packs_and_unpacks_each_member():
    """`as_carry=False`: one batched `EnvState` per member in and out, the
    same finals as the carry surface's, unpacked."""
    states = tuple(make(e).reset_batch(key(s, device="cpu"), 32)[0] for e, s in zip(mx.IDS, mx.CARRY_SEEDS))
    k = key(2, device="cpu")
    finals, total = mixed.build_packed_mixed_plain_rollout(mx.IDS, 8, mode="regen")(k, states)
    carries = tuple(tfr.packed_init(make(e), st, "regen") for e, st in zip(mx.IDS, states))
    want, want_total = mixed.build_packed_mixed_plain_rollout(mx.IDS, 8, mode="regen", as_carry=True)(k, carries)
    for env_id, final, carry in zip(mx.IDS, finals, want):
        unpacked = tfr.packed_finish(make(env_id), carry)
        for field in dataclasses.fields(final):
            assert torch.equal(getattr(final, field.name), getattr(unpacked, field.name)), field.name
    for a, b in zip(total, want_total):
        assert torch.equal(a, b)


def test_mixed_builders_refuse_a_wrong_roster():
    with pytest.raises(ValueError, match="one per member"):
        mixed.build_mixed_policy_eval(mx.IDS, [dyadic_flax_params(0)], 8)
    step = mixed.build_packed_mixed_plain_rollout(mx.IDS, 8, mode="cached", as_carry=True)
    carry = mref.port_carry(mx.IDS[0], 32, 0, mode="cached")
    with pytest.raises(ValueError, match="member blocks"):
        step(key(0, device="cpu"), (carry,))
