"""Heterogeneous env batches on one device: one homogeneous lane block per
member env, each stepped by its own packed rollout, metrics summed
(counterpart of `build_packed_mixed_rollout` and `build_mixed_policy_eval`
in `minigrid_tpu/parallel/mixed.py`, without a mesh).

This is BASELINE.md's config 5 (a LavaCrossing + FourRooms batch): the
member proportions are fixed when the surface is built, and every member
block pays exactly one homogeneous step. Member `i` draws from
`fold_in(key, i)`, as in the JAX package, and the totals are summed in
member order. Each member's block runs in its kernel for CUDA carries and
in the plain twin for CPU carries; the `*_plain` builders run the plain
twins on any device.

`MixedEnv` and `build_mixed_rollout` (one padded batch stepped through
`lax.switch`) need the per-env step and observation engine, which is not
ported yet; nor is the sharded form (the JAX builders' `mesh`). See
ROADMAP.md.
"""

from __future__ import annotations

from typing import Sequence

import torch

from minigrid_tpu_torch.core.prng import fold_in
from minigrid_tpu_torch.core.rollout import RolloutMetrics
from minigrid_tpu_torch.envs.registry import make
from minigrid_tpu_torch.ops.chunked_regen import _no_mark
from minigrid_tpu_torch.ops.fused_rollout import build_fused_rollout, build_packed_plain_rollout
from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_plain_rollout, build_policy_eval_rollout


def _sum_metrics(total: RolloutMetrics, m: RolloutMetrics) -> RolloutMetrics:
    """Two calls' totals added field by field; int32 sums wrap, as the JAX
    package's do."""
    return RolloutMetrics(*(a + b for a, b in zip(total, m)))


def _mixed_step(env_ids: Sequence[str], inners):
    """`step(key, members, mark=_no_mark) -> (members, RolloutMetrics)`:
    member `i` steps under `fold_in(key, i)`. `mark(piece)` reaches each
    member's call, which marks its own pieces, and is called after it with
    the piece "member <i>", so a profiler can time the members and their
    pieces in place."""

    def step(key: torch.Tensor, members, mark=_no_mark):
        if len(members) != len(inners):
            raise ValueError(f"{len(members)} member blocks for {len(inners)} members {tuple(env_ids)}")
        finals, total = [], None
        for i, (inner, member) in enumerate(zip(inners, members)):
            f, m = inner(fold_in(key, i), member, mark=mark)
            finals.append(f)
            total = m if total is None else _sum_metrics(total, m)
            mark(f"member {i}")
        return tuple(finals), total

    return step


def _packed_mixed(env_ids, num_steps, mode, as_carry, build):
    inners = [build(make(e), num_steps, mode=mode, as_carry=as_carry) for e in env_ids]
    return _mixed_step(env_ids, inners)


def build_packed_mixed_rollout(
    env_ids: Sequence[str],
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
):
    """The random policy over a mixed batch: `rollout(key, states_tuple) ->
    (states_tuple, RolloutMetrics)` over one batched `EnvState` per member
    (each member's `reset_batch`), or with `as_carry=True` the steady
    surface `step(key, carries) -> (carries, RolloutMetrics)` over one
    `PackedCarry` per member (`packed_init`; `packed_finish` unpacks).
    Member `i` is `build_fused_rollout(make(env_ids[i]), ...)` driven by
    the key `fold_in(key, i)`: the JAX package's random-policy actions."""
    return _packed_mixed(env_ids, num_steps, mode, as_carry, build_fused_rollout)


def build_packed_mixed_plain_rollout(
    env_ids: Sequence[str],
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
):
    """`build_packed_mixed_rollout` on the plain twins
    (`build_packed_plain_rollout`), on any device."""
    return _packed_mixed(env_ids, num_steps, mode, as_carry, build_packed_plain_rollout)


def _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, build):
    if len(params_list) != len(env_ids):
        raise ValueError(f"{len(params_list)} params for {len(env_ids)} members: one per member")
    inners = [
        build(make(e), p, num_steps, mode=mode, as_carry=True, regen_chunk=regen_chunk)
        for e, p in zip(env_ids, params_list)
    ]
    return _mixed_step(env_ids, inners)


def build_mixed_policy_eval(
    env_ids: Sequence[str],
    params_list: Sequence,
    num_steps: int,
    mode: str = "cached",
    regen_chunk: int = 32,
):
    """Policy-in-the-loop evaluation over a mixed batch, each member with its
    own actor-critic (`params_list[i]`: an `ActorCritic`, or a flax params
    tree of numpy arrays as `build_policy_eval_rollout` takes it). Carry
    form only: `step(key, carries) -> (carries, RolloutMetrics)` over one
    `PackedCarry` per member; member `i` is `build_policy_eval_rollout(...,
    as_carry=True)` under `fold_in(key, i)`."""
    return _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, build_policy_eval_rollout)


def build_mixed_policy_eval_plain(
    env_ids: Sequence[str],
    params_list: Sequence,
    num_steps: int,
    mode: str = "cached",
    regen_chunk: int = 32,
):
    """`build_mixed_policy_eval` on the plain twins
    (`build_policy_eval_plain_rollout`), on any device."""
    return _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, build_policy_eval_plain_rollout)
