"""Heterogeneous env batches, on one device or over a mesh (counterpart
of `minigrid_tpu/parallel/mixed.py`).

`MixedEnv` and `build_mixed_rollout` step one batch of lanes of several
member envs through the per-env engine: each grid is padded to the
largest member's size with walls, each lane's member index rides in
`aux[FAMILY_SLOT]`, and reset, step and observe run each member's own
functions on its lanes (where the JAX package's `lax.switch` under `vmap`
computes every member on every lane and selects).

`build_packed_mixed_rollout` and `build_mixed_policy_eval` give each
member env a homogeneous lane block of its own, each stepped by its own
packed rollout, metrics summed.

This is BASELINE.md's config 5 (a LavaCrossing + FourRooms batch): the
member proportions are fixed when the surface is built, and every member
block pays exactly one homogeneous step. Member `i` draws from
`fold_in(key, i)`, as in the JAX package, and the totals are summed in
member order. Each member's block runs in its kernel for CUDA carries and
in the plain twin for CPU carries; the `*_plain` builders run the plain
twins on any device.

With a mesh (`parallel/sharding.py`), `build_mixed_rollout` is, as the
JAX package's `jax.jit` with shardings, the unsharded rollout on the whole
batch: each shard steps its lanes with the actions those lanes draw in
the whole batch. The packed build functions run each member through
`parallel/packed.py`'s per-shard replay (`build_sharded_rollout`,
`build_sharded_policy_eval`) under `fold_in(key, i)`, as the JAX package
does (`mixed.py:236-241`, `:311-316`): a member's value is then a sharded
one, a tuple of per-shard states or carries.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.autoreset import put_lanes, reset_finished, take_lanes
from minigrid_tpu_torch.core.obs import gen_obs
from minigrid_tpu_torch.core.rollout import random_policy, run_rollout
from minigrid_tpu_torch.core.state import AUX_LEN, EnvState
from minigrid_tpu_torch.core.step import StepResult, as_actions
from minigrid_tpu_torch.envs.base import Env, step_fn
from minigrid_tpu_torch.envs.registry import make
from minigrid_tpu_torch.ops.chunked_regen import _no_mark
from minigrid_tpu_torch.ops.fused_rollout import build_fused_rollout, build_packed_plain_rollout
from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_plain_rollout, build_policy_eval_rollout
from minigrid_tpu_torch.parallel.packed import build_sharded_policy_eval, build_sharded_rollout, sum_metrics
from minigrid_tpu_torch.parallel import sharding


# The aux slot that holds a lane's member index (families use low slots).
FAMILY_SLOT = AUX_LEN - 1


@dataclasses.dataclass(frozen=True)
class MixedEnv:
    """A fixed roster of member envs stepped as one batch of lanes."""

    env_ids: Tuple[str, ...]
    members: Tuple[Env, ...]
    height: int
    width: int
    agent_view_size: int
    num_actions: int

    @staticmethod
    def create(env_ids: Sequence[str]) -> "MixedEnv":
        members = tuple(make(e) for e in env_ids)
        views = {m.config.agent_view_size for m in members}
        if len(views) != 1:
            raise ValueError(f"members must share agent_view_size, got {sorted(views)}")
        return MixedEnv(
            env_ids=tuple(env_ids),
            members=members,
            height=max(m.config.height for m in members),
            width=max(m.config.width for m in members),
            agent_view_size=views.pop(),
            num_actions=max(m.config.num_actions for m in members),
        )

    # ------------------------------------------------------------ internals
    def _pad_state(self, state: EnvState, member_idx: int) -> EnvState:
        """A member's states on the padded canvas (walls around them), the
        member index in `aux[FAMILY_SLOT]`."""
        b, h, w = state.grid.shape[:3]
        wall = torch.tensor((C.WALL, C.GREY, 0, 0, 0), dtype=torch.uint8, device=state.grid.device)
        grid = wall.expand(b, self.height, self.width, 5).clone()
        grid[:, :h, :w] = state.grid
        aux = state.aux.clone()
        aux[:, FAMILY_SLOT] = member_idx
        return state.replace(grid=grid, aux=aux)

    def _branch_config(self, member: Env):
        """A member's configuration at the padded size (its own
        `max_steps`, `see_through_walls` and `num_actions`)."""
        return dataclasses.replace(member.config, width=self.width, height=self.height)

    def _per_member(self, member_ids: torch.Tensor, fn):
        """`fn(i, lanes)` for each member `i` with lanes in `member_ids`."""
        for i in range(len(self.members)):
            lanes = (member_ids == i).nonzero().flatten()
            if lanes.numel():
                fn(i, lanes)

    # ------------------------------------------------------------------ API
    def _generate(self, keys: torch.Tensor, member_ids: torch.Tensor) -> EnvState:
        """A fresh padded state per row of `keys` for member `member_ids[b]`."""
        out = {}

        def gen(i, lanes):
            m = self.members[i]
            fresh = self._pad_state(m.generate(keys[lanes], m.config), i)
            for f in dataclasses.fields(fresh):
                t = getattr(fresh, f.name)
                if f.name not in out:
                    out[f.name] = torch.zeros((keys.shape[0],) + t.shape[1:], dtype=t.dtype, device=t.device)
                out[f.name][lanes] = t

        self._per_member(member_ids, gen)
        return EnvState(**out)

    def reset(self, keys: torch.Tensor, member_ids: torch.Tensor):
        state = self._generate(keys.reshape(-1, 2), member_ids.reshape(-1))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> dict:
        """Each lane's observation under its member's configuration."""
        image = torch.empty((state.grid.shape[0], self.agent_view_size, self.agent_view_size, 3),
                            dtype=torch.uint8, device=state.grid.device)

        def obs(i, lanes):
            image[lanes] = gen_obs(take_lanes(state, lanes), self._branch_config(self.members[i]))["image"]

        self._per_member(state.aux[:, FAMILY_SLOT], obs)
        return {"image": image, "direction": state.agent_dir, "mission": state.mission}

    def _transition(self, state: EnvState, action) -> StepResult:
        action = as_actions(state, action)
        b = action.shape[0]
        parts = {"state": state, "reward": torch.zeros(b, dtype=torch.float32, device=action.device),
                 "terminated": torch.zeros(b, dtype=torch.bool, device=action.device),
                 "truncated": torch.zeros(b, dtype=torch.bool, device=action.device)}

        def step(i, lanes):
            m = self.members[i]
            res = step_fn(m.transition)(take_lanes(state, lanes), action[lanes], self._branch_config(m))
            parts["state"] = put_lanes(parts["state"], lanes, res.state)
            for name in ("reward", "terminated", "truncated"):
                parts[name][lanes] = getattr(res, name)

        self._per_member(state.aux[:, FAMILY_SLOT], step)
        return StepResult(**parts)

    def step(self, state: EnvState, action):
        res = self._transition(state, action)
        return res.state, self.observe(res.state), res.reward, res.terminated, res.truncated

    # --------------------------------------------------------- batched use
    def reset_batch(self, key: torch.Tensor, member_ids: torch.Tensor):
        """`split(key, B)` for `(B,)` member ids: `(states, obs)` on the
        key's device."""
        member_ids = torch.as_tensor(member_ids, device=key.device)
        return self.reset(prng.split(key, member_ids.shape[0]), member_ids)

    def autoreset_step(self):
        """`step(states, actions) -> (states, obs, reward, terminated,
        truncated)`: a lane whose episode ends takes a fresh layout of the
        same member, generated from its finishing rng leaf, and `obs`
        observes the new state."""

        def step(state: EnvState, action):
            res = self._transition(state, action)
            s = res.state
            out = reset_finished(s, res.terminated | res.truncated,
                                 lambda lanes: self._generate(s.rng[lanes], s.aux[lanes, FAMILY_SLOT]))
            return out, self.observe(out), res.reward, res.terminated, res.truncated

        return step


def build_mixed_rollout(menv: MixedEnv, num_steps: int, mesh=None):
    """The random policy over a `MixedEnv` batch: `rollout(key, states) ->
    (states, RolloutMetrics)`, step t's actions `randint(split(key, T)[t],
    (B,), 0, menv.num_actions)` as in the JAX package (`core/rollout.py::
    run_rollout`). With a mesh, `states` is a sharded `EnvState`
    (`sharding.shard_states`) and shard `i` takes the actions of its lanes
    in the whole batch: the states and integer totals of the unsharded
    call, the reward summed in shard order."""
    auto_step = menv.autoreset_step()

    def rollout(key: torch.Tensor, states: EnvState):
        return run_rollout(auto_step, menv.observe, random_policy(menv.num_actions), num_steps, key, states)

    if mesh is None:
        return rollout

    def sharded(key: torch.Tensor, shards):
        if len(shards) != mesh.n_env:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.n_env} env shards")
        b = shards[0].step_count.shape[0]

        def shard(i):
            policy = random_policy(menv.num_actions, (mesh.shard_offset + i) * b)
            return run_rollout(auto_step, menv.observe, policy, num_steps, key.to(mesh.shard_devices[i]), shards[i])

        out = sharding.map_shards(mesh, shard)
        return tuple(f for f, _ in out), sum_metrics([m for _, m in out])

    return sharded


def _mixed_step(env_ids: Sequence[str], inners):
    """`step(key, members, mark=_no_mark) -> (members, RolloutMetrics)`:
    member `i` steps under `fold_in(key, i)`. `mark(piece)` reaches each
    member's call, which marks its own pieces, and is called after it with
    the piece "member <i>", so a profiler can time the members and their
    pieces in place."""

    def step(key: torch.Tensor, members, mark=_no_mark):
        if len(members) != len(inners):
            raise ValueError(f"{len(members)} member blocks for {len(inners)} members {tuple(env_ids)}")
        finals, metrics = [], []
        for i, (inner, member) in enumerate(zip(inners, members)):
            f, m = inner(prng.fold_in(key, i), member, mark=mark)
            finals.append(f)
            metrics.append(m)
            mark(f"member {i}")
        return tuple(finals), sum_metrics(metrics)

    return step


def _packed_mixed(env_ids, num_steps, mode, as_carry, mesh, backend):
    """`backend` "auto" (the kernels) or "plain" (the plain twins); with a
    mesh, `parallel/packed.py`'s backend of the same name."""

    def build(env):
        if mesh is not None:
            return build_sharded_rollout(env, num_steps, mesh, mode=mode, backend=backend, as_carry=as_carry)
        one = build_packed_plain_rollout if backend == "plain" else build_fused_rollout
        return one(env, num_steps, mode=mode, as_carry=as_carry)

    return _mixed_step(env_ids, [build(make(e)) for e in env_ids])


def build_packed_mixed_rollout(
    env_ids: Sequence[str],
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
    mesh=None,
):
    """The random policy over a mixed batch: `rollout(key, states_tuple) ->
    (states_tuple, RolloutMetrics)` over one batched `EnvState` per member
    (each member's `reset_batch`), or with `as_carry=True` the steady
    surface `step(key, carries) -> (carries, RolloutMetrics)` over one
    `PackedCarry` per member (`packed_init`; `packed_finish` unpacks).
    Member `i` is `build_fused_rollout(make(env_ids[i]), ...)` driven by
    the key `fold_in(key, i)`: the JAX package's random-policy actions.
    With a mesh each member's value is sharded and its rollout is
    `build_sharded_rollout` (the kernels on a CUDA shard)."""
    return _packed_mixed(env_ids, num_steps, mode, as_carry, mesh, "auto")


def build_packed_mixed_plain_rollout(
    env_ids: Sequence[str],
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
    mesh=None,
):
    """`build_packed_mixed_rollout` on the plain twins
    (`build_packed_plain_rollout`), on any device."""
    return _packed_mixed(env_ids, num_steps, mode, as_carry, mesh, "plain")


def _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, mesh, backend):
    """`backend` as in `_packed_mixed`."""
    if len(params_list) != len(env_ids):
        raise ValueError(f"{len(params_list)} params for {len(env_ids)} members: one per member")

    def build(env, params):
        if mesh is not None:
            return build_sharded_policy_eval(env, params, num_steps, mesh, mode=mode, backend=backend, as_carry=True,
                                             regen_chunk=regen_chunk)
        one = build_policy_eval_plain_rollout if backend == "plain" else build_policy_eval_rollout
        return one(env, params, num_steps, mode=mode, as_carry=True, regen_chunk=regen_chunk)

    return _mixed_step(env_ids, [build(make(e), p) for e, p in zip(env_ids, params_list)])


def build_mixed_policy_eval(
    env_ids: Sequence[str],
    params_list: Sequence,
    num_steps: int,
    mode: str = "cached",
    regen_chunk: int = 32,
    mesh=None,
):
    """Policy-in-the-loop evaluation over a mixed batch, each member with its
    own actor-critic (`params_list[i]`: an `ActorCritic`, or a flax params
    tree of numpy arrays as `build_policy_eval_rollout` takes it). Carry
    form only: `step(key, carries) -> (carries, RolloutMetrics)` over one
    `PackedCarry` per member; member `i` is `build_policy_eval_rollout(...,
    as_carry=True)` under `fold_in(key, i)`, or with a mesh
    `build_sharded_policy_eval` over a sharded carry."""
    return _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, mesh, "auto")


def build_mixed_policy_eval_plain(
    env_ids: Sequence[str],
    params_list: Sequence,
    num_steps: int,
    mode: str = "cached",
    regen_chunk: int = 32,
    mesh=None,
):
    """`build_mixed_policy_eval` on the plain twins
    (`build_policy_eval_plain_rollout`), on any device."""
    return _mixed_policy(env_ids, params_list, num_steps, mode, regen_chunk, mesh, "plain")
