"""The packed rollouts over a device mesh (counterpart of
`minigrid_tpu/parallel/packed.py`).

Data parallelism over lanes: each env shard runs the unmodified one-device
rollout on its lane slice, under the key `fold_in(key, shard)`, as the JAX
package's `shard_map` body does (`packed.py:116-118`, `:180-182`), and the
five metrics are summed in shard order on the first shard's device, as its
`psum` sums them. So a sharded rollout is a per-shard replay: its result
depends on the number of shards, and shard `i` equals the one-device
builder called on its lanes under `fold_in(key, i)`.

States and carries are sharded values (`parallel/sharding.py`): tuples of
per-shard `EnvState`s or `PackedCarry`s. `backend` chooses each shard's
one-device build function:

  * `"kernel"`: `build_fused_rollout` / `build_policy_eval_rollout`, the
    hand-written kernels (on a CPU shard they run their plain versions, as
    every wrapper of the port does for a CPU tensor);
  * `"plain"`: `build_packed_plain_rollout` /
    `build_policy_eval_plain_rollout`, on any device;
  * `"engine"` (rollouts only): the per-env engine,
    `core/rollout.py::build_rollout`, which runs every family, as the JAX
    package's `"vmap"` backend does;
  * `"auto"`: `_pick_backend` per shard: the kernels on a CUDA shard, the
    plain versions on a CPU shard, the per-env engine where
    `fused_rollout_supported` is false.

The source is a `(2,)` key only: a `torch.Generator` cannot be folded.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from minigrid_tpu_torch.core.prng import fold_in
from minigrid_tpu_torch.core.rollout import RolloutMetrics, build_rollout
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.ops.fused_rollout import (
    PackedCarry,
    build_fused_rollout,
    build_packed_plain_rollout,
    fused_rollout_supported,
)
from minigrid_tpu_torch.ops.policy_rollout import build_policy_eval_plain_rollout, build_policy_eval_rollout
from minigrid_tpu_torch.parallel import sharding
from minigrid_tpu_torch.parallel.sharding import Mesh, _bounds

BACKENDS = ("kernel", "plain", "engine")


def shard_carry(carry: PackedCarry, mesh: Mesh) -> Tuple[PackedCarry, ...]:
    """A `PackedCarry` split over the env shards: the lane (last) axis of
    the words, registers and templates, the batch-major `rng`'s first axis;
    one carry per shard, on its device."""
    b = carry.words.shape[1]
    return tuple(
        PackedCarry(
            *(x[:, lo:hi].to(dev).contiguous() for x in carry[:4]),
            carry.rng[lo:hi].to(dev).contiguous(),
        )
        for (lo, hi), dev in zip(_bounds(b, mesh), mesh.shard_devices)
    )


def gather_carry(shards: Sequence[PackedCarry], device=None) -> PackedCarry:
    """The shards of `shard_carry` joined in shard order, on `device`
    (default: the first shard's)."""
    device = shards[0].words.device if device is None else torch.device(device)
    lanes = [torch.cat([s[i].to(device) for s in shards], dim=1) for i in range(4)]
    return PackedCarry(*lanes, torch.cat([s.rng.to(device) for s in shards]))


def sum_metrics(metrics: Sequence[RolloutMetrics]) -> RolloutMetrics:
    """Per-shard totals summed field by field in shard order on the first
    shard's device; int32 sums wrap, as the JAX package's `psum` does."""
    dev = metrics[0].episodes.device
    total = metrics[0]
    for m in metrics[1:]:
        total = RolloutMetrics(*(a + b.to(dev) for a, b in zip(total, m)))
    return total


def _device_backend(device: torch.device) -> str:
    """The kernels on a CUDA shard, the plain versions on a CPU one."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def _pick_backend(env: Env, mode: str, device: torch.device) -> str:
    """`"auto"` for one shard: the per-env engine where the packed rollouts
    do not run `env` under `mode`, else `_device_backend`."""
    if not fused_rollout_supported(env, mode=mode):
        return "engine"
    return _device_backend(device)


def _check_backend(backend: str, allowed=BACKENDS) -> None:
    if backend != "auto" and backend not in allowed:
        raise ValueError(f"unknown backend {backend!r} (known: 'auto', {', '.join(map(repr, allowed))})")


def _shard_keys(key: torch.Tensor, mesh: Mesh):
    """`fold_in(key, global shard index)` on each shard's device."""
    return [fold_in(key.to(dev), mesh.shard_offset + i) for i, dev in enumerate(mesh.shard_devices)]


def _sharded(mesh: Mesh, inners):
    """`step(key, values) -> (values, RolloutMetrics)` over sharded values:
    shard `i` calls `inners[i](fold_in(key, shard), values[i])`. `mark` is
    taken for the one-device surfaces' signature; the shards' pieces are
    not marked."""

    def step(key: torch.Tensor, values, mark=None):
        if len(values) != mesh.n_env:
            raise ValueError(f"{len(values)} shards for a mesh of {mesh.n_env} env shards")
        keys = _shard_keys(key, mesh)
        out = sharding.map_shards(mesh, lambda i: inners[i](keys[i], values[i]))
        return tuple(f for f, _ in out), sum_metrics([m for _, m in out])

    return step


def build_sharded_rollout(
    env: Env,
    num_steps: int,
    mesh: Mesh,
    mode: str = "regen",
    backend: str = "auto",
    as_carry: bool = False,
    regen_chunk: int = 32,
):
    """`rollout(key, states) -> (states, RolloutMetrics)` over a sharded
    `EnvState` (`sharding.shard_states`), or with `as_carry=True` the
    steady surface `step(key, carries) -> (carries, RolloutMetrics)` over
    a sharded `PackedCarry` (`shard_carry(packed_init(...))`, or
    `packed_init` per shard). Each shard runs the one-device random-policy
    rollout under `fold_in(key, shard)`; final states stay sharded, the
    metrics are summed. `regen_chunk` is the packed build functions'."""
    if mode not in ("regen", "cached"):
        raise ValueError(f"unknown autoreset mode {mode!r}")
    _check_backend(backend)
    picks = [_pick_backend(env, mode, d) if backend == "auto" else backend for d in mesh.shard_devices]
    if as_carry and "engine" in picks:
        raise ValueError(f"as_carry needs a packed backend; {env.env_id!r} runs on the per-env engine")

    def build(name):
        if name == "engine":
            return build_rollout(env, num_steps, autoreset_mode=mode)
        fn = build_fused_rollout if name == "kernel" else build_packed_plain_rollout
        return fn(env, num_steps, mode=mode, as_carry=as_carry, regen_chunk=regen_chunk)

    built = {name: build(name) for name in dict.fromkeys(picks)}
    return _sharded(mesh, [built[name] for name in picks])


def build_sharded_policy_eval(
    env: Env,
    params,
    num_steps: int,
    mesh: Mesh,
    mode: str = "cached",
    backend: str = "auto",
    as_carry: bool = False,
    regen_chunk: int = 32,
):
    """Policy-in-the-loop evaluation over the mesh: the surfaces of
    `build_sharded_rollout`, each shard `build_policy_eval_rollout` (or its
    plain twin) under `fold_in(key, shard)`. `params` (an `ActorCritic`, or
    a flax params tree) reaches every shard's weights on every pass, on the
    shard's device."""
    _check_backend(backend, ("kernel", "plain"))
    picks = [_device_backend(d) if backend == "auto" else backend for d in mesh.shard_devices]
    makers = {"kernel": build_policy_eval_rollout, "plain": build_policy_eval_plain_rollout}
    built = {
        name: makers[name](env, params, num_steps, mode=mode, as_carry=as_carry, regen_chunk=regen_chunk)
        for name in dict.fromkeys(picks)
    }
    return _sharded(mesh, [built[name] for name in picks])
