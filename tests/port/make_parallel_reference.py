"""Write the JAX package's outputs over its 8-device CPU mesh that
`tests/port/test_torch_parallel.py` and `test_torch_parallel_train.py` hold
the port's 8 CPU shards against (`data/parallel_reference.npz`), and
recompute them live for those files' `slow` tests.

Every case starts from the port's own states (`reset_batch(key(seed), B)`
with each step count moved within `SPAN` steps of `max_steps`, so that
every lane resets inside the calls), stored as `<case>/in/...`: a
`packed_init` carry for the carry surfaces, the states for the others.
Each call's results are stored as `<case>/call<c>/...`, gathered over the
shards (the carry or states, the summed metrics; for a train step the
flat params, Adam's `mu`, `nu` and count, and the metrics).

  * `ROLLOUT_CASES`: `build_sharded_rollout(..., backend="packed",
    as_carry=True)`, two calls of T = 16 at B = 128 (16 lanes a shard);
    the `auto` case takes the backend `_pick_backend` takes, stored as
    `<case>/backend`.
  * `POLICY_CASES`: `build_sharded_policy_eval(..., backend="xla",
    as_carry=True)` under `testing.dyadic_flax_params(PARAMS_SEED)`.
  * `TRAIN_CASES`: two chained steps of `build_train_step`,
    `build_packed_train_step` and `build_fused_train_step(backend="xla",
    grad_backend="kernel")` from the dyadic params and optax's zero state.
  * `MIXED_CASES`: `build_packed_mixed_rollout` (cached, regen) and
    `build_mixed_policy_eval` (regen) over the mesh, 64 lanes a member,
    and `build_mixed_rollout` of a `MixedEnv` batch over the mesh.

    JAX_PLATFORMS=cpu python tests/port/make_parallel_reference.py

(several minutes, mostly the compiles of the random layouts' generators
and of chunked regen around them).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root: both packages
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import make_multiroom_reference as mref  # noqa: E402

PATH = mref.DATA / "parallel_reference.npz"
SHARDS = 8
B = 128
T = 16
CALLS = 2
SPAN = 24
KEY_SEEDS = (60, 61)
PARAMS_SEED = 5
# name -> (env id, mode, state seed); the sharded random-policy rollouts.
ROLLOUT_CASES = {
    "empty8_cached": ("MiniGrid-Empty-8x8-v0", "cached", 10),
    "empty8_regen": ("MiniGrid-Empty-8x8-v0", "regen", 11),
    "emptyrandom5_regen": ("MiniGrid-Empty-Random-5x5-v0", "regen", 12),
    "doorkey5_regen": ("MiniGrid-DoorKey-5x5-v0", "regen", 13),
    "kc_s3r1_regen": ("MiniGrid-KeyCorridorS3R1-v0", "regen", 14),
    "do5_auto_regen": ("MiniGrid-Dynamic-Obstacles-5x5-v0", "regen", 15),
}
POLICY_CASES = {
    "policy_empty8_cached": ("MiniGrid-Empty-8x8-v0", "cached", 20),
    "policy_doorkey5_regen": ("MiniGrid-DoorKey-5x5-v0", "regen", 21),
}
# name -> (step, env id, mode, as_carry, B, T, state seed)
TRAIN_CASES = {
    "train_vmap_empty8": ("vmap", "MiniGrid-Empty-8x8-v0", "regen", False, 64, 8, 30),
    "train_packed_empty8_cached": ("packed", "MiniGrid-Empty-8x8-v0", "cached", False, 64, 8, 31),
    "train_packed_doorkey5_regen": ("packed", "MiniGrid-DoorKey-5x5-v0", "regen", True, 64, 8, 32),
    "train_fused_empty5_regen": ("fused", "MiniGrid-Empty-5x5-v0", "regen", True, 128, 8, 33),
}
TRAIN_KEY_SEEDS = (70, 71)
MIXED_IDS = ("MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-FourRooms-v0")
MIXED_B = 64  # lanes a member
MIXED_T = 32
MIXED_KEY_SEED = 80
MIXED_SEEDS = (40, 41)
MIXED_PARAMS_SEEDS = (3, 4)
# name -> (surface, mode)
MIXED_CASES = {
    "mixed_random_cached": ("random", "cached"),
    "mixed_random_regen": ("random", "regen"),
    "mixed_policy_regen": ("policy", "regen"),
    "mixed_env": ("env", "regen"),
}
CASES = tuple(ROLLOUT_CASES) + tuple(POLICY_CASES) + tuple(TRAIN_CASES) + tuple(MIXED_CASES)


def port_states(env_id: str, b: int, seed: int, span: int = SPAN) -> dict:
    """The port's `reset_batch(key(seed), b)` on the CPU as numpy arrays,
    each step count moved within `span` steps of `max_steps`."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    env = make(env_id)
    s = state_to_numpy(env.reset_batch(key(seed, device="cpu"), b)[0])
    s["step_count"] = (env.config.max_steps - np.random.default_rng(seed).integers(1, span + 1, b)).astype(np.int32)
    return s


def port_carry_arrays(env_id: str, mode: str, b: int, seed: int) -> dict:
    """The port's `packed_init` carry of `port_states`, as numpy arrays."""
    return mref.carry_arrays(mref.port_carry(env_id, b, seed, mode=mode, states=port_states(env_id, b, seed)))


def metric_arrays(prefix: str, metrics) -> dict:
    out = {}
    for k in (mref.METRIC_FIELDS if hasattr(metrics, "_fields") else sorted(metrics)):
        v = metrics[k] if isinstance(metrics, dict) else getattr(metrics, k)
        out[f"{prefix}/metrics/{k}"] = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    return out


def _jax_mesh():
    import jax

    from minigrid_tpu.parallel.sharding import make_env_mesh

    assert jax.device_count() == SHARDS, "the JAX reference needs 8 CPU devices (XLA_FLAGS)"
    return make_env_mesh()


def _jax_states(arrays: dict):
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState

    return EnvState(**{k: jnp.asarray(arrays[k]) for k in mref.STATE_FIELDS})


def _state_arrays(prefix: str, states) -> dict:
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    if hasattr(states.grid, "cpu"):
        return {f"{prefix}/{k}": v for k, v in state_to_numpy(states).items()}
    return {f"{prefix}/{k}": np.asarray(getattr(states, k)) for k in mref.STATE_FIELDS}


def _flat_train(prefix: str, params_flat, count, mu, nu, metrics) -> dict:
    out = {f"{prefix}/params": np.asarray(params_flat, np.float32), f"{prefix}/count": np.asarray(count, np.int32),
           f"{prefix}/mu": np.asarray(mu, np.float32), f"{prefix}/nu": np.asarray(nu, np.float32)}
    out.update(metric_arrays(prefix, metrics))
    return out


def _inputs(name: str) -> dict:
    """A case's stored inputs, `<name>/in/...`, as the port makes them."""
    if name in ROLLOUT_CASES or name in POLICY_CASES:
        env_id, mode, seed = {**ROLLOUT_CASES, **POLICY_CASES}[name]
        return {f"{name}/in/{k}": v for k, v in port_carry_arrays(env_id, mode, B, seed).items()}
    if name in TRAIN_CASES:
        kind, env_id, mode, as_carry, b, _, seed = TRAIN_CASES[name]
        arrays = port_carry_arrays(env_id, mode, b, seed) if as_carry else port_states(env_id, b, seed)
        return {f"{name}/in/{k}": v for k, v in arrays.items()}
    surface, mode = MIXED_CASES[name]
    if surface == "env":
        return {f"{name}/in/{k}": v for k, v in mixed_env_states().items()}
    out = {}
    for i, (env_id, seed) in enumerate(zip(MIXED_IDS, MIXED_SEEDS)):
        out.update({f"{name}/in/{i}/{k}": v for k, v in port_carry_arrays(env_id, mode, MIXED_B, seed).items()})
    return out


def mixed_member_ids() -> np.ndarray:
    """The `MixedEnv` case's member per lane: 2·MIXED_B lanes, alternating."""
    return (np.arange(2 * MIXED_B) % len(MIXED_IDS)).astype(np.int32)


def mixed_env_states() -> dict:
    """`MixedEnv.reset_batch(key(MIXED_SEEDS[0]), member_ids)` of the port,
    each step count moved within `MIXED_T` of its member's `max_steps`."""
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.parallel.mixed import MixedEnv
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    menv = MixedEnv.create(MIXED_IDS)
    ids = mixed_member_ids()
    s = state_to_numpy(menv.reset_batch(key(MIXED_SEEDS[0], device="cpu"), torch.from_numpy(ids))[0])
    max_steps = np.array([m.config.max_steps for m in menv.members])[ids]
    s["step_count"] = (max_steps - np.random.default_rng(2).integers(1, MIXED_T + 1, len(ids))).astype(np.int32)
    return s


def _stored_inputs(name: str, stored: dict) -> dict:
    return {k[len(name) + 4:]: v for k, v in stored.items() if k.startswith(f"{name}/in/")}


def jax_case(name: str) -> dict:
    """Case `name`'s arrays as the file holds them under `<name>/`, from
    the JAX package over its 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    import minigrid_tpu
    from minigrid_tpu.parallel import mixed as jmixed
    from minigrid_tpu.parallel import packed as jpk
    from minigrid_tpu.parallel import train as jtr
    from minigrid_tpu.parallel.sharding import shard_states
    from minigrid_tpu_torch.testing import dyadic_flax_params

    mesh = _jax_mesh()
    out = _inputs(name)
    ins = _stored_inputs(name, out)
    if name in ROLLOUT_CASES or name in POLICY_CASES:
        env_id, mode, _ = {**ROLLOUT_CASES, **POLICY_CASES}[name]
        env = minigrid_tpu.make(env_id)
        if name in ROLLOUT_CASES:
            backend = "auto" if name.endswith("_auto_regen") else "packed"
            if backend == "auto":
                out[f"{name}/backend"] = np.array(jpk._pick_backend(env, mode))
            step = jpk.build_sharded_rollout(env, T, mesh, mode=mode, backend=backend, as_carry=True)
        else:
            step = jpk.build_sharded_policy_eval(env, dyadic_flax_params(PARAMS_SEED), T, mesh, mode=mode,
                                                 backend="xla", as_carry=True)
        carry = jpk.shard_carry(mref.jax_carry(ins), mesh)
        for c, seed in enumerate(KEY_SEEDS):
            carry, metrics = step(jax.random.PRNGKey(seed), carry)
            out.update(mref.call_arrays(f"{name}/call{c}", carry, metrics))
        return out
    if name in TRAIN_CASES:
        kind, env_id, mode, as_carry, _, t, _ = TRAIN_CASES[name]
        env = minigrid_tpu.make(env_id)
        if kind == "vmap":
            step = jtr.build_train_step(env, mesh, t, mode=mode)
        elif kind == "packed":
            step = jtr.build_packed_train_step(env, mesh, t, mode=mode, as_carry=as_carry)
        else:
            step = jtr.build_fused_train_step(env, mesh, t, mode=mode, backend="xla", grad_backend="kernel")
        params = jax.tree.map(jnp.asarray, dyadic_flax_params(PARAMS_SEED))
        ts = jtr.TrainState(params, jax.jit(jtr.make_optimizer().init)(params))
        value = jpk.shard_carry(mref.jax_carry(ins), mesh) if as_carry else shard_states(_jax_states(ins), mesh)
        for c, seed in enumerate(TRAIN_KEY_SEEDS):
            ts, value, metrics = step(ts, value, jax.random.PRNGKey(seed))
            adam = ts.opt_state[1][0]
            prefix = f"{name}/call{c}"
            out.update(_flat_train(prefix, ravel_pytree(ts.params)[0], adam.count, adam.mu, adam.nu,
                                   {k: np.asarray(v) for k, v in metrics.items()}))
            if as_carry:
                out.update({f"{prefix}/carry/{k}": v for k, v in mref.carry_arrays(value).items()})
            else:
                out.update(_state_arrays(f"{prefix}/states", value))
        return out
    surface, mode = MIXED_CASES[name]
    key = jax.random.PRNGKey(MIXED_KEY_SEED)
    if surface == "env":
        menv = jmixed.MixedEnv.create(MIXED_IDS)
        states = shard_states(_jax_states(ins), mesh)
        final, metrics = jmixed.build_mixed_rollout(menv, MIXED_T, mesh=mesh)(key, states)
        out.update(_state_arrays(f"{name}/call0/states", final))
        out.update(metric_arrays(f"{name}/call0", metrics))
        return out
    carries = tuple(
        jpk.shard_carry(mref.jax_carry({k: ins[f"{i}/{k}"] for k in mref.CARRY_FIELDS}), mesh)
        for i in range(len(MIXED_IDS))
    )
    if surface == "random":
        step = jmixed.build_packed_mixed_rollout(MIXED_IDS, MIXED_T, mesh=mesh, mode=mode, backend="packed",
                                                 as_carry=True)
    else:
        params = [dyadic_flax_params(s) for s in MIXED_PARAMS_SEEDS]
        step = jmixed.build_mixed_policy_eval(MIXED_IDS, params, MIXED_T, mesh=mesh, mode=mode, backend="xla")
    carries, metrics = step(key, carries)
    for i, carry in enumerate(carries):
        out.update({f"{name}/call0/carry/{i}/{k}": v for k, v in mref.carry_arrays(carry).items()})
    out.update(metric_arrays(f"{name}/call0", metrics))
    return out


def port_mesh(device: str = "cpu"):
    """The port's mesh of `SHARDS` shards on one device."""
    from minigrid_tpu_torch.parallel.sharding import make_env_mesh

    return make_env_mesh([device] * SHARDS)


def port_case(name: str, stored: dict, device: str = "cpu", plain: bool = True) -> dict:
    """A rollout, policy or mixed case through the port's mesh of 8 shards
    on `device` from the stored inputs (the plain versions, or with
    `plain=False` the kernels: `backend="auto"` on a card), laid out as
    `jax_case` lays it out."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.parallel.sharding import gather_states, shard_states
    from minigrid_tpu_torch.testing import dyadic_flax_params
    from minigrid_tpu_torch.utils.convert import carry_from_numpy, state_from_numpy

    mesh = port_mesh(device)
    backend = "plain" if plain else "auto"
    ins = _stored_inputs(name, stored)
    out = {f"{name}/in/{k}": v for k, v in ins.items()}
    if name in ROLLOUT_CASES or name in POLICY_CASES:
        env_id, mode, _ = {**ROLLOUT_CASES, **POLICY_CASES}[name]
        env = make(env_id)
        if name in ROLLOUT_CASES:
            if name.endswith("_auto_regen"):
                out[f"{name}/backend"] = stored[f"{name}/backend"]
                backend = "auto"
            step = pk.build_sharded_rollout(env, T, mesh, mode=mode, backend=backend, as_carry=True)
        else:
            model = ActorCritic.from_flax(dyadic_flax_params(PARAMS_SEED), device=device)
            step = pk.build_sharded_policy_eval(env, model, T, mesh, mode=mode, backend=backend, as_carry=True)
        carries = pk.shard_carry(carry_from_numpy(ins, device=device), mesh)
        for c, seed in enumerate(KEY_SEEDS):
            carries, metrics = step(key(seed, device=device), carries)
            metrics = type(metrics)(*(m.cpu() for m in metrics))
            out.update(mref.call_arrays(f"{name}/call{c}", pk.gather_carry(carries), metrics))
        return out
    surface, mode = MIXED_CASES[name]
    k = key(MIXED_KEY_SEED, device=device)
    if surface == "env":
        menv = mixed.MixedEnv.create(MIXED_IDS)
        states = shard_states(state_from_numpy(ins, device=device), mesh)
        final, metrics = mixed.build_mixed_rollout(menv, MIXED_T, mesh=mesh)(k, states)
        out.update(_state_arrays(f"{name}/call0/states", gather_states(final)))
        out.update(metric_arrays(f"{name}/call0", metrics))
        return out
    carries = tuple(
        pk.shard_carry(carry_from_numpy({f: ins[f"{i}/{f}"] for f in mref.CARRY_FIELDS}, device=device), mesh)
        for i in range(len(MIXED_IDS))
    )
    if surface == "random":
        build = mixed.build_packed_mixed_plain_rollout if plain else mixed.build_packed_mixed_rollout
        step = build(MIXED_IDS, MIXED_T, mode=mode, as_carry=True, mesh=mesh)
    else:
        models = [ActorCritic.from_flax(dyadic_flax_params(s), device=device) for s in MIXED_PARAMS_SEEDS]
        build = mixed.build_mixed_policy_eval_plain if plain else mixed.build_mixed_policy_eval
        step = build(MIXED_IDS, models, MIXED_T, mode=mode, mesh=mesh)
    carries, metrics = step(k, carries)
    for i, member in enumerate(carries):
        out.update({f"{name}/call0/carry/{i}/{f}": v for f, v in mref.carry_arrays(pk.gather_carry(member)).items()})
    out.update(metric_arrays(f"{name}/call0", metrics))
    return out


def case_arrays(name: str, path: Path = PATH) -> dict:
    """Case `name`'s arrays from the file."""
    return {k: v for k, v in mref.load(path).items() if k.startswith(name + "/")}


def main() -> int:
    arrays = {}
    for name in CASES:
        arrays.update(jax_case(name))
        print(f"{name}: done", flush=True)
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
