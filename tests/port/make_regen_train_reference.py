"""Write the JAX package's outputs that
`tests/port/test_torch_train_regen.py` holds the port against
(`data/regen_train_reference.npz`), and recompute them live for that
file's `slow` tests: policy evaluation with the pickup-target hook and
training on random layouts, whose JAX references compile the KeyCorridor
and MultiRoom generators inside chunked regen (tens of seconds each on a
CPU).

Every case starts from the port's `packed_init` carry, stored as
`<case>/in/<field>`, under `testing.dyadic_flax_params` (every f32 sum of
the actor exact in any order), at KeyCorridorS3R1 on states whose agents
face their pickup target (`testing.plant_pickup_target`, so the hook's
successes fire) or at MultiRoom-N2-S4:

  * `kc_eval_cached`, `kc_eval_regen`: two calls of
    `build_policy_eval_rollout(backend="xla", as_carry=True)` in cached
    mode, and in regen mode with `max_steps` cut to 5 and chunk 8 (lanes
    end two episodes in a chunk, so resets are deferred);
  * `kc_collect_regen`, `mr_collect_regen`: two calls of the collecting
    rollout `build_fused_train_rollout(backend="xla", raw_obs=True,
    regen_chunk=8)` with `max_steps` cut to 5: carry, metrics and the six
    trajectory arrays;
  * `kc_train_regen`: two chained `build_fused_train_step(backend="xla",
    grad_backend="kernel")` steps in regen mode with `max_steps` cut to 5
    (the gradient kernel in interpret mode, whose pass the port's train
    step runs; the XLA pass accumulates the torso's cotangents in bf16
    across time chunks, and Adam's torso moments then differ by up to 17 %
    of a leaf's largest entry): the carry, the metrics, the flat params
    and Adam's state after each;
  * `dk_train_regen`: the same two train steps at DoorKey-5x5 (no packed
    generator: chunked regen refreshes with the batched `generate`), B =
    128, chunk 8, `max_steps` cut to 5;
  * `do_train_regen`: the same at DynamicObstacles-5x5 (the pre-hook, the
    remap and 3 actions; the weights' head has 3 actor rows);
  * `do_eval_regen`, `mem_eval_regen`: policy evaluation as
    `kc_eval_regen` at DynamicObstacles-5x5 and MemoryS7;
  * `do_random_regen`, `mem_random_regen`, `unlock_random_regen`,
    `bup_random_regen`: two calls of `build_packed_xla_rollout(mode=
    "regen", as_carry=True)` under forced actions 0-6
    (`make_multiroom_reference.actions`) at DynamicObstacles-5x5, MemoryS7,
    Unlock and BlockedUnlockPickup, B = 128, chunk 8, `max_steps` cut to 6.

Every weight tree is `dyadic_flax_params(seed, num_actions=<the env's>)`
(`params`), so the 7-action cases draw the trees they drew before.

    JAX_PLATFORMS=cpu python tests/port/make_regen_train_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root: both packages

import make_multiroom_reference as mref  # noqa: E402

KC = "MiniGrid-KeyCorridorS3R1-v0"
DK = "MiniGrid-DoorKey-5x5-v0"
DO = "MiniGrid-Dynamic-Obstacles-5x5-v0"
MEM = "MiniGrid-MemoryS7-v0"
N2 = mref.N2
PATH = mref.DATA / "regen_train_reference.npz"
PARAMS_SEED = 3
TRAIN_PARAMS_SEED = 2
TRAIN_KEYS = (6, 7)
TRAIN_METRICS = ("loss", "pg_loss", "v_loss", "entropy", "reward_per_step", "episodes", "env_steps")
# name -> (env id, surface, mode, B, T, max_steps, chunk, carry seed, key
# seed, planted pickup targets)
CASES = {
    "kc_eval_cached": (KC, "eval", "cached", 128, 16, None, 8, 5, 11, True),
    "kc_eval_regen": (KC, "eval", "regen", 128, 16, 5, 8, 5, 11, True),
    "kc_collect_regen": (KC, "collect", "regen", 128, 16, 5, 8, 5, 21, True),
    "mr_collect_regen": (N2, "collect", "regen", 64, 16, 5, 8, 7, 21, False),
    "kc_train_regen": (KC, "train", "regen", 128, 16, 5, 32, 5, None, True),
    "dk_train_regen": (DK, "train", "regen", 128, 16, 5, 8, 5, None, False),
    "do_train_regen": (DO, "train", "regen", 128, 16, 5, 8, 5, None, False),
    "do_eval_regen": (DO, "eval", "regen", 128, 16, 5, 8, 5, 11, False),
    "mem_eval_regen": (MEM, "eval", "regen", 128, 16, 5, 8, 5, 11, False),
    "do_random_regen": (DO, "random", "regen", 128, 16, 6, 8, 9, None, False),
    "mem_random_regen": (MEM, "random", "regen", 128, 16, 6, 8, 9, None, False),
    "unlock_random_regen": ("MiniGrid-Unlock-v0", "random", "regen", 128, 16, 6, 8, 9, None, False),
    "bup_random_regen": ("MiniGrid-BlockedUnlockPickup-v0", "random", "regen", 128, 16, 6, 8, 9, None, False),
}


def port_carry(name: str):
    """The port's `packed_init` carry case `name` starts from (CPU)."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.testing import plant_pickup_target
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    env_id, _, mode, b, _, max_steps, _, seed, _, planted = CASES[name]
    states = None
    if planted:
        states = plant_pickup_target(state_to_numpy(make(env_id).reset_batch(key(seed, device="cpu"), b)[0]))
    return mref.port_carry(env_id, b, seed, max_steps, mode, states)


def port_env(name: str):
    from minigrid_tpu_torch import make

    return mref.with_max_steps(make(CASES[name][0]), CASES[name][5])


def params(name: str, seed: int) -> dict:
    """Case `name`'s weights: `dyadic_flax_params(seed)` with its env's
    number of actions."""
    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.testing import dyadic_flax_params

    return dyadic_flax_params(seed, num_actions=make(CASES[name][0]).config.num_actions)


def _leaves(params, prefix=""):
    """`(path, leaf)` of a flax params tree in `ravel_pytree`'s order
    (sorted keys)."""
    for k in sorted(params):
        if isinstance(params[k], dict):
            yield from _leaves(params[k], f"{prefix}{k}/")
        else:
            yield prefix + k, params[k]


def leaf_sizes(params) -> list:
    """The sizes of a flax params tree's leaves in `ravel_pytree`'s order
    (sorted keys), to cut a flat vector into leaves."""
    return [int(np.size(leaf)) for _, leaf in _leaves(params)]


def leaf_names(params) -> list:
    """The paths of a flax params tree's leaves (`torso_0/kernel`, ...) in
    `leaf_sizes`' order."""
    return [path for path, _ in _leaves(params)]


def jax_case(name: str) -> dict:
    """Case `name`'s arrays, as the file holds them under `<name>/`."""
    import jax
    import jax.numpy as jnp

    import minigrid_tpu
    from minigrid_tpu.ops import fused_rollout as jfr
    from minigrid_tpu.ops import policy_rollout as jpr

    env_id, surface, mode, b, t, max_steps, chunk, _, key_seed, _ = CASES[name]
    env = mref.with_max_steps(minigrid_tpu.make(env_id), max_steps)
    carry0 = mref.carry_arrays(port_carry(name))
    out = {f"{name}/in/{k}": v for k, v in carry0.items()}
    carry = mref.jax_carry(carry0)
    if surface == "train":
        from jax.flatten_util import ravel_pytree

        from minigrid_tpu.parallel import train as JT
        from minigrid_tpu.parallel.sharding import make_env_mesh

        mesh = make_env_mesh(jax.devices()[:1])
        step = JT.build_fused_train_step(env, mesh, t, mode=mode, backend="xla", grad_backend="kernel")
        tree = jax.tree.map(jnp.asarray, params(name, TRAIN_PARAMS_SEED))
        ts = JT.TrainState(tree, jax.jit(JT.make_optimizer().init)(tree))
        for i, seed in enumerate(TRAIN_KEYS):
            ts, carry, metrics = step(ts, carry, jax.random.PRNGKey(seed))
            adam = ts.opt_state[1][0]
            out.update({f"{name}/step{i}/carry/{k}": np.asarray(v) for k, v in carry._asdict().items()})
            out.update({f"{name}/step{i}/metrics/{k}": np.asarray(metrics[k]) for k in TRAIN_METRICS})
            out[f"{name}/step{i}/params"] = np.asarray(ravel_pytree(ts.params)[0])
            out[f"{name}/step{i}/mu"] = np.asarray(ravel_pytree(adam.mu)[0])
            out[f"{name}/step{i}/nu"] = np.asarray(ravel_pytree(adam.nu)[0])
            out[f"{name}/step{i}/count"] = np.asarray(adam.count)
        return out
    if surface == "random":
        step = jax.jit(jfr.build_packed_xla_rollout(env, t, mode=mode, regen_chunk=chunk, as_carry=True,
                                                    actions_override=mref.actions(b, t)))
        for i in range(2):
            carry, metrics = step(jax.random.PRNGKey(0), carry)
            out.update(mref.call_arrays(f"{name}/call{i}", carry, metrics))
        return out
    weights = params(name, PARAMS_SEED)
    if surface == "eval":
        step = jax.jit(jpr.build_policy_eval_rollout(env, weights, t, mode=mode, backend="xla", regen_chunk=chunk,
                                                     as_carry=True))
        for i in range(2):
            carry, metrics = step(jax.random.PRNGKey(key_seed), carry)
            out.update(mref.call_arrays(f"{name}/call{i}", carry, metrics))
        return out
    roll = jax.jit(jpr.build_fused_train_rollout(env, t, mode=mode, backend="xla", regen_chunk=chunk, raw_obs=True))
    weights = jax.tree.map(jnp.asarray, weights)
    for i in range(2):
        carry, traj, metrics = roll(weights, jax.random.PRNGKey(key_seed), carry)
        out.update(mref.call_arrays(f"{name}/call{i}", carry, metrics, traj))
    return out


def case_arrays(name: str, path: Path = PATH) -> dict:
    """Case `name`'s arrays from the file, without the `<name>/` prefix."""
    return {k[len(name) + 1:]: v for k, v in mref.load(path).items() if k.startswith(name + "/")}


def assert_port_random_case(name: str) -> None:
    """The port's plain random-policy rollout on `random` case `name`, two
    calls from its stored input carry, against the file: carries and
    integer metrics byte for byte, `total_reward` to rtol 1e-6 (the
    batch-sum order); the calls must defer resets to re-entry passes."""
    from minigrid_tpu_torch.ops import fused_rollout as tfr
    from minigrid_tpu_torch.utils.convert import carry_to_numpy

    _, surface, mode, b, t, _, chunk, _, _, _ = CASES[name]
    assert surface == "random"
    carry = port_carry(name)
    arrays = case_arrays(name)
    for field, got in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(got, arrays[f"in/{field}"], err_msg=f"input carry {field}")
    step = tfr.build_packed_plain_rollout(port_env(name), t, mode=mode, regen_chunk=chunk, as_carry=True,
                                          actions_override=mref.actions(b, t))
    overlaps = 0
    for i in range(2):
        carry, m = step(None, carry)
        for field, got in carry_to_numpy(carry).items():
            np.testing.assert_array_equal(got, arrays[f"call{i}/carry/{field}"], err_msg=f"call {i} {field}")
        for k in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
            assert int(getattr(m, k)) == int(arrays[f"call{i}/metrics/{k}"]), (i, k)
        np.testing.assert_allclose(float(m.total_reward), float(arrays[f"call{i}/metrics/total_reward"]), rtol=1e-6)
        overlaps += int(m.reset_overlaps)
    assert overlaps > 0


def main() -> int:
    arrays = {}
    for name in CASES:
        arrays.update(jax_case(name))
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
