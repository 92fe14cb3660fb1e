"""Write the JAX package's mixed-batch outputs that
`tests/port/test_torch_mixed.py` holds the port against
(`data/mixed_reference.npz`), and recompute them live for that file's
`slow` test.

BASELINE.md's config 5 at test size: LavaCrossingS9N1 + FourRooms, 64
lanes a member, from the port's `packed_init` carries of
`reset_batch(key(CARRY_SEEDS[i]), 64)` (stored as `<case>/in/<i>/<field>`),
four calls of T = 32 under the keys `PRNGKey(KEY_SEEDS[c])` (FourRooms
truncates every lane at step 100, in the fourth call), each call's member
carries and summed metrics stored as `<case>/call<c>/...`:

  * `random_cached`, `random_regen`: `build_packed_mixed_rollout(backend=
    "xla", as_carry=True)` in cached and in regen mode (the random policy,
    member i under `fold_in(key, i)`);
  * `policy_regen`: `build_mixed_policy_eval(backend="xla")` in regen mode,
    member i under `testing.dyadic_flax_params(PARAMS_SEEDS[i])`.

Each case compiles both members' chunked regen on a CPU (tens of seconds).

A fourth case, `mixed_env`, holds the per-env `MixedEnv` that
`tests/port/test_torch_engine.py` checks: `MixedEnv.reset_batch(
PRNGKey(MIXED_ENV_SEEDS[0]), member_ids())` (states and observation
images, `mixed_env/reset/...`), then `build_mixed_rollout(menv, T)` under
`PRNGKey(MIXED_ENV_SEEDS[1])` from those states with every step count
moved within T of its member's `max_steps` (`doctor_mixed`), its final
states and metrics (`mixed_env/final/...`, `mixed_env/metrics/...`).

    JAX_PLATFORMS=cpu python tests/port/make_mixed_reference.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root: both packages

import make_multiroom_reference as mref  # noqa: E402

PATH = mref.DATA / "mixed_reference.npz"
IDS = ("MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-FourRooms-v0")
B = 64
T = 32
CALLS = 4
CARRY_SEEDS = (30, 31)
KEY_SEEDS = (50, 51, 52, 53)
PARAMS_SEEDS = (3, 4)
MIXED_ENV_CASE = "mixed_env"
MIXED_ENV_SEEDS = (40, 41)
# name -> (surface, mode)
CASES = {
    "random_cached": ("random", "cached"),
    "random_regen": ("random", "regen"),
    "policy_regen": ("policy", "regen"),
}


def port_carries(mode: str) -> tuple:
    """The port's member carries a case starts from (CPU)."""
    return tuple(mref.port_carry(e, B, s, mode=mode) for e, s in zip(IDS, CARRY_SEEDS))


def params_list() -> list:
    """The members' weights, as numpy flax trees."""
    from minigrid_tpu_torch.testing import dyadic_flax_params

    return [dyadic_flax_params(s) for s in PARAMS_SEEDS]


def call_arrays(prefix: str, carries, metrics) -> dict:
    """One call's member carries and summed metrics as flat arrays."""
    out = {}
    for i, carry in enumerate(carries):
        out.update({f"{prefix}/carry/{i}/{k}": v for k, v in mref.carry_arrays(carry).items()})
    for k in mref.METRIC_FIELDS:
        v = getattr(metrics, k)
        out[f"{prefix}/metrics/{k}"] = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    return out


def jax_case(name: str) -> dict:
    """Case `name`'s arrays, as the file holds them under `<name>/`."""
    import jax

    from minigrid_tpu.parallel import mixed as jmixed

    surface, mode = CASES[name]
    carries0 = [mref.carry_arrays(c) for c in port_carries(mode)]
    out = {f"{name}/in/{i}/{k}": v for i, c in enumerate(carries0) for k, v in c.items()}
    carries = tuple(mref.jax_carry(c) for c in carries0)
    if surface == "random":
        step = jmixed.build_packed_mixed_rollout(IDS, T, mode=mode, backend="xla", as_carry=True)
    else:
        step = jmixed.build_mixed_policy_eval(IDS, params_list(), T, mode=mode, backend="xla")
    for c, seed in enumerate(KEY_SEEDS):
        carries, metrics = step(jax.random.PRNGKey(seed), carries)
        out.update(call_arrays(f"{name}/call{c}", carries, metrics))
    return out


def port_case(name: str, plain: bool = True, device: str = "cpu") -> dict:
    """Case `name` through the port's mixed surfaces from its stored input
    carries (the plain twins, or the kernels on a card with `plain=False`),
    as `jax_case` lays it out. The policy case's weights go through
    `ActorCritic.from_flax`."""
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.utils.convert import carry_from_numpy

    surface, mode = CASES[name]
    stored = mref.load(PATH)
    carries0 = [{k: stored[f"{name}/in/{i}/{k}"] for k in mref.CARRY_FIELDS} for i in range(len(IDS))]
    out = {f"{name}/in/{i}/{k}": v for i, c in enumerate(carries0) for k, v in c.items()}
    carries = tuple(carry_from_numpy(c, device=device) for c in carries0)
    if surface == "random":
        build = mixed.build_packed_mixed_plain_rollout if plain else mixed.build_packed_mixed_rollout
        step = build(IDS, T, mode=mode, as_carry=True)
    else:
        models = [ActorCritic.from_flax(p, device=device) for p in params_list()]
        build = mixed.build_mixed_policy_eval_plain if plain else mixed.build_mixed_policy_eval
        step = build(IDS, models, T, mode=mode)
    for c, seed in enumerate(KEY_SEEDS):
        carries, metrics = step(key(seed, device=device), carries)
        out.update(call_arrays(f"{name}/call{c}", carries, metrics))
    return out


def member_ids() -> np.ndarray:
    """The `MixedEnv` case's member per lane: 2·B lanes, alternating."""
    return (np.arange(2 * B) % len(IDS)).astype(np.int32)


def doctor_mixed(states: dict) -> dict:
    """A state dictionary with each lane's step count drawn within T of its
    member's `max_steps` (LavaCrossingS9N1: 324, FourRooms: 100), so every
    lane truncates inside the rollout."""
    max_steps = np.array([324, 100], np.int64)[member_ids()]
    s = dict(states)
    s["step_count"] = (max_steps - np.random.default_rng(2).integers(1, T + 1, len(max_steps))).astype(np.int32)
    return s


def jax_mixed_env_case() -> dict:
    """The `mixed_env` case's arrays, from the JAX package's `MixedEnv`."""
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState
    from minigrid_tpu.parallel import mixed as jmixed

    menv = jmixed.MixedEnv.create(IDS)
    states, obs = jax.jit(menv.reset_batch)(jax.random.PRNGKey(MIXED_ENV_SEEDS[0]), jnp.asarray(member_ids()))
    fields = mref.STATE_FIELDS
    s = {k: np.asarray(getattr(states, k)) for k in fields}
    out = {f"{MIXED_ENV_CASE}/reset/{k}": v for k, v in s.items()}
    out[f"{MIXED_ENV_CASE}/reset/image"] = np.asarray(obs["image"])
    start = EnvState(**{k: jnp.asarray(v) for k, v in doctor_mixed(s).items()})
    final, metrics = jmixed.build_mixed_rollout(menv, T)(jax.random.PRNGKey(MIXED_ENV_SEEDS[1]), start)
    out.update({f"{MIXED_ENV_CASE}/final/{k}": np.asarray(getattr(final, k)) for k in fields})
    for k in ("episodes", "total_reward", "total_steps", "obs_checksum"):
        out[f"{MIXED_ENV_CASE}/metrics/{k}"] = np.asarray(getattr(metrics, k))
    return out


def case_arrays(name: str, path: Path = PATH) -> dict:
    """Case `name`'s arrays from the file."""
    return {k: v for k, v in mref.load(path).items() if k.startswith(name + "/")}


def main() -> int:
    arrays = {}
    for name in CASES:
        arrays.update(jax_case(name))
    arrays.update(jax_mixed_env_case())
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
